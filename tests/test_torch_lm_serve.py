"""The port's LM server (``repro_torch.launch.serve``) on the CPU: against
the JAX server on the same seed, with the reference's weights for that seed
carried across (``convert.lm_params_from_numpy``), the token stream of
every request must be equal, with and without round-deadline eviction;
then the port's mirrors of the JAX serve tests
(tests/test_path_and_serve.py), on the port's own weights."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.serve import Engine, Request, serve  # noqa: E402

CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _few_threads():
    """Tiny ops: more threads than cores only thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _carried_params(seed):
    jc = JARCHS["qwen3-4b"].smoke_config()
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        JM.init(jc, jax.random.PRNGKey(seed)))
    flat = {"/".join(str(k.key) for k in p): np.asarray(v) for p, v in leaves}
    return convert.lm_params_from_numpy(ARCHS["qwen3-4b"].smoke_config(),
                                        flat, device="cpu")


@pytest.mark.parametrize("deadline", [None, 3])
def test_serve_matches_reference_stream(deadline):
    """The same requests, prompts and weights: the same greedy tokens per
    rid, the same evictions."""
    kw = dict(requests=5, batch=2, max_new=8, prompt_len=5, max_len=48,
              quiet=True, seed=1, max_rounds=deadline, max_evictions=10)
    want = {r.rid: (r.out, r.evictions) for r in jserve.serve("qwen3-4b",
                                                              **kw)}
    got = {r.rid: (r.out, r.evictions)
           for r in serve("qwen3-4b", params=_carried_params(1), **CPU, **kw)}
    assert got == want
    if deadline:
        assert any(ev > 0 for _, ev in got.values())


def test_serve_continuous_batching_completes():
    reqs = serve("qwen3-4b", requests=5, batch=2, max_new=6, prompt_len=4,
                 max_len=32, quiet=True, **CPU)
    assert len(reqs) == 5
    assert all(1 <= len(r.out) <= 6 for r in reqs)
    assert sorted(r.rid for r in reqs) == list(range(5))


def test_serve_tokens_in_vocab():
    reqs = serve("qwen3-4b", requests=6, batch=2, max_new=4, prompt_len=6,
                 max_len=32, quiet=True, seed=3, **CPU)
    v = ARCHS["qwen3-4b"].smoke_config().padded_vocab
    assert sorted(r.rid for r in reqs) == list(range(6))
    for r in reqs:
        assert all(0 <= t < v for t in r.out)


def test_serve_eviction_requeue_preserves_output():
    """Evicted requests re-prefill their partial generation into the next
    free slot; greedy decode is deterministic, so the streams match a run
    with no deadline."""
    kw = dict(requests=4, batch=2, max_new=8, prompt_len=4, max_len=64,
              quiet=True, seed=1, **CPU)
    ref = {r.rid: r.out for r in serve("qwen3-4b", **kw)}
    evicted = serve("qwen3-4b", max_rounds=3, max_evictions=10, **kw)
    assert sorted(r.rid for r in evicted) == list(range(4))
    assert any(r.evictions > 0 for r in evicted)
    for r in evicted:
        assert r.out == ref[r.rid], (r.rid, r.evictions)


def test_serve_eviction_gives_up_after_max_evictions():
    reqs = serve("qwen3-4b", requests=3, batch=3, max_new=12, prompt_len=4,
                 max_len=64, quiet=True, seed=2, max_rounds=1,
                 max_evictions=1, **CPU)
    assert sorted(r.rid for r in reqs) == list(range(3))
    for r in reqs:
        assert r.done
        assert r.evictions <= 2
        if r.evictions == 2:
            assert 0 < len(r.out) < 12


def test_engine_age_tracking_and_admit_reset():
    cfg = ARCHS["qwen3-4b"].smoke_config()
    eng = Engine(cfg, batch=2, max_len=32, **CPU)
    rng = np.random.default_rng(0)
    r0 = Request(0, rng.integers(1, cfg.vocab_size, 4, dtype=np.int32), 16)
    eng.admit(r0, 0)
    assert eng.age[0] == 0
    for expect in (1, 2, 3):
        eng.step()
        assert eng.age[0] == expect
    assert eng.age[1] == 0
    r1 = Request(1, rng.integers(1, cfg.vocab_size, 4, dtype=np.int32), 16)
    eng.admit(r1, 0)
    assert eng.age[0] == 0


def run_fresh_and_warm(cfg, device, params=None):
    """Request B's tokens in a slot heavy with request A's state, and in a
    fresh engine (the no-warm-state-leak check, shared with the card
    test)."""
    rng = np.random.default_rng(4)
    prompt_a = rng.integers(1, cfg.vocab_size, 12, dtype=np.int32)
    prompt_b = rng.integers(1, cfg.vocab_size, 4, dtype=np.int32)

    def run_b(engine):
        rb = Request(9, prompt_b.copy(), 6)
        engine.admit(rb, 0)
        while not rb.done:
            engine.step()
        return rb.out

    kw = dict(batch=2, max_len=32, seed=0, params=params, device=device)
    warm = Engine(cfg, **kw)
    warm.admit(Request(0, prompt_a, 8), 0)
    for _ in range(4):
        warm.step()
    return run_b(warm), run_b(Engine(cfg, **kw))


def test_engine_refill_no_warm_state_leak():
    warm, fresh = run_fresh_and_warm(ARCHS["qwen3-4b"].smoke_config(), "cpu")
    assert warm == fresh


def test_engine_stats_and_serve_stats():
    st = {}
    reqs = serve("qwen3-4b", requests=3, batch=2, max_new=4, prompt_len=4,
                 max_len=32, quiet=True, stats=st, **CPU)
    assert st["prefills"] == 3 and st["tokens"] == sum(len(r.out)
                                                       for r in reqs)
    assert st["steps"] == st["decode_steps"] > 0
    assert st["prefill_tokens"] == 12 and st["step_s"] > 0


def test_unported_arch_raises():
    """The encoder-decoder config is refused, as the reference's ``serve``
    refuses it."""
    with pytest.raises(SystemExit):
        serve("whisper-large-v3", requests=1, quiet=True, **CPU)


def test_main_runs_on_the_cpu(capsys):
    tserve.main(["--device", "cpu", "--requests", "3", "--batch", "2",
                 "--max-new", "4", "--prompt-len", "4", "--max-len", "32"])
    out = capsys.readouterr().out
    assert "[serve] 3 requests" in out and "on cpu" in out


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card path is not "
                    "reachable here")
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(ARCHS["qwen3-4b"].smoke_config(), batch=1, max_len=8)
