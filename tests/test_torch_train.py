"""The port's trainer (``repro_torch.launch.train``), its loader
(``data/loader.py``) and ``TrainState`` checkpoints against the JAX
package's on the CPU: the loader's batches bit for bit, a checkpoint round
trip of both optimizers' states, the kill-and-resume of
tests/test_ckpt_and_fault_tolerance.py:70 bit for bit, and ``train``'s
losses against the reference ``train()``'s from the reference's own init
(carried across by ``convert.train_state_from_numpy`` and saved as the
port's step-0 checkpoint, from which the port's ``train`` resumes).

``train``'s losses are held to rel 1e-5 (measured: ≤ 9.5e-7), although
the reference's jitted step clips by a float32 grad norm up to 5.1e-4 off
(tests/test_torch_train_step.py): the losses move far less than the
clip scale."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.data import loader as jloader  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import steps as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.data import loader as tloader  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import steps as TS  # noqa: E402
from repro_torch.optim.adafactor import AdafactorState  # noqa: E402
from repro_torch.optim.adamw import AdamWState  # noqa: E402
from test_torch_train_step import ref_flat  # noqa: E402


@pytest.fixture(autouse=True)
def _few_threads():
    """Tiny ops: more threads than cores only thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_loader_is_bit_identical_to_the_references(hosts):
    cfg = dict(vocab_size=300, global_batch=8, seq_len=24, seed=5)
    for host in range(hosts):
        ref = jloader.TokenLoader(jloader.LoaderConfig(**cfg), host_id=host,
                                  num_hosts=hosts)
        mine = tloader.TokenLoader(tloader.LoaderConfig(**cfg), host_id=host,
                                   num_hosts=hosts, device="cpu")
        for step in (0, 1, 7, 1000):
            want, got = ref.batch_at(step), mine.batch_at(step)
            for k in ("tokens", "labels"):
                assert got[k].dtype == torch.int64
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))
        assert mine.local_batch == 8 // hosts


def test_loader_refuses_an_indivisible_batch_and_defaults_to_the_card(
        monkeypatch):
    cfg = tloader.LoaderConfig(vocab_size=10, global_batch=6, seq_len=4)
    with pytest.raises(ValueError, match="divisible"):
        tloader.TokenLoader(cfg, num_hosts=4, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tloader.TokenLoader(cfg)


# ---------------------------------------------------------------------------
# TrainState checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen1.5-110b"])
def test_train_state_checkpoint_round_trip(arch, tmp_path):
    """A stepped state (a ``blocks`` list, NamedTuples, AdamW moments or
    Adafactor's stacked statistics) comes back bit for bit into the meta
    template, as lists and NamedTuples."""
    cfg = ARCHS[arch].smoke_config()
    state = TS.init_train_state(cfg, torch.Generator().manual_seed(1))
    toks = torch.randint(0, cfg.vocab_size, (2, 9),
                         generator=torch.Generator().manual_seed(2))
    state, _ = TS.make_train_step(cfg, lr=1e-3)(
        state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    ckpt.save(tmp_path, 1, state)
    template = TS.init_train_state(cfg, device="meta")
    assert all(t.is_meta for t in T.leaves(template))
    step, out = ckpt.restore(tmp_path, template, device="cpu")
    assert step == 1 and isinstance(out, TS.TrainState)
    assert isinstance(out.opt, AdafactorState if cfg.optimizer == "adafactor"
                      else AdamWState)
    assert isinstance(out.params["blocks"], list)
    assert [p for p, _ in T.items(out)] == [p for p, _ in T.items(state)]
    for a, b in zip(T.leaves(state), T.leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(out.step) == 1
    bad = template._replace(step=torch.zeros(2, dtype=torch.int32,
                                             device="meta"))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(tmp_path, bad, device="cpu")
    other = TS.init_train_state(ARCHS["granite-moe-1b-a400m"].smoke_config(),
                                device="meta")
    with pytest.raises(KeyError):
        ckpt.restore(tmp_path, other, device="cpu")


def test_train_state_converter_round_trip():
    for arch in ("qwen3-4b", "jamba-1.5-large-398b"):
        jc = JARCHS[arch].smoke_config()
        flat = ref_flat(JS.init_train_state(jc, jax.random.PRNGKey(3)))
        tc = ARCHS[arch].smoke_config()
        back = convert.train_state_to_numpy(
            tc, convert.train_state_from_numpy(tc, flat, device="cpu"))
        assert sorted(back) == sorted(flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(back[k], v)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

ARGS = dict(smoke=True, steps=9, batch=2, seq=16, lr=1e-3, save_every=3,
            log_every=100, device="cpu")


def test_failure_resume_bitwise_identical(tmp_path):
    """Mirror of tests/test_ckpt_and_fault_tolerance.py:70."""
    arch = "granite-moe-1b-a400m"
    _, losses_ref = ttrain.train(arch, ckpt_dir=tmp_path / "whole", **ARGS)
    d2 = tmp_path / "interrupted"
    with pytest.raises(ttrain.SimulatedFailure):
        ttrain.train(arch, ckpt_dir=d2, simulate_failure_at=5, **ARGS)
    assert ckpt.latest_step(d2) == 3
    _, losses_resumed = ttrain.train(arch, ckpt_dir=d2, **ARGS)
    np.testing.assert_array_equal(np.asarray(losses_ref[3:], np.float32),
                                  np.asarray(losses_resumed, np.float32))
    assert ckpt.all_steps(d2) == [3, 6, 9]


def _ref_frames(cfg):
    """The reference ``train()``'s encoder frames of each step (its
    ``jax.random`` draws), as the port's ``enc_frames``."""
    def frames(_, b, s, step, device):
        x = jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(s), step),
                              (b, cfg.encoder_seq, cfg.d_model),
                              cfg.compute_dtype)
        return torch.from_numpy(np.array(x, np.float32)).to(device)
    return frames


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-1b-a400m",
                                  "whisper-large-v3"])
def test_train_losses_match_the_references(arch, tmp_path, monkeypatch):
    kw = dict(smoke=True, steps=5, batch=2, seq=16, lr=1e-3, seed=0,
              log_every=100)
    _, want = jtrain.train(arch, **kw)
    jc = JARCHS[arch].smoke_config()
    flat = ref_flat(JS.init_train_state(jc, jax.random.PRNGKey(0)))
    tc = ARCHS[arch].smoke_config()
    ckpt.save(tmp_path, 0, convert.train_state_from_numpy(tc, flat,
                                                          device="cpu"))
    if tc.is_encdec:
        monkeypatch.setattr(ttrain, "enc_frames", _ref_frames(jc))
    _, got = ttrain.train(arch, ckpt_dir=tmp_path, device="cpu", **kw)
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_enc_frames_are_pure_in_seed_and_step():
    cfg = dataclasses.replace(ARCHS["whisper-large-v3"].smoke_config(),
                              compute_dtype=torch.bfloat16)
    a = ttrain.enc_frames(cfg, 2, 0, 3, "cpu")
    assert a.shape == (2, cfg.encoder_seq, cfg.d_model)
    assert a.dtype == torch.bfloat16
    assert torch.equal(a, ttrain.enc_frames(cfg, 2, 0, 3, "cpu"))
    assert not torch.equal(a, ttrain.enc_frames(cfg, 2, 0, 4, "cpu"))
    assert not torch.equal(a, ttrain.enc_frames(cfg, 2, 1, 3, "cpu"))


def test_train_defaults_to_the_card(monkeypatch):
    """No fallback hides the device: without a card and without
    ``device="cpu"`` ``train`` raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.train("qwen3-4b", steps=1, batch=2, seq=8)


def test_cli_runs_on_the_cpu(capsys):
    ttrain.main(["--arch", "qwen3-4b", "--steps", "3", "--batch", "2",
                 "--seq", "16", "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("[train] qwen3-4b step") == 3
