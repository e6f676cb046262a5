"""The port's example programs (``repro_torch.examples``) against the JAX
functions the reference's examples call, on the same inputs made from the
same seeds, at cut sizes (the scripts under ``examples/`` are not
imported).

- quickstart: ρ and P* against ``repro.core.spectral`` (the reference's
  start vector passed as ``v0``), FISTA's F after 6000 iterations against
  JAX's (rtol 1e-5), and the example's ``main`` at cut rounds: Shotgun
  reaches 0.5% of F* in fewer rounds than Shooting.
- lasso_paths: the λ sequence and the per-λ F of the example's path
  against JAX's ``solve_path`` on the reference's draws (rtol 1e-4).
- distributed_shotgun: on one gloo rank at cut rounds, the block solve
  against the fused one (rtol 1e-5) and the sharded solve against the
  single-device scalar solve on rank 0's draws (rtol 1e-5); P* against
  JAX's.  The JAX sharded solver cannot serve as a reference: it raises
  on this JAX.  ``main`` at ``--ranks 2`` (two spawned gloo ranks): P*,
  block against fused, and the sharded solve against the scalar solve on
  both ranks' draws (rtol 1e-5).
- train_lm: a few steps at batch 2, seq 32; the loss falls, a second call
  resumes from the first's checkpoint and follows the uninterrupted run's
  losses (rtol 1e-6); a call after the last step was saved trains nothing
  (in the default ``--ckpt-dir``, under the temporary directory); the
  parameter count is the reference config's.
- lm_probe at the smoke config, 2 warm-up steps and 4 feature batches:
  the reference's init carried across and warmed up by the port, the
  features of those weights against the reference's forward on them
  (rtol 1e-5, f32), the labels, the standardized design (population std,
  rtol 1e-5), P* (the reference's start vector) and the example's own P*
  (its CPU start vector), and a CDN trace that is finite and falls (a
  round that refuses its step reports its recomputed F, which may sit an
  ulp above the last one).
- P* with the reference's start vector equals JAX's; the examples draw
  their own start vector on the CPU (100 power iterations leave ρ 1%
  short of converged on the Sparco design, so the two starts may give
  P* one apart).
- ``data.synthetic.lm_token_batches`` bit-identical to the reference's.
- Shotgun-CDN's explicit uniforms stream replays its generator's draws."""
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.core import objectives as jobj  # noqa: E402
from repro.core import shotgun as jshot  # noqa: E402
from repro.core import spectral as jspec  # noqa: E402
from repro.core.baselines.fista import fista_solve as jfista  # noqa: E402
from repro.core.path import solve_path as jsolve_path  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.data.loader import LoaderConfig as JLoaderConfig  # noqa: E402
from repro.data.loader import TokenLoader as JTokenLoader  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import objectives as tobj  # noqa: E402
from repro_torch.core import path as tpath  # noqa: E402
from repro_torch.core.baselines.fista import fista_solve  # noqa: E402
from repro_torch.core.shotgun import shotgun_solve  # noqa: E402
from repro_torch.core.spec import SolverSpec  # noqa: E402
from repro_torch.core.spectral import p_star, spectral_radius  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.data.loader import LoaderConfig, TokenLoader  # noqa: E402
from repro_torch.dist import ranks  # noqa: E402
from repro_torch.examples import start_vector  # noqa: E402
from repro_torch.examples import distributed_shotgun as ex_dist  # noqa: E402
from repro_torch.examples import lm_probe as ex_probe  # noqa: E402
from repro_torch.examples import quickstart as ex_quick  # noqa: E402
from repro_torch.examples import train_lm as ex_train  # noqa: E402
from repro_torch.launch.train import SimulatedFailure  # noqa: E402
from repro_torch.models import steps as TS  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the examples' rounds are thousands of small
    operations, which other threads only slow down — and, beside the
    other test workers on a shared machine, slow down by tens of times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def v0_of(d):
    """The start vector of the reference's ``spectral_radius``."""
    return torch.tensor(np.asarray(
        jax.random.normal(jax.random.PRNGKey(0), (d,), jnp.float32)))


def flat(tree):
    """The reference tree as {``/``-joined path: numpy array} (NamedTuple
    fields by name)."""
    def key(k):
        for a in ("key", "name", "idx"):
            if hasattr(k, a):
                return str(getattr(k, a))
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(key(k) for k in p): np.asarray(v) for p, v in leaves}


def test_quickstart_spectral_and_fista_match_reference():
    A, y, _ = jsyn.singlepixcam(seed=0, n=410, d=1024, nnz_frac=0.05)
    jp = jobj.make_problem(A, y, lam=0.5)
    tA, ty, _ = tsyn.singlepixcam(seed=0, n=410, d=1024, nnz_frac=0.05)
    tp = tobj.make_problem(tA, ty, lam=0.5, device="cpu")
    v0 = v0_of(tp.d)
    np.testing.assert_allclose(float(spectral_radius(tp.A, v0=v0)),
                               float(jspec.spectral_radius(jp.A)), rtol=1e-5)
    assert p_star(tp.A, v0=v0) == jspec.p_star(jp.A)
    want = float(jfista(jp, 6000).objective[-1])
    got = float(fista_solve(tp, 6000, v0=v0).objective[-1])
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_quickstart_main_shotgun_beats_shooting(monkeypatch, capsys):
    monkeypatch.setattr(ex_quick, "SHOOTING_ROUNDS", 8000)
    monkeypatch.setattr(ex_quick, "SHOTGUN_ROUNDS", 200)
    monkeypatch.setattr(ex_quick, "FISTA_ITERS", 2000)
    out = ex_quick.main(["--device", "cpu"])
    assert out["P"] == min(out["p_star"], 64) > 1
    assert out["shotgun_rounds_to_tol"] < out["shooting_rounds_to_tol"] \
        < 8000
    assert out["shooting_F"].shape == (8000,)
    assert "rounds to 0.5% of F*" in capsys.readouterr().out


def test_lasso_paths_match_reference_solve_path():
    rounds, lams, P = 40, 10, 16
    A, y, _ = jsyn.large_sparse(seed=0, n=1024, d=4096, layout="bcsc")
    jp = jobj.make_problem(A, y, lam=0.5)
    tA, ty, _ = tsyn.large_sparse(seed=0, n=1024, d=4096, layout="bcsc")
    tp = tobj.make_problem(tA, ty, lam=0.5, device="cpu")
    assert p_star(tp.A, v0=v0_of(tp.d)) >= P     # no clamp on either side
    key = jax.random.PRNGKey(0)
    j = jsolve_path(jp, key, lam_target=0.5, P=P, rounds_per_lambda=rounds,
                    num_lambdas=lams)
    draws, k = [], key
    for _ in range(lams):            # one split a solver call, as the path
        k, sub = jax.random.split(k)
        keys = jax.random.split(sub, rounds)
        draws.append(np.asarray(jax.vmap(
            lambda kk: jshot._sample(kk, jp.d, P, True))(keys)))
    t = tpath.solve_path(tp, lam_target=0.5,
                         spec=SolverSpec(P=P, rounds=rounds),
                         num_lambdas=lams, draws=draws)
    np.testing.assert_allclose(t.lambdas, j.lambdas, rtol=1e-6)
    np.testing.assert_allclose(t.objectives, j.objectives, rtol=1e-4)
    assert t.objectives[-1] < t.objectives[0]


def test_distributed_shotgun_on_one_gloo_rank(monkeypatch, capsys):
    monkeypatch.setattr(ex_dist, "SHARDED_ROUNDS", 100)
    monkeypatch.setattr(ex_dist, "BLOCK_ROUNDS", 60)
    with ranks.one_rank("gloo"):
        out = ex_dist.solve("cpu")
    A, y, _ = jsyn.sparco(seed=0, n=1024, d=4096)
    tA, ty, _ = tsyn.sparco(seed=0, n=1024, d=4096)
    tp = tobj.make_problem(tA, ty, lam=0.5, device="cpu")
    assert p_star(tp.A, v0=v0_of(tp.d)) == jspec.p_star(
        jobj.make_problem(A, y, 0.5).A)
    assert out["p_star"] == p_star(tp.A, v0=start_vector(tp.d))
    assert out["ranks"] == 1 and out["K"] == max(1, min(out["p_star"] // 128,
                                                       4))
    np.testing.assert_allclose(out["block_F"], out["fused_F"], rtol=1e-5)
    assert out["block_fused_gap"] <= 1e-5
    # one rank: the sharded solve is the scalar solve on rank 0's draws
    draws = torch.randint(0, tp.d, (1, 100, out["P_local"]),
                          generator=torch.Generator().manual_seed(0),
                          dtype=torch.int32)
    single = shotgun_solve(tp, spec=SolverSpec(P=out["P_local"], rounds=100),
                           idx=draws[0])
    np.testing.assert_allclose(out["sharded_F"],
                               single.trace.objective.numpy(), rtol=1e-5)
    assert out["sharded_F"][-1] < out["sharded_F"][0]
    assert "fused Block-Shotgun" in capsys.readouterr().out


def test_distributed_shotgun_main_on_two_gloo_ranks(monkeypatch, capsys):
    """``--ranks 2``: the spawned ranks run the parent's round counts; the
    two ranks' sharded solve is the scalar solve that updates both ranks'
    draws each round (rank r's columns start at r·d/2)."""
    monkeypatch.setattr(ex_dist, "SHARDED_ROUNDS", 60)
    monkeypatch.setattr(ex_dist, "BLOCK_ROUNDS", 30)
    out = ex_dist.main(["--device", "cpu", "--ranks", "2"])
    assert "ranks: 2 (gloo, cpu)" in capsys.readouterr().out
    tA, ty, _ = tsyn.sparco(seed=0, n=1024, d=4096)
    tp = tobj.make_problem(tA, ty, lam=0.5, device="cpu")
    assert out["ranks"] == 2
    assert out["p_star"] == p_star(tp.A, v0=start_vector(tp.d))
    assert out["P_local"] == max(1, min(out["p_star"] // 2, 16))
    assert len(out["sharded_F"]) == 60 and len(out["block_F"]) == 30
    assert out["sharded_F"][-1] < out["sharded_F"][0]
    assert out["block_fused_gap"] <= 1e-5
    np.testing.assert_allclose(out["block_F"], out["fused_F"], rtol=1e-5)
    draws = torch.randint(0, tp.d // 2, (2, 60, out["P_local"]),
                          generator=torch.Generator().manual_seed(0),
                          dtype=torch.int32)
    idx = torch.cat([draws[0], draws[1] + tp.d // 2], dim=1)
    single = shotgun_solve(tp, spec=SolverSpec(P=idx.shape[1], rounds=60),
                           idx=idx)
    np.testing.assert_allclose(out["sharded_F"],
                               single.trace.objective.numpy(), rtol=1e-5)


def test_train_lm_resumes_and_counts_the_reference_params(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    base = ["--device", "cpu", "--steps", "8", "--batch", "2", "--seq", "32",
            "--save-every", "4"]
    # the default --ckpt-dir lies in the temporary directory; a second run
    # finds step 8 saved and trains nothing
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    whole = ex_train.main(base)
    assert (tmp_path / "repro_torch_train_lm").is_dir()
    assert whole["losses"][-1] < whole["losses"][0]
    assert isinstance(whole["params"], int)
    assert whole["params"] == JARCHS["qwen3-4b"].smoke_config().param_count()
    again = ex_train.main(base)
    assert again["losses"] == [] and again["params"] == whole["params"]
    assert "already trained to step 8" in capsys.readouterr().out
    cut = base + ["--ckpt-dir", str(tmp_path / "b")]
    with pytest.raises(SimulatedFailure):
        ex_train.main(cut + ["--simulate-failure-at", "4"])
    resumed = ex_train.main(cut)
    assert len(resumed["losses"]) == 4          # from the step-4 checkpoint
    # the CPU's reductions round by the alignment of their operands, so a
    # restored state may move a loss by an ulp (the card's deterministic
    # run is held bit for bit by chip_smoke.py)
    np.testing.assert_allclose(resumed["losses"], whole["losses"][4:],
                               rtol=1e-6)


def test_lm_probe_matches_reference_features():
    jc = JARCHS["qwen3-4b"].smoke_config()
    tc = ARCHS["qwen3-4b"].smoke_config()
    jl = JTokenLoader(JLoaderConfig(vocab_size=jc.vocab_size,
                                    global_batch=ex_probe.ROWS,
                                    seq_len=ex_probe.SEQ))
    tl = TokenLoader(LoaderConfig(vocab_size=tc.vocab_size,
                                  global_batch=ex_probe.ROWS,
                                  seq_len=ex_probe.SEQ), device="cpu")
    # the reference's init carried across, warmed up 2 steps by the port,
    # and the warmed weights carried back for the reference's featurizer
    jinit = jax.jit(JM.init, static_argnums=0)(jc, jax.random.PRNGKey(0))
    params = convert.lm_params_from_numpy(tc, flat(jinit), device="cpu")
    state = TS.TrainState(params, adamw.init(params),
                          torch.zeros((), dtype=torch.int32))
    state, loss = ex_probe.warm_up(tc, state, tl, 2)
    assert int(state.step) == 2 and np.isfinite(float(loss))
    back = convert.lm_params_to_numpy(tc, state.params)
    jparams = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(back["/".join(str(k.key) for k in p)],
                                 x.dtype), jinit)
    A, y = ex_probe.featurize(tc, state.params, tl, 4)
    jfeat = jax.jit(lambda p, tok: JM.forward(
        jc, p, {"tokens": tok}, return_hidden=True)[1].astype(
            jnp.float32).mean(axis=1))
    feats, labels = [], []
    for i in range(4):
        b = jl.batch_at(ex_probe.FEATURE_STEP0 + i)
        feats.append(np.asarray(jfeat(jparams, b["tokens"])))
        labels.append(np.where(np.any(np.asarray(b["tokens"]) == 7, axis=1),
                               1.0, -1.0))
    jA, jy = np.concatenate(feats), np.concatenate(labels)
    np.testing.assert_allclose(A.numpy(), jA, rtol=1e-5,
                               atol=1e-5 * np.abs(jA).max())
    np.testing.assert_array_equal(y.numpy(), jy)
    jA = (jA - jA.mean(0)) / (jA.std(0) + 1e-6)
    A = ex_probe.standardize(A)
    np.testing.assert_allclose(A.numpy(), jA, rtol=1e-5, atol=1e-5)

    prob, ps, P, u = ex_probe.probe_problem(A, y, 40)
    jprob = jobj.make_problem(jA, jy, lam=ex_probe.LAM, loss=jobj.LOGISTIC)
    assert p_star(prob.A, v0=v0_of(prob.d)) == jspec.p_star(jprob.A)
    assert ps == p_star(prob.A, v0=start_vector(prob.d))
    assert P == max(1, min(ps, ex_probe.P_CAP)) and u.shape == (40, P, 128)
    F = ex_probe.probe(prob, P, u).trace.objective.numpy()
    assert np.all(np.isfinite(F)) and F[-1] < F[0]
    assert np.all(np.diff(F) <= 1e-6 * np.abs(F[1:]))   # rounding only


def test_cdn_uniforms_stream_replays_the_generator():
    """``shotgun_cdn_solve(uniforms=)``, the stream lm_probe draws on the
    CPU: each round's (P, d) slice stands for that round's generator draw,
    so the generator's own draws, stacked, replay its solve bit for bit;
    a stream of the wrong shape, or one given without the active set, is
    refused."""
    from repro_torch.core.cdn import shotgun_cdn_solve
    A, y, _ = tsyn.logistic_data(seed=0, n=64, d=32)
    prob = tobj.make_problem(A, y, 0.1, loss=tobj.LOGISTIC, device="cpu")
    g = torch.Generator().manual_seed(2)
    u = torch.stack([torch.rand((4, 32), generator=g) for _ in range(12)])
    a = shotgun_cdn_solve(prob, torch.Generator().manual_seed(2), P=4,
                          rounds=12)
    b = shotgun_cdn_solve(prob, P=4, rounds=12, uniforms=u)
    assert torch.equal(a.x, b.x)
    assert torch.equal(a.trace.objective, b.trace.objective)
    with pytest.raises(ValueError, match="uniforms shape"):
        shotgun_cdn_solve(prob, P=4, rounds=11, uniforms=u)
    with pytest.raises(ValueError, match="active_set=False"):
        shotgun_cdn_solve(prob, P=4, rounds=12, uniforms=u,
                          active_set=False)


@pytest.mark.parametrize("seed", [0, 3])
def test_lm_token_batches_bit_identical(seed):
    args = (seed, 300, 3, 20, 3)
    for (ti, tt), (ji, jt) in zip(tsyn.lm_token_batches(*args),
                                  jsyn.lm_token_batches(*args)):
        assert ti.dtype == ji.dtype == np.int32
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tt, jt)
    assert len(list(tsyn.lm_token_batches(*args))) == 3


def test_lm_probe_main_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(ex_probe, "WARMUP_STEPS", 2)
    monkeypatch.setattr(ex_probe, "BATCHES", 4)
    monkeypatch.setattr(ex_probe, "ROUNDS", 40)
    out = ex_probe.main(["--device", "cpu"])
    assert (out["n"], out["d"], out["layers"]) == (4 * ex_probe.ROWS, 128, 2)
    F = out["F"]
    assert F.shape == (40,) and np.all(np.isfinite(F)) and F[-1] < F[0]
    assert np.all(np.diff(F) <= 1e-6 * np.abs(F[1:]))   # rounding only
    assert 0 <= out["nnz"] <= 128 and 0.0 <= out["accuracy"] <= 1.0
    assert out["P"] == max(1, min(out["p_star"], ex_probe.P_CAP))
    assert "Shotgun-CDN (P=" in capsys.readouterr().out
