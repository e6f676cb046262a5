"""The port's λ-path (``repro_torch.core.path``) against the JAX package's
``solve_path`` on the same problem and the same draws, and the behaviour
the reference's tests hold (tests/test_path_and_serve.py:14-50, the cached
second sweep of test_batched_serve.py, the P clamp of test_health.py and
the registry runs of test_sharded_engines.py), at these small sizes.

Draws: the JAX path splits its key once per solver call (once per λ, or
once per chunk with a cache); each call's stream is rebuilt here from that
split — ``_sample`` for the scalar solver, ``batched_draw_blocks`` for the
block solvers — and handed to the port's path as ``draws``, in call
order.  F* comes from the reference's ``fista_solve``.

Tolerances: objectives rtol 1e-4, nnz exact, x rtol/atol 1e-4."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import objectives as jobj  # noqa: E402
from repro.core import shotgun as jshot  # noqa: E402
from repro.core.baselines.fista import fista_solve  # noqa: E402
from repro.core.batched import WarmStartCache as JCache  # noqa: E402
from repro.core.path import solve_path as jsolve_path  # noqa: E402
from repro.core.spec import SolverSpec as JSpec  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.kernels.batched import batched_draw_blocks  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import objectives as tobj  # noqa: E402
from repro_torch.core import path as tpath  # noqa: E402
from repro_torch.core import shotgun as tshot  # noqa: E402
from repro_torch.core.batched import WarmStartCache  # noqa: E402
from repro_torch.core.spec import SolverSpec  # noqa: E402

BLOCK = 128


def port_problem(jp):
    return convert.problem_from_numpy(
        np.asarray(jp.A), np.asarray(jp.y), float(jp.lam), jp.loss,
        scales=np.asarray(jp.scales), device="cpu")


def path_draws(key, calls, rounds, make):
    """Each solver call's draws, in call order: the JAX path splits
    ``key, sub = split(key)`` before every call and hands it ``sub``."""
    out = []
    for _ in range(calls):
        key, sub = jax.random.split(key)
        out.append(make(sub, rounds))
    return out


def scalar(P, d):
    def make(k, rounds):
        keys = jax.random.split(k, rounds)
        return np.asarray(jax.vmap(lambda kk: jshot._sample(kk, d, P,
                                                            True))(keys))
    return make


def blocks(K, d):
    def make(k, rounds):
        keys = jax.random.split(k, rounds)[None]
        return np.asarray(batched_draw_blocks(keys, K, -(-d // BLOCK)))[0]
    return make


@pytest.fixture(scope="module")
def lasso():
    A, y, _ = jsyn.sparco(seed=0, n=128, d=96)
    jp = jobj.make_problem(A, y, lam=0.3)
    return jp, port_problem(jp)


def test_lambda_sequence_monotone():
    lams = tpath.lambda_sequence(10.0, 0.5, 6)
    assert len(lams) == 6
    assert lams[0] <= 10.0 and abs(lams[-1] - 0.5) < 1e-9
    assert all(lams[i] > lams[i + 1] for i in range(len(lams) - 1))
    np.testing.assert_array_equal(lams, np.geomspace(9.5, 0.5, 6))
    assert tpath.lambda_sequence(1.0, 2.0).tolist() == [2.0]
    assert [tpath._largest_divisor_leq(n, 8) for n in (64, 12, 7, 1)] == \
        [8, 6, 7, 1]


def _assert_path_close(t, j):
    np.testing.assert_allclose(t.objectives, j.objectives, rtol=1e-4)
    np.testing.assert_array_equal(t.nnz, j.nnz)
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(t.lambdas, j.lambdas, rtol=1e-6)


def test_path_matches_jax(lasso):
    jp, tp = lasso
    key = jax.random.PRNGKey(0)
    kw = dict(lam_target=0.3, num_lambdas=5, validate_p=False)
    j = jsolve_path(jp, key, spec=JSpec(P=8, rounds=60), **kw)
    t = tpath.solve_path(tp, spec=SolverSpec(P=8, rounds=60),
                         draws=path_draws(key, 5, 60, scalar(8, jp.d)), **kw)
    _assert_path_close(t, j)
    assert t.rounds is None


def test_cached_path_matches_jax(lasso):
    """The cache branch: per-chunk draws, early stops at the same chunk,
    a second sweep starting from exact hits."""
    jp, tp = lasso
    kw = dict(lam_target=0.3, num_lambdas=4, validate_p=False, tol=1e-3,
              problem_id="p")
    jc, tc = JCache(), WarmStartCache()
    for seed in (0, 1):
        key = jax.random.PRNGKey(seed)
        j = jsolve_path(jp, key, spec=JSpec(P=8, rounds=48), cache=jc, **kw)
        t = tpath.solve_path(tp, spec=SolverSpec(P=8, rounds=48), cache=tc,
                             draws=path_draws(key, 24, 8, scalar(8, jp.d)),
                             **kw)
        _assert_path_close(t, j)
        np.testing.assert_array_equal(t.rounds, j.rounds)
    assert tc.stats.hits_exact == jc.stats.hits_exact == 4


def test_block_path_matches_jax():
    A, y, _ = jsyn.sparco(seed=0, n=256, d=384)
    jp = jobj.make_problem(A, y, lam=2.0)
    tp = port_problem(jp)
    key = jax.random.PRNGKey(2)
    kw = dict(lam_target=2.0, num_lambdas=3, validate_p=False)
    j = jsolve_path(jp, key, spec=JSpec(P=BLOCK, rounds=8), solver="block",
                    interpret=True, **kw)
    t = tpath.solve_path(tp, spec=SolverSpec(P=BLOCK, rounds=8),
                         solver="block",
                         draws=path_draws(key, 3, 8, blocks(1, jp.d)), **kw)
    _assert_path_close(t, j)


def test_block_fused_path_follows_its_two_kernel_path():
    """The fused adapter (K = ceil(P/128), R = largest divisor of the
    rounds <= 8) gives the two-kernel path's trajectory on the same
    draws."""
    A, y, _ = jsyn.sparco(seed=0, n=256, d=384)
    tp = port_problem(jobj.make_problem(A, y, lam=2.0))
    draws = [np.random.default_rng(s).integers(0, 3, (12, 2)) for s in
             range(3)]
    kw = dict(lam_target=2.0, num_lambdas=3, validate_p=False,
              spec=SolverSpec(P=2 * BLOCK, rounds=12))
    two = tpath.solve_path(tp, solver="block", draws=draws, **kw)
    fused = tpath.solve_path(tp, solver="block_fused", draws=draws, **kw)
    np.testing.assert_allclose(fused.objectives, two.objectives, rtol=1e-5)
    np.testing.assert_allclose(fused.x.numpy(), two.x.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_pathwise_matches_direct_solve(lasso):
    jp, tp = lasso
    path = tpath.solve_path(tp, torch.Generator().manual_seed(0),
                            lam_target=0.3, num_lambdas=8,
                            spec=SolverSpec(P=8, rounds=200))
    fstar = float(fista_solve(jp, 5000).objective[-1])
    assert path.objectives[-1] <= fstar * 1.005 + 1e-3
    assert path.nnz[-1] >= path.nnz[0]


def test_warm_start_saves_iterations():
    A, y, _ = jsyn.sparco(seed=1, n=128, d=96)
    jp = jobj.make_problem(A, y, lam=0.2)
    tp = port_problem(jp)
    fstar = float(fista_solve(jp, 6000).objective[-1])
    spec = SolverSpec(P=8, rounds=200)
    cold = tshot.shotgun_solve(tp, torch.Generator().manual_seed(0),
                               spec=spec)
    t_cold = int(tshot.rounds_to_tolerance(cold.trace.objective, fstar))
    warm0 = tshot.shotgun_solve(tp._replace(lam=torch.tensor(0.4)),
                                torch.Generator().manual_seed(1),
                                spec=SolverSpec(P=8, rounds=150))
    warm = tshot.shotgun_solve(tp, torch.Generator().manual_seed(2),
                               spec=spec, x0=warm0.x)
    t_warm = int(tshot.rounds_to_tolerance(warm.trace.objective, fstar))
    assert t_warm < t_cold


def test_cached_second_sweep_takes_fewer_rounds():
    """The second sweep over the same λ grid hits the cache at every point
    and converges in strictly fewer rounds, and lands no higher."""
    A, y, _ = jsyn.sparco(seed=0, n=256, d=512)
    tp = port_problem(jobj.make_problem(A, y, lam=2.0))
    cache = WarmStartCache()
    kw = dict(lam_target=2.0, spec=SolverSpec(P=BLOCK, rounds=64),
              num_lambdas=4, solver="block_fused", validate_p=False,
              cache=cache, problem_id="p0")
    r1 = tpath.solve_path(tp, torch.Generator().manual_seed(0), **kw)
    r2 = tpath.solve_path(tp, torch.Generator().manual_seed(1), **kw)
    assert int(r2.rounds.sum()) < int(r1.rounds.sum())
    assert np.all(r2.objectives <= r1.objectives * (1 + 1e-5))
    assert cache.stats.hits_exact == 4


def test_cached_path_checks_convergence_once_a_launch(monkeypatch):
    """With ``rounds_per_launch`` a cached path runs each λ in chunks of one
    launch: every solver call takes that many rounds in one launch, a λ's
    rounds are a multiple of it, and a length that does not divide the
    budget is refused."""
    A, y, _ = jsyn.sparco(seed=0, n=256, d=512)
    tp = port_problem(jobj.make_problem(A, y, lam=2.0))
    real, seen = tshot.get_solver, []

    def spy(name):
        solve = real(name)

        def run(*args, spec, rounds_per_launch, **kw):
            seen.append((spec.rounds, rounds_per_launch))
            return solve(*args, spec=spec,
                         rounds_per_launch=rounds_per_launch, **kw)
        return run
    monkeypatch.setattr(tpath.shotgun, "get_solver", spy)
    kw = dict(lam_target=2.0, spec=SolverSpec(P=BLOCK, rounds=64),
              num_lambdas=3, solver="block_fused", validate_p=False,
              cache=WarmStartCache())
    res = tpath.solve_path(tp, torch.Generator().manual_seed(0),
                           rounds_per_launch=32, **kw)
    assert set(seen) == {(32, 32)}
    assert len(seen) * 32 == int(res.rounds.sum())
    assert np.all(res.rounds % 32 == 0) and np.all(res.rounds <= 64)
    with pytest.raises(ValueError, match="must divide"):
        tpath.solve_path(tp, torch.Generator(), rounds_per_launch=24, **kw)


@pytest.mark.parametrize("name", ["shotgun", "shooting", "shotgun_dup",
                                  "shotgun_cdn", "block", "block_fused",
                                  ("block_fused", "lasso")])
def test_solve_path_runs_on_registry_solvers(name):
    A, y, _ = jsyn.sparco(seed=0, n=256, d=256)
    tp = port_problem(jobj.make_problem(A, y, lam=0.5))
    # one 128-block for the kernel solvers, beyond this design's P* = 67
    # but inside its divergence margin over 16 rounds
    P = BLOCK if name in ("block", "block_fused", ("block_fused",
                                                    "lasso")) else 8
    solver = tpath._solver_by_name(name) if isinstance(name, tuple) else name
    res = tpath.solve_path(tp, torch.Generator().manual_seed(0),
                           lam_target=0.5, spec=SolverSpec(P=P, rounds=16),
                           num_lambdas=3, solver=solver, validate_p=False)
    assert res.x.shape == (tp.d,)
    assert res.lambdas.shape == (3,)
    assert np.all(np.isfinite(res.objectives))
    direct = float(tobj.objective(torch.zeros(tp.d), tp))
    assert res.objectives[-1] < direct


def test_solve_path_clamps_unsafe_p():
    A, y, _ = jsyn.sparco(seed=4, n=128, d=256, corr=0.95)
    tp = port_problem(jobj.make_problem(A, y, lam=0.1))
    with pytest.warns(UserWarning, match="exceeds the Thm 3.2"):
        res = tpath.solve_path(tp, torch.Generator().manual_seed(0),
                               lam_target=0.1, num_lambdas=3,
                               spec=SolverSpec(P=64, rounds=100))
    assert np.all(np.isfinite(res.objectives))


def test_solve_path_rejections(lasso):
    _, tp = lasso
    g = torch.Generator()
    with pytest.raises(ValueError, match="unknown solver"):
        tpath.solve_path(tp, g, lam_target=0.3, spec=SolverSpec(),
                         solver="nope")
    with pytest.raises(TypeError, match="spec="):
        tpath.solve_path(tp, g, lam_target=0.3)
    with pytest.raises(ValueError, match="only forwarded"):
        tpath.solve_path(tp, g, lam_target=0.3, spec=SolverSpec(),
                         solver=lambda *a: None, K=2)


def test_sharded_path_follows_the_scalar_path(lasso, tmp_path):
    """The sharded adapter on a one-rank gloo group (scalar engine, a merge
    every round, P_local = P) gives the scalar path's trajectory on the
    same coordinate draws; a generator names the driver's streams."""
    import torch.distributed as dist
    _, tp = lasso
    draws = [np.random.default_rng(s).integers(0, tp.d, (24, 8))
             for s in range(3)]
    kw = dict(lam_target=0.3, num_lambdas=3, validate_p=False,
              spec=SolverSpec(P=8, rounds=24))
    scalar_path = tpath.solve_path(tp, draws=draws, **kw)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        sharded = tpath.solve_path(tp, solver="sharded",
                                   draws=[d[None] for d in draws], **kw)
        seeded = tpath.solve_path(tp, torch.Generator().manual_seed(0),
                                  solver="sharded", **kw)
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(sharded.objectives, scalar_path.objectives,
                               rtol=1e-5)
    np.testing.assert_array_equal(sharded.nnz, scalar_path.nnz)
    np.testing.assert_allclose(sharded.x.numpy(), scalar_path.x.numpy(),
                               rtol=1e-5, atol=1e-5)
    assert np.all(np.isfinite(seeded.objectives))
