"""The port's scalar Shotgun family (``repro_torch.core.shotgun``), the
objectives seam it reads A through and ``spectral.p_star_dup``, against the
JAX package on the same normalized problems and the same draws: the JAX
solvers' own threefry streams, rebuilt here from ``jax.random.split`` and
the reference's ``_sample`` and handed to the port as ``idx``.

Also the behaviour the reference's tests hold (tests/test_shotgun.py,
test_theory.py's P* and interference tests, test_objectives.py's Eq. 4
equivalence, test_logreg_fused.py's fused-vs-scalar optimum, β = 1/4 near
P* and ``get_solver``), at these small sizes, with F* from the reference's
``fista_solve``; and bit-for-bit repeats with duplicate draws, dense and
BlockedCSC (``shotgun.add_draws`` and the fixed-order scatter
``objectives.index_add_fixed``).

Tolerances: F traces rtol 1e-4, nnz exact, x rtol/atol 1e-4 — as
tests/test_torch_solve.py holds the block solves; across frameworks the
f32 sums (A_Pᵀr over n, Σ|x|, the loss) run in another order."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import objectives as jobj  # noqa: E402
from repro.core import shotgun as jshot  # noqa: E402
from repro.core import spectral as jspec  # noqa: E402
from repro.core.baselines.fista import fista_solve  # noqa: E402
from repro.core.health import GuardConfig as JGuard  # noqa: E402
from repro.core.spec import SolverSpec as JSpec  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.data.sparse import BlockedCSC as JBlockedCSC  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import health as thealth  # noqa: E402
from repro_torch.core import objectives as tobj  # noqa: E402
from repro_torch.core import shotgun as tshot  # noqa: E402
from repro_torch.core import spectral as tspec  # noqa: E402
from repro_torch.core.health import GuardConfig  # noqa: E402
from repro_torch.core.spec import SolverSpec  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

BLOCK = 128


def port_problem(jp):
    """The port's CPU ``Problem`` holding the JAX problem's arrays."""
    A = jp.A
    if isinstance(A, JBlockedCSC):
        A = convert.bcsc_from_numpy(A.rows, A.vals, A.n, A.d, device="cpu")
    else:
        A = np.asarray(A)
    return convert.problem_from_numpy(
        A, np.asarray(jp.y), float(jp.lam), jp.loss,
        scales=None if jp.scales is None else np.asarray(jp.scales),
        device="cpu")


def jax_draws(key, rounds, P, d, replace=True):
    """The (rounds, P) coordinates ``shotgun_solve`` draws from ``key``."""
    keys = jax.random.split(key, rounds)
    return np.asarray(jax.vmap(
        lambda k: jshot._sample(k, d, P, replace))(keys))


def dup_draws(key, rounds, P, d2):
    """The (rounds, P) draws in [0, 2d) of ``shotgun_dup_solve``."""
    keys = jax.random.split(key, rounds)
    return np.asarray(jax.vmap(
        lambda k: jax.random.randint(k, (P,), 0, d2))(keys))


def assert_close(tres, jres):
    t = convert.result_to_numpy(tres)
    np.testing.assert_allclose(t.trace.objective,
                               np.asarray(jres.trace.objective), rtol=1e-4)
    np.testing.assert_array_equal(t.trace.nnz, np.asarray(jres.trace.nnz))
    np.testing.assert_allclose(t.x, np.asarray(jres.x), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(t.z, np.asarray(jres.z), rtol=1e-4,
                               atol=1e-4)
    assert int(t.status) == int(jres.status)


def _problem(layout, loss, seed=1, n=120, d=300, lam=None):
    if lam is None:
        lam = 0.5
    if layout == "bcsc":
        gen = jsyn.large_sparse if loss == "lasso" else jsyn.logistic_data
        kw = dict(density=0.05, layout="bcsc")
    else:
        gen = jsyn.sparco if loss == "lasso" else jsyn.logistic_data
        kw = {}
    A, y, _ = gen(seed=seed, n=n, d=d, **kw)
    return jobj.make_problem(A, y, lam=lam, loss=loss)


def _fstar(jp, iters=4000):
    return float(fista_solve(jp, iters).objective[-1])


# ---------------------------------------------------------------------------
# The objectives seam (repro/core/objectives.py:118-282)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["dense", "bcsc"])
def test_seam_matches_jax(layout):
    jp = _problem(layout, "lasso", d=260)
    tp = port_problem(jp)
    rng = np.random.default_rng(0)
    idx = np.array([3, 259, 3, 130, 128, 7, 3], np.int32)   # duplicates
    r = rng.standard_normal(jp.n).astype(np.float32)
    delta = rng.standard_normal(idx.size).astype(np.float32)
    z = rng.standard_normal(jp.n).astype(np.float32)
    jc = jobj.gather_cols(jp.A, jnp.asarray(idx))
    tc = tobj.gather_cols(tp.A, torch.tensor(idx))
    np.testing.assert_allclose(
        tobj.cols_rmatvec(tc, torch.tensor(r)).numpy(),
        np.asarray(jobj.cols_rmatvec(jc, jnp.asarray(r))), rtol=1e-5,
        atol=1e-6)
    np.testing.assert_allclose(
        tobj.cols_matvec_add(tc, torch.tensor(delta), torch.tensor(z)).numpy(),
        np.asarray(jobj.cols_matvec_add(jc, jnp.asarray(delta),
                                        jnp.asarray(z))), rtol=1e-5,
        atol=1e-6)
    x = (rng.standard_normal(jp.d) * (rng.random(jp.d) < 0.2)).astype(
        np.float32)
    for loss in ("lasso", "logistic"):
        yl = np.sign(np.asarray(jp.y)) + (np.asarray(jp.y) == 0)
        jl = jp._replace(loss=loss, y=jnp.asarray(yl, jnp.float32))
        tl = tp._replace(loss=loss, y=torch.tensor(yl, dtype=torch.float32))
        zz = jobj.matvec(jl.A, jnp.asarray(x))
        np.testing.assert_allclose(
            float(tobj.data_loss_from_margin(torch.tensor(np.asarray(zz)),
                                             tl.y, loss)),
            float(jobj.data_loss_from_margin(zz, jl.y, loss)), rtol=1e-5)
        np.testing.assert_allclose(
            float(tobj.objective(torch.tensor(x), tl)),
            float(jobj.objective(jnp.asarray(x), jl)), rtol=1e-5)
    if layout == "dense":
        np.testing.assert_allclose(
            float(tobj.coordinate_grad(tp.A, torch.tensor(r), 17)),
            float(jobj.coordinate_grad(jp.A, jnp.asarray(r), 17)),
            rtol=1e-5)
        with pytest.raises(TypeError, match="dense"):
            tobj.require_dense(port_problem(_problem("bcsc", "lasso")).A,
                               "CDN")


def test_index_add_fixed_sums_duplicates_in_a_fixed_order():
    rng = np.random.default_rng(3)
    base = rng.standard_normal(50).astype(np.float32)
    index = rng.integers(0, 50, 400)          # every slot drawn ~8 times
    values = rng.standard_normal(400).astype(np.float32)
    want = base.astype(np.float64)
    np.add.at(want, index, values.astype(np.float64))
    got = tobj.index_add_fixed(torch.tensor(base), torch.tensor(index),
                               torch.tensor(values))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    again = tobj.index_add_fixed(torch.tensor(base), torch.tensor(index),
                                 torch.tensor(values))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    # a permutation of the pairs with one index order kept gives the same
    # bits: the order is the data's, not the call's
    perm = np.argsort(index, kind="stable")
    same = tobj.index_add_fixed(torch.tensor(base),
                                torch.tensor(index[perm]),
                                torch.tensor(values[perm]))
    assert torch.equal(got.view(torch.int32), same.view(torch.int32))
    # a NaN value reaches only its own slot
    values[7] = np.nan
    nan = tobj.index_add_fixed(torch.tensor(base), torch.tensor(index),
                               torch.tensor(values))
    assert torch.isnan(nan).nonzero().flatten().tolist() == [index[7]]


def test_add_draws_counts_duplicates_and_live_draws():
    """Alg. 2's Δx: duplicate draws carry one δ, so the sum is δ times the
    live draws of the coordinate — as ``jnp``'s ``.at[idx].add`` of the
    masked deltas."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal(30).astype(np.float32)
    ii = rng.integers(0, 30, 64)
    per_coord = rng.standard_normal(30).astype(np.float32)
    delta = per_coord[ii]
    live = (np.arange(64) < 40).astype(np.float32)
    want = jnp.asarray(x).at[jnp.asarray(ii)].add(jnp.asarray(delta * live))
    got = tshot.add_draws(torch.tensor(x), torch.tensor(ii),
                          torch.tensor(delta), torch.tensor(live))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    again = tshot.add_draws(torch.tensor(x), torch.tensor(ii),
                            torch.tensor(delta), torch.tensor(live))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    all_live = tshot.add_draws(torch.tensor(x), torch.tensor(ii),
                               torch.tensor(delta))
    np.testing.assert_allclose(
        all_live.numpy(),
        np.asarray(jnp.asarray(x).at[jnp.asarray(ii)].add(delta)),
        rtol=1e-6, atol=1e-6)


def test_dup_equivalence():
    """Eq. 4's duplicated-feature objective agrees with the signed form
    (test_objectives.py::test_dup_equivalence), and with the reference's."""
    A, y, _ = jsyn.sparco(seed=4, n=40, d=20)
    jp = jobj.make_problem(A, y, lam=0.3)
    tp = port_problem(jp)
    dp = tobj.dup_from(tp)
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal(20), dtype=torch.float32)
    xhat = torch.cat([torch.clamp_min(x, 0), torch.clamp_min(-x, 0)])
    np.testing.assert_allclose(float(tobj.dup_objective(xhat, dp)),
                               float(tobj.objective(x, tp)), rtol=1e-5)
    np.testing.assert_allclose(tobj.dup_to_signed(xhat).numpy(), x.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(
        float(tobj.dup_objective(xhat, dp)),
        float(jobj.dup_objective(jnp.asarray(xhat.numpy()),
                                 jobj.dup_from(jp))), rtol=1e-5)
    for j in (3, 27):
        col, sign = tobj.dup_column(dp, j)
        jcol, jsign = jobj.dup_column(jobj.dup_from(jp), j)
        np.testing.assert_array_equal(col.numpy(), np.asarray(jcol))
        assert float(sign) == float(jsign)
    assert dp.d2 == 40 and dp.beta == 1.0


def test_dense_bf16_design_promotes_as_jax():
    """A bf16 dense design times an f32 vector is an f32 product, as jnp
    promotes it (the port's seam used to raise on the mixed dtypes)."""
    A, y, _ = jsyn.sparco(seed=2, n=64, d=48)
    jp = jobj.make_problem(A, y, lam=0.3)
    A16 = np.asarray(jp.A.astype(jnp.bfloat16).astype(jnp.float32))
    jA = jnp.asarray(A16, jnp.bfloat16)
    tA = torch.tensor(A16).to(torch.bfloat16)
    x = np.random.default_rng(1).standard_normal(48).astype(np.float32)
    got = tobj.matvec(tA, torch.tensor(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jobj.matvec(
        jA, jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        float(tobj.lambda_max(tA, torch.tensor(np.asarray(jp.y)), "lasso")),
        float(jobj.lambda_max(jA, jp.y, "lasso")), rtol=1e-5)


# ---------------------------------------------------------------------------
# The solvers against the JAX package on the same draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout,loss", [("dense", "lasso"),
                                         ("dense", "logistic"),
                                         ("bcsc", "lasso"),
                                         ("bcsc", "logistic")])
def test_shotgun_matches_jax(layout, loss):
    jp = _problem(layout, loss)
    tp = port_problem(jp)
    key = jax.random.PRNGKey(0)
    spec = dict(loss=loss, P=8, rounds=60)
    jres = jshot.shotgun_solve(jp, key, spec=JSpec(**spec))
    tres = tshot.shotgun_solve(tp, spec=SolverSpec(**spec),
                               idx=jax_draws(key, 60, 8, jp.d))
    assert_close(tres, jres)


def test_shotgun_without_replacement_and_warm_start_match_jax():
    jp = _problem("dense", "lasso")
    tp = port_problem(jp)
    key = jax.random.PRNGKey(3)
    x0 = np.random.default_rng(0).standard_normal(jp.d).astype(np.float32)
    x0 *= np.random.default_rng(1).random(jp.d) < 0.1
    jres = jshot.shotgun_solve(jp, key, spec=JSpec(P=16, rounds=40),
                               replace=False, x0=jnp.asarray(x0))
    tres = tshot.shotgun_solve(tp, spec=SolverSpec(P=16, rounds=40),
                               idx=jax_draws(key, 40, 16, jp.d, False),
                               x0=torch.tensor(x0))
    assert_close(tres, jres)


def test_shotgun_guarded_matches_jax_and_backs_off():
    """Far beyond P* on a correlated design the sentinel trips, rolls
    back and halves P on both sides, on the same draws."""
    A, y, _ = jsyn.sparco(seed=4, n=128, d=256, corr=0.95)
    jp = jobj.make_problem(A, y, lam=0.1)
    tp = port_problem(jp)
    key = jax.random.PRNGKey(0)
    kw = dict(P=64, rounds=40)
    jres = jshot.shotgun_solve(jp, key, spec=JSpec(guard=JGuard(p_min=2),
                                                   **kw))
    tres = tshot.shotgun_solve(tp, spec=SolverSpec(
        guard=GuardConfig(p_min=2), **kw), idx=jax_draws(key, 40, 64, jp.d))
    assert int(jres.status) == thealth.STATUS_RECOVERED
    assert_close(tres, jres)
    # unguarded, the same draws diverge
    bad = tshot.shotgun_solve(tp, spec=SolverSpec(**kw),
                              idx=jax_draws(key, 40, 64, jp.d))
    assert bool(tshot.diverged(bad.trace.objective))


@pytest.mark.parametrize("layout", ["dense", "bcsc"])
def test_shooting_matches_jax(layout):
    jp = _problem(layout, "lasso")
    tp = port_problem(jp)
    key = jax.random.PRNGKey(5)
    jres = jshot.shooting_solve(jp, key, rounds=150)
    tres = tshot.shooting_solve(tp, rounds=150,
                                idx=jax_draws(key, 150, 1, jp.d))
    assert_close(tres, jres)


def test_dup_solve_matches_jax_with_collisions():
    A, y, _ = jsyn.sparco(seed=7, n=60, d=12)
    jp = jobj.make_problem(A, y, lam=0.2)
    tp = port_problem(jp)
    key = jax.random.PRNGKey(0)
    P, rounds = 16, 150        # P > d2 / 2: collisions every round
    jres = jshot.shotgun_dup_solve(jobj.dup_from(jp), key, P=P, rounds=rounds)
    tres = tshot.shotgun_dup_solve(tobj.dup_from(tp), P=P, rounds=rounds,
                                   idx=dup_draws(key, rounds, P, 24))
    assert_close(tres, jres)


@pytest.mark.parametrize("layout", ["dense", "bcsc"])
def test_repeat_is_bit_identical_with_duplicate_draws(layout):
    tp = port_problem(_problem(layout, "lasso", d=40))
    idx = torch.randint(0, 40, (30, 32),
                        generator=torch.Generator().manual_seed(0))
    assert bool((idx[:, :, None] == idx[:, None, :]).sum((1, 2)).gt(32).all())
    spec = SolverSpec(P=32, rounds=30)
    a = tshot.shotgun_solve(tp, spec=spec, idx=idx)
    b = tshot.shotgun_solve(tp, spec=spec, idx=idx.clone())
    for u, v in ((a.x, b.x), (a.z, b.z), (a.trace.objective,
                                          b.trace.objective)):
        assert torch.equal(u.view(torch.int32), v.view(torch.int32))
    g1, g2 = (torch.Generator().manual_seed(7) for _ in range(2))
    c = tshot.shotgun_solve(tp, g1, spec=spec)
    d = tshot.shotgun_solve(tp, g2, spec=spec)
    assert torch.equal(c.x, d.x) and torch.equal(c.trace.nnz, d.trace.nnz)


def test_interface_rejections():
    tp = port_problem(_problem("dense", "lasso", d=40))
    with pytest.raises(TypeError, match="spec="):
        tshot.shotgun_solve(tp, torch.Generator())
    with pytest.raises(ValueError, match="logistic"):
        tshot.shotgun_solve(tp, torch.Generator(),
                            spec=SolverSpec(loss="logistic"))
    with pytest.raises(ValueError, match="shape"):
        tshot.shotgun_solve(tp, spec=SolverSpec(P=4, rounds=3),
                            idx=np.zeros((3, 5), np.int32))
    with pytest.raises(ValueError, match=r"\[0, 40\)"):
        tshot.shotgun_solve(tp, spec=SolverSpec(P=2, rounds=1),
                            idx=np.array([[0, 40]]))
    with pytest.raises(ValueError, match="Generator"):
        tshot.shooting_solve(tp, rounds=3)
    # a generator's draws without replacement are distinct in each round
    idx = tshot.draw_coords(torch.Generator().manual_seed(0), 5, 40, 40,
                            replace=False)
    assert all(len(set(row.tolist())) == 40 for row in idx)
    assert torch.isfinite(tshot.shotgun_solve(
        tp, torch.Generator(), spec=SolverSpec(P=8, rounds=5),
        replace=False).trace.objective).all()


# ---------------------------------------------------------------------------
# Behaviour (tests/test_shotgun.py at these sizes)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loss", ["lasso", "logistic"])
def test_shooting_converges(loss):
    A, y, _ = (jsyn.sparco(seed=0, n=100, d=12) if loss == "lasso"
               else jsyn.logistic_data(seed=0, n=100, d=12))
    jp = jobj.make_problem(A, y, lam=0.5, loss=loss)
    res = tshot.shooting_solve(port_problem(jp),
                               torch.Generator().manual_seed(0), rounds=200)
    f = res.trace.objective.numpy()
    assert f[-1] <= _fstar(jp) * 1.005 + 1e-3
    assert f[-1] < f[0]


def test_shotgun_matches_shooting_fixed_point():
    A, y, _ = jsyn.sparco(seed=1, n=120, d=24)
    tp = port_problem(jobj.make_problem(A, y, lam=0.5))
    f8 = float(tshot.shotgun_solve(tp, torch.Generator().manual_seed(1),
                                   spec=SolverSpec(P=8, rounds=100))
               .trace.objective[-1])
    f1 = float(tshot.shooting_solve(tp, torch.Generator().manual_seed(2),
                                    rounds=200).trace.objective[-1])
    assert abs(f8 - f1) / abs(f1) < 0.01


def test_dup_form_matches_signed_form():
    A, y, _ = jsyn.sparco(seed=2, n=80, d=16)
    tp = port_problem(jobj.make_problem(A, y, lam=0.5))
    f_dup = float(tshot.shotgun_dup_solve(
        tobj.dup_from(tp), torch.Generator().manual_seed(0), P=4,
        rounds=200).trace.objective[-1])
    f_sgn = float(tshot.shotgun_solve(
        tp, torch.Generator().manual_seed(0),
        spec=SolverSpec(P=4, rounds=200)).trace.objective[-1])
    assert abs(f_dup - f_sgn) / abs(f_sgn) < 0.01


def test_parallel_speedup_in_iterations():
    """T(P) shrinks ~1/P for P well below P* (Thm 3.2)."""
    A, y, _ = jsyn.sparco(seed=3, n=256, d=64)
    jp = jobj.make_problem(A, y, lam=1.0)
    tp = port_problem(jp)
    assert tspec.p_star(tp.A) > 16
    fstar = _fstar(jp)
    t1 = int(tshot.rounds_to_tolerance(tshot.shooting_solve(
        tp, torch.Generator().manual_seed(0), rounds=200).trace.objective,
        fstar, rel_tol=0.05))
    t8 = int(tshot.rounds_to_tolerance(tshot.shotgun_solve(
        tp, torch.Generator().manual_seed(0),
        spec=SolverSpec(P=8, rounds=200)).trace.objective, fstar,
        rel_tol=0.05))
    assert t1 < 200
    assert t8 < t1 / 4


def test_divergence_past_pstar():
    A, y, _ = jsyn.sparco(seed=4, n=128, d=256, corr=0.95)
    tp = port_problem(jobj.make_problem(A, y, lam=0.1))
    ps = tspec.p_star(tp.A)
    assert ps <= 4
    res = tshot.shotgun_dup_solve(tobj.dup_from(tp),
                                  torch.Generator().manual_seed(0),
                                  P=max(64, 32 * ps), rounds=200)
    assert bool(tshot.diverged(res.trace.objective))


def test_dup_maintained_margin_matches_recompute():
    """The incremental z (scatter + clip corrections) tracks a recompute of
    z = A x̂ from scratch each round, collisions and clips included."""
    A, y, _ = jsyn.sparco(seed=7, n=60, d=12)
    tp = port_problem(jobj.make_problem(A, y, lam=0.2))
    dp = tobj.dup_from(tp)
    P, rounds, d = 16, 200, 12
    idx = torch.randint(0, 2 * d, (rounds, P),
                        generator=torch.Generator().manual_seed(0))
    res = tshot.shotgun_dup_solve(dp, P=P, rounds=rounds, idx=idx)
    xhat = torch.zeros(2 * d)
    z = torch.zeros(tp.n)
    fs = []
    for ii in idx:
        r = tobj.residual_like(z, dp.y, dp.loss)
        sign = torch.where(ii < d, 1.0, -1.0)
        Ap = dp.A[:, ii % d] * sign[None, :]
        delta = torch.maximum(-xhat[ii], -(Ap.T @ r + dp.lam) / dp.beta)
        raw = xhat.clone()
        for k in range(P):
            raw[ii[k]] += delta[k]
        xhat = torch.clamp_min(raw, 0.0)
        z = dp.A @ (xhat[:d] - xhat[d:])
        fs.append(float(tobj.data_loss_from_margin(z, dp.y, dp.loss)
                        + dp.lam * xhat.sum()))
    np.testing.assert_allclose(res.trace.objective.numpy(), fs, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(res.x.numpy(), xhat.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(res.z.numpy(), z.numpy(), rtol=1e-3,
                               atol=1e-3)


def test_maintained_margin_consistency():
    A, y, _ = jsyn.sparse_imaging(seed=5, n=120, d=240)
    tp = port_problem(jobj.make_problem(A, y, lam=0.5))
    res = tshot.shotgun_solve(tp, torch.Generator().manual_seed(3),
                              spec=SolverSpec(P=4, rounds=200))
    np.testing.assert_allclose(res.z.numpy(), (tp.A @ res.x).numpy(),
                               rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# Theory (tests/test_theory.py): P* and the Thm 3.1 interference terms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,P", [(0, 2), (1, 5), (2, 8), (3, 12)])
def test_theorem_3_1_interference_decomposition(seed, P):
    """For the Lasso, sequential progress + interference (Thm 3.1) equals
    the change of the smooth part beyond its first-order term, for one
    parallel round of the port's update."""
    A, y, _ = jsyn.sparco(seed=seed % 7, n=40, d=30)
    tp = port_problem(jobj.make_problem(A, y, lam=0.4))
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal(30) * 0.3, dtype=torch.float32)
    idx = torch.tensor(rng.integers(0, 30, P))
    r = tobj.residual_like(tp.A @ x, tp.y, tp.loss)
    delta = tobj.shooting_delta(x[idx], tp.A[:, idx].T @ r, tp.lam, tp.beta)
    x_new = tobj.index_add_fixed(x, idx, delta)

    def L(v):
        return tobj.data_loss_from_margin(tp.A @ v, tp.y, tp.loss)

    xg = x.clone().requires_grad_(True)
    grad, = torch.autograd.grad(L(xg), xg)
    lhs = float(L(x_new) - L(x) - torch.dot(x_new - x, grad))
    G = tp.A.T @ tp.A
    seq = 0.5 * float(torch.sum(delta ** 2 * torch.diagonal(G)[idx]))
    inter = 0.5 * float(delta @ G[idx][:, idx] @ delta
                        - torch.sum(delta ** 2 * torch.diagonal(G)[idx]))
    assert abs(lhs - (seq + inter)) <= 1e-3 * max(1.0, abs(lhs))


@pytest.mark.parametrize("seed", [0, 3])
def test_expected_progress_below_pstar(seed):
    A, y, _ = jsyn.sparco(seed=seed % 5, n=128, d=128)
    tp = port_problem(jobj.make_problem(A, y, lam=0.5))
    P = max(1, min(16, tspec.p_star(tp.A) - 1))
    res = tshot.shotgun_solve(tp, torch.Generator().manual_seed(seed),
                              spec=SolverSpec(P=P, rounds=200))
    f = res.trace.objective.numpy()
    assert f[-1] < f[0]
    assert np.mean(np.diff(f[:50])) < 0


def test_pstar_extremes_and_dup_bound():
    """Identical columns → P* = 1; orthogonal columns → P* = d; the
    duplicated-feature bound agrees with the reference's."""
    rng = np.random.default_rng(8)
    col = rng.standard_normal((64, 1)).astype(np.float32)
    same, _ = tobj.normalize_columns(torch.tensor(np.repeat(col, 32, 1)))
    assert tspec.p_star(same) == 1
    orth, _ = tobj.normalize_columns(torch.tensor(
        np.linalg.qr(rng.standard_normal((64, 32)))[0], dtype=torch.float32))
    assert tspec.p_star(orth) == 32
    A, y, _ = jsyn.sparco(seed=3, n=128, d=96)
    jp = jobj.make_problem(A, y, lam=0.5)
    key = jax.random.PRNGKey(0)
    v0 = torch.tensor(np.asarray(jax.random.normal(key, (96,), jnp.float32)))
    assert tspec.p_star_dup(port_problem(jp).A, v0=v0) == \
        jspec.p_star_dup(jp.A, key)
    assert tspec.p_star_dup(same) == 2


# ---------------------------------------------------------------------------
# Fused kernel path against the scalar optimum; get_solver
# (tests/test_logreg_fused.py:99, :115, :128, :226, :240)
# ---------------------------------------------------------------------------

def _fused_vs_scalar(tp, P, fused_rounds, scalar_rounds):
    rf = tops.block_shotgun_solve(
        tp, torch.Generator().manual_seed(0),
        spec=SolverSpec(loss="logistic", P=P, rounds=fused_rounds,
                        fused=True))
    rs = tshot.shotgun_solve(tp, torch.Generator().manual_seed(1),
                             spec=SolverSpec(loss="logistic", P=P,
                                             rounds=scalar_rounds))
    ff, fs = float(rf.trace.objective[-1]), float(rs.trace.objective[-1])
    assert abs(ff - fs) / abs(fs) < 1e-3, (ff, fs)
    np.testing.assert_allclose(rf.x.numpy(), rs.x.numpy(), atol=1e-4)


def test_fused_logistic_matches_scalar_solution_dense():
    A, y, _ = jsyn.logistic_data(seed=3, n=400, d=256)
    _fused_vs_scalar(port_problem(jobj.make_problem(A, y, lam=2.0,
                                                    loss="logistic")),
                     256, 200, 200)


def test_fused_logistic_matches_scalar_solution_bcsc():
    S, y, _ = jsyn.logistic_data(seed=4, n=400, d=256, density=0.05,
                                 layout="bcsc")
    _fused_vs_scalar(port_problem(jobj.make_problem(S, y, lam=0.3,
                                                    loss="logistic")),
                     128, 200, 200)


def test_logistic_beta_quarter_converges_near_pstar():
    A, y, _ = jsyn.logistic_data(seed=5, n=512, d=1024)
    tp = port_problem(jobj.make_problem(A, y, lam=0.5, loss="logistic"))
    assert tspec.p_star(tp.A) >= BLOCK
    r = tops.block_shotgun_solve(tp, torch.Generator().manual_seed(0),
                                 spec=SolverSpec(loss="logistic", P=BLOCK,
                                                 rounds=200, fused=True))
    tr = r.trace.objective.numpy()
    assert not bool(tshot.diverged(tr))
    assert tr[-1] < tr[0]


def test_get_solver_names_family_loss_pair_admission():
    assert len(tshot.SOLVER_NAMES) == 10
    assert tshot.SOLVER_NAMES == jshot.SOLVER_NAMES
    for name in tshot.SOLVER_NAMES:
        assert callable(tshot.get_solver(name))
    with pytest.raises(ValueError, match="unknown solver"):
        tshot.get_solver("nope")
    solver = tshot.get_solver(("block_fused", "logistic"))
    A, y, _ = jsyn.logistic_data(seed=6, n=200, d=128)
    prob = port_problem(jobj.make_problem(A, y, lam=0.5, loss="logistic"))
    r = solver(prob, torch.Generator().manual_seed(0),
               spec=SolverSpec(loss="logistic", P=128, rounds=2),
               rounds_per_launch=2)
    assert np.isfinite(float(r.trace.objective[-1]))
    lasso = port_problem(_problem("dense", "lasso", d=256))
    with pytest.raises(ValueError) as ei:
        solver(lasso, torch.Generator(), spec=SolverSpec(P=128, rounds=2))
    assert "logistic" in str(ei.value) and "lasso" in str(ei.value)
    with pytest.raises(ValueError, match="unknown loss"):
        tshot.get_solver(("block_fused", "huber"))
    # a scalar family bound to a loss admits its own loss only
    s = tshot.get_solver(("shotgun", "lasso"))
    assert np.isfinite(float(s(lasso, torch.Generator(),
                               spec=SolverSpec(P=4, rounds=2))
                             .trace.objective[-1]))
    with pytest.raises(ValueError, match="bound to loss"):
        s(prob, torch.Generator(), spec=SolverSpec(loss="logistic"))


def test_logreg_fused_aliases():
    A, y, _ = jsyn.logistic_data(seed=6, n=200, d=128)
    prob = port_problem(jobj.make_problem(A, y, lam=0.5, loss="logistic"))
    spec = SolverSpec(loss="logistic", P=128, rounds=2)
    idx = np.zeros((2, 1), np.int32)
    r = tshot.get_solver("shotgun_logreg_fused")(prob, spec=spec,
                                                 blk_idx=idx,
                                                 rounds_per_launch=2)
    assert np.isfinite(float(r.trace.objective[-1]))
    # the alias promotes a spec left at fused=False onto the fused path
    r2 = tops.block_shotgun_solve(prob, spec=SolverSpec(
        loss="logistic", P=128, rounds=2, fused=True), blk_idx=idx,
        rounds_per_launch=2)
    assert torch.equal(r.x, r2.x)
    with pytest.raises(ValueError, match="BlockedCSC"):
        tshot.get_solver("sparse_logreg_fused")(prob, spec=spec, blk_idx=idx)
    S, ys, _ = jsyn.logistic_data(seed=4, n=256, d=256, density=0.05,
                                  layout="bcsc")
    sprob = port_problem(jobj.make_problem(S, ys, lam=0.3, loss="logistic"))
    rs = tshot.get_solver("sparse_logreg_fused")(sprob, spec=spec,
                                                 blk_idx=idx,
                                                 rounds_per_launch=2)
    assert np.isfinite(float(rs.trace.objective[-1]))
