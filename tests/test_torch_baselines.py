"""The port's baselines (``repro_torch.core.baselines``) against the JAX
package's on the same normalized problems, the same power-iteration start
vector (JAX's ``PRNGKey(0)`` normal, passed as ``v0``) and the same draws
(the reference's threefry streams, rebuilt here from ``jax.random.split``
and ``jax.random.randint`` and handed to the port as ``idx``).

The reference's data-dependent inner loops — CG's early stop, SpaRSA's
doublings, L1_LS's halvings — run in the port as one batch with the exit
picked on the device.  Their counts are held against the reference's own
``while_loop``s, read out of the jitted reference with a debug callback on
each loop's final counter (``jax_loop_counts``).

Also the behaviour tests/test_baselines.py holds, with the port's own F*.
Cut for CPU time: the SGD rate search of ``test_sgd_logistic_decreases``
runs 5000 steps a rate where the reference's runs 20000.

Tolerances: F traces rtol 1e-4 over 200 iterations (500 SGD/SMIDAS
steps); x atol 1e-5 of max(1, ‖x‖∞) (f32 holds |x| ≈ 38 to 4e-6 an ulp),
for FISTA on the logistic set at 12 iterations (see the test);
FPC_AS and L1_LS, whose early stops may branch on rounding, final F rtol
1e-3 with every CG count and line-search step equal to the reference's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax._src.lax as jax_src_lax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import objectives as jobj  # noqa: E402
from repro.core.baselines import (fista as jfista, fpc_as as jfpc,  # noqa: E402
                                  gpsr as jgpsr, iht as jiht, l1_ls as jl1,
                                  sgd as jsgd, smidas as jsmidas,
                                  sparsa as jsparsa)
from repro.core.baselines.common import lipschitz as jlipschitz  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import baselines as tb  # noqa: E402
from repro_torch.core import objectives as tobj  # noqa: E402
from repro_torch.core.baselines import common as tcommon  # noqa: E402
from repro_torch.core.baselines import iht as tiht  # noqa: E402
from repro_torch.core.baselines import l1_ls as tl1  # noqa: E402
from repro_torch.core.baselines import smidas as tsmidas  # noqa: E402
from repro_torch.core.baselines import sparsa as tsparsa  # noqa: E402
from repro_torch.core.shotgun import shotgun_solve  # noqa: E402
from repro_torch.core.spec import SolverSpec  # noqa: E402
from repro_torch.data import sparse as tsp  # noqa: E402

F_RTOL, X_ATOL = 1e-4, 1e-5


def port_problem(jp):
    return convert.problem_from_numpy(
        np.asarray(jp.A), np.asarray(jp.y), float(jp.lam), jp.loss,
        scales=None if jp.scales is None else np.asarray(jp.scales),
        device="cpu")


def v0_of(d):
    """The start vector of the reference's ``spectral_radius``."""
    return torch.tensor(np.asarray(
        jax.random.normal(jax.random.PRNGKey(0), (d,), jnp.float32)))


def sgd_draws(key, steps, n, record_every=100):
    """The rows ``sgd_solve`` / ``smidas_solve`` draw from ``key``."""
    keys = jax.random.split(key, (steps // record_every) * record_every)
    return np.asarray(jax.vmap(
        lambda k: jax.random.randint(k, (), 0, n))(keys))


def parallel_sgd_draws(key, steps, K, shard):
    """(K, steps) rows in [0, shard) of ``parallel_sgd_solve``."""
    return np.stack([np.asarray(jax.vmap(
        lambda k: jax.random.randint(k, (), 0, shard))(
        jax.random.split(kk, steps))) for kk in jax.random.split(key, K)])


def assert_matches(t, j, f_rtol=F_RTOL):
    np.testing.assert_allclose(t.objective.numpy(), np.asarray(j.objective),
                               rtol=f_rtol)
    xj = np.asarray(j.x)
    np.testing.assert_allclose(
        t.x.numpy(), xj, rtol=0,
        atol=X_ATOL * max(1.0, float(np.abs(xj).max())))


@pytest.fixture(scope="module")
def lasso():
    A, y, _ = jsyn.sparco(seed=0, n=128, d=96)
    jp = jobj.make_problem(A, y, lam=0.5)
    return jp, port_problem(jp)


@pytest.fixture(scope="module")
def logreg():
    A, y, _ = jsyn.logistic_data(seed=2, n=512, d=64)
    jp = jobj.make_problem(A, y, lam=0.05, loss="logistic")
    return jp, port_problem(jp)


@pytest.fixture(scope="module")
def fstar(lasso):
    """The port's own F* (tests/test_baselines.py's, 5000 iterations)."""
    return tb.f_star(lasso[1], 5000)


@pytest.fixture
def jax_loop_counts(monkeypatch):
    """Every ``lax.while_loop`` the reference runs reports its final
    counter (the last element of its carry: CG's k, the line searches'
    it) to the returned list, in program order."""
    orig = jax.lax.while_loop
    log = []

    def counting(cond, body, init):
        out = orig(cond, body, init)
        jax.debug.callback(lambda k: log.append(int(k)), out[-1],
                           ordered=True)
        return out

    jax.clear_caches()           # no trace from before the patch is reused
    monkeypatch.setattr(jax.lax, "while_loop", counting)
    monkeypatch.setattr(jax_src_lax, "while_loop", counting)
    yield log
    jax.clear_caches()


# ---------------------------------------------------------------------------
# Each baseline against the reference on the same inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loss", ["lasso", "logistic"])
def test_lipschitz_matches_jax(lasso, logreg, loss):
    jp, tp = lasso if loss == "lasso" else logreg
    np.testing.assert_allclose(
        float(tcommon.lipschitz(tp, v0=v0_of(tp.d))), float(jlipschitz(jp)),
        rtol=1e-5)


@pytest.mark.parametrize("loss", ["lasso", "logistic"])
def test_fista_matches_jax(lasso, logreg, loss):
    jp, tp = lasso if loss == "lasso" else logreg
    res = tb.fista_solve(tp, 200, v0=v0_of(tp.d))
    jres = jfista.fista_solve(jp, 200)
    if loss == "lasso":
        assert_matches(res, jres)
    else:
        # F reaches f32 rounding by iteration ~15; from there the monotone
        # restart branches on rounding-level differences of F, and x moves
        # along the flat valley (by 3e-4 of ‖x‖∞ at 200 iterations), so x
        # is held before that and F over all 200 iterations
        np.testing.assert_allclose(res.objective.numpy(),
                                   np.asarray(jres.objective), rtol=F_RTOL)
        assert_matches(tb.fista_solve(tp, 12, v0=v0_of(tp.d)),
                       jfista.fista_solve(jp, 12))
    assert tb.f_star(tp, 200, v0=v0_of(tp.d)) == float(res.objective[-1])


@pytest.mark.parametrize("loss", ["lasso", "logistic"])
def test_sparsa_matches_jax(lasso, logreg, loss):
    jp, tp = lasso if loss == "lasso" else logreg
    assert_matches(tb.sparsa_solve(tp, 200), jsparsa.sparsa_solve(jp, 200))


def test_gpsr_matches_jax(lasso):
    jp, tp = lasso
    assert_matches(tb.gpsr_bb_solve(tp, 200), jgpsr.gpsr_bb_solve(jp, 200))


@pytest.mark.parametrize("case", ["sparco", "singlepixcam"])
def test_iht_matches_jax(lasso, case):
    if case == "sparco":
        (jp, tp), s = lasso, 10
    else:
        A, y, xt = jsyn.singlepixcam(seed=1, n=256, d=128, nnz_frac=0.04)
        jp = jobj.make_problem(A, y, lam=0.0, normalize=False)
        tp, s = port_problem(jp), int((np.abs(xt) > 0).sum())
    assert_matches(tb.iht_solve(tp, s, 200), jiht.iht_solve(jp, s=s,
                                                            iters=200))


@pytest.mark.parametrize("ist_iters", [3, 50])
def test_fpc_as_matches_jax_and_its_cg_counts(lasso, jax_loop_counts,
                                              ist_iters):
    """ist_iters = 3 leaves CG work (maxiter reached, then early stops);
    at 50 IST sweeps the subspace CG stops before its first iteration."""
    jp, tp = lasso
    jres = jfpc.fpc_as_solve(jp, ist_iters=ist_iters)
    jax.effects_barrier()
    tres = tb.fpc_as_solve(tp, ist_iters=ist_iters, v0=v0_of(tp.d))
    assert tres.inner["cg"].tolist() == jax_loop_counts
    np.testing.assert_allclose(float(tres.objective[-1]),
                               float(jres.objective[-1]), rtol=1e-3)
    assert tres.objective.shape == jres.objective.shape
    if ist_iters == 3:
        assert max(jax_loop_counts) == 20 and 0 < min(jax_loop_counts) < 20


def test_l1_ls_matches_jax_and_its_inner_loops(lasso, jax_loop_counts):
    """Each Newton step runs the CG, then the line search: their counts
    interleave in the reference's callbacks."""
    jp, tp = lasso
    jres = jl1.l1_ls_solve(jp)
    jax.effects_barrier()
    tres = tb.l1_ls_solve(tp)
    got = torch.stack([tres.inner["cg"], tres.inner["halvings"].to(
        torch.int32)], dim=1).reshape(-1).tolist()
    assert got == jax_loop_counts
    assert 0 < max(tres.inner["halvings"].tolist())
    np.testing.assert_allclose(float(tres.objective[-1]),
                               float(jres.objective[-1]), rtol=1e-3)
    np.testing.assert_allclose(tres.objective.numpy(),
                               np.asarray(jres.objective), rtol=1e-3)


@pytest.mark.parametrize("loss", ["lasso", "logistic"])
def test_sgd_matches_jax(lasso, logreg, loss):
    jp, tp = lasso if loss == "lasso" else logreg
    key, eta = jax.random.PRNGKey(3), (0.05 if loss == "lasso" else 0.1)
    idx = sgd_draws(key, 550, tp.n)
    assert idx.shape == (500,)                  # the remainder is dropped
    assert_matches(tb.sgd_solve(tp, None, eta, 550, idx=idx),
                   jsgd.sgd_solve(jp, key, eta, 550))


def test_parallel_sgd_matches_jax(logreg):
    jp, tp = logreg
    key, K = jax.random.PRNGKey(4), 4
    idx = parallel_sgd_draws(key, 500, K, tp.n // K)
    assert_matches(tb.parallel_sgd_solve(tp, None, 1.0, 500, K=K, idx=idx),
                   jsgd.parallel_sgd_solve(jp, key, 1.0, 500, K=K))


@pytest.mark.parametrize("loss", ["lasso", "logistic"])
def test_smidas_matches_jax(lasso, logreg, loss):
    jp, tp = lasso if loss == "lasso" else logreg
    key, eta = jax.random.PRNGKey(5), (0.005 if loss == "lasso" else 0.05)
    idx = sgd_draws(key, 500, tp.n)
    assert_matches(tb.smidas_solve(tp, None, eta, 500, idx=idx),
                   jsmidas.smidas_solve(jp, key, eta, 500))


def test_sgd_rate_search_matches_jax(logreg):
    jp, tp = logreg
    key, rates = jax.random.PRNGKey(0), np.geomspace(1e-3, 1.0, 4)
    jbest, jrate = jsgd.sgd_rate_search(jp, key, 300, rates=rates)
    tbest, trate = tb.sgd_rate_search(tp, None, 300, rates=rates,
                                      idx=sgd_draws(key, 300, tp.n))
    assert trate == jrate
    assert_matches(tbest, jbest)


# ---------------------------------------------------------------------------
# The pickers and the pieces, against the reference's own loops
# ---------------------------------------------------------------------------

def _jax_cg_count(matvec, b, x0, maxiter, M, counts):
    jax.scipy.sparse.linalg.cg(matvec, b, x0=x0, maxiter=maxiter, M=M)
    jax.effects_barrier()
    return counts[-1]


@pytest.mark.parametrize("precond", [False, True])
@pytest.mark.parametrize("case", ["early_stop", "maxiter", "b_zero",
                                  "warm_start"])
def test_cg_matches_jax(jax_loop_counts, precond, case):
    rng = np.random.default_rng(7)
    m = 40
    B = rng.standard_normal((m, m)).astype(np.float32)
    H = (B @ B.T / m + np.diag(rng.uniform(0.1, 3.0, m))).astype(np.float32)
    b = (np.zeros(m) if case == "b_zero"
         else rng.standard_normal(m)).astype(np.float32)
    x0 = (rng.standard_normal(m).astype(np.float32) if case == "warm_start"
          else None)
    maxiter = 5 if case == "maxiter" else 200
    diag = np.diag(H).copy()
    jM = (lambda p: p / jnp.asarray(diag)) if precond else None
    tM = (lambda p: p / torch.tensor(diag)) if precond else None
    Hj, Ht = jnp.asarray(H), torch.tensor(H)
    jx, _ = jax.scipy.sparse.linalg.cg(lambda p: Hj @ p, jnp.asarray(b),
                                       x0=None if x0 is None
                                       else jnp.asarray(x0),
                                       maxiter=maxiter, M=jM)
    jax.effects_barrier()
    want_k = jax_loop_counts[-1]
    tx, k = tcommon.cg(lambda p: Ht @ p, torch.tensor(b),
                       None if x0 is None else torch.tensor(x0),
                       maxiter=maxiter, M=tM)
    assert int(k) == want_k
    assert bool(torch.all(torch.isfinite(tx)))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-4,
                               atol=1e-5)
    if case == "early_stop":
        assert 0 < want_k < maxiter
    elif case == "maxiter":
        assert want_k == maxiter
    elif case == "b_zero":
        assert want_k == 0 and not tx.any()


def _sparsa_loop(f_ref, alpha, f_t, sq):
    """The reference's acceptance loop (sparsa.py:40-54) on the host, over
    precomputed trials."""
    a, it = np.float32(alpha), 0
    while (f_t[it] > np.float32(f_ref) - np.float32(1e-5) * a
           * np.float32(0.5) * sq[it]) and it < tsparsa.MAX_TRIES:
        a, it = a * np.float32(2.0), it + 1
    return it


def _l1_ls_loop(phi0, gdot, phi_t):
    """The reference's backtracking loop (l1_ls.py:76-85) on the host."""
    s, it = np.float32(1.0), 0
    while (phi_t[it] > np.float32(phi0) + np.float32(tl1.ALPHA) * s
           * np.float32(gdot)) and it < tl1.MAX_LS:
        s, it = s * np.float32(tl1.BETA_LS), it + 1
    return it


def _trials(rng, J, base):
    """Trial values around ``base``: random, with NaN and inf entries."""
    out = []
    for kind in ("random", "nan", "inf", "all_high", "first_ok"):
        v = (base + rng.normal(0.0, 1.0, J)).astype(np.float32)
        if kind == "nan":
            v[:J // 2] = base + 10.0
            v[J // 2] = np.nan
        elif kind == "inf":
            v[:J - 2] = np.inf
        elif kind == "all_high":
            v[:] = base + 10.0
        elif kind == "first_ok":
            v[0] = base - 10.0
        out.append(v)
    return out


def test_sparsa_step_picker_matches_the_loop():
    rng = np.random.default_rng(0)
    J = tsparsa.MAX_TRIES + 1
    for alpha in (1.0, 0.37, 5e3):
        a = (np.float32(alpha) * 2.0 ** np.arange(J)).astype(np.float32)
        sq = rng.uniform(0.0, 2.0, J).astype(np.float32)
        for f_t in _trials(rng, J, 3.0):
            j = tsparsa.accept_trial(torch.tensor(np.float32(3.0)),
                                     torch.tensor(a), torch.tensor(f_t),
                                     torch.tensor(sq))
            assert int(j) == _sparsa_loop(3.0, alpha, f_t, sq), (alpha, f_t)


def test_l1_ls_step_picker_matches_the_loop():
    rng = np.random.default_rng(1)
    J = tl1.MAX_LS + 1
    for phi0, gdot in ((5.0, -3.0), (5.0, 0.0), (np.inf, -1.0)):
        for phi_t in _trials(rng, J, 5.0 if np.isfinite(phi0) else 0.0):
            j = tl1.backtrack_step(torch.tensor(np.float32(phi0)),
                                   torch.tensor(np.float32(gdot)),
                                   torch.tensor(phi_t))
            assert int(j) == _l1_ls_loop(phi0, gdot, phi_t), (phi0, phi_t)


@pytest.mark.parametrize("x,s", [
    ([0.5, -2.0, 2.0, 1.0, -1.0, 0.0], 3),     # a tie at the threshold
    ([0.5, -2.0, 2.0, 1.0, -1.0, 0.0], 1),     # the top value is tied
    ([0.0, 3.0, 0.0, 0.0, -1.0, 0.0], 4),      # fewer than s nonzeros
    ([0.0, 0.0, 0.0], 2),
    ([0.3, -0.1, 0.2], 3)])
def test_hard_threshold_matches_jax(x, s):
    x = np.asarray(x, np.float32)
    got = tiht._hard_threshold(torch.tensor(x), s).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jiht._hard_threshold(jnp.asarray(x), s)))


def test_barrier_value_matches_jax(lasso):
    jp, tp = lasso
    rng = np.random.default_rng(2)
    x = rng.normal(0, 0.3, tp.d).astype(np.float32)
    for u in (np.abs(x) + 0.5, np.abs(x) - 1e-3):           # feasible, not
        u = u.astype(np.float32)
        want = float(jl1._barrier_value(jnp.asarray(x), jnp.asarray(u),
                                        jnp.float32(2.0), jp))
        got = float(tl1._barrier_value(torch.tensor(x), torch.tensor(u),
                                       torch.tensor(np.float32(2.0)), tp))
        if np.isinf(want):
            assert got == want
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5)


def test_smidas_link_matches_jax():
    for d in (2, 64, 2000):
        p = 2.0 * jnp.log(jnp.maximum(d, 3).astype(jnp.float32))
        assert float(tsmidas.link_q(d, "cpu")) == float(p / (p - 1.0))
    q = tsmidas.link_q(64, "cpu")
    theta = np.random.default_rng(3).normal(0, 1, 64).astype(np.float32)
    theta[5] = 0.0
    np.testing.assert_allclose(
        tsmidas._link_inv(torch.tensor(theta), q).numpy(),
        np.asarray(jsmidas._link_inv(jnp.asarray(theta), float(q))),
        rtol=1e-5, atol=1e-7)
    theta[7] = np.nan
    assert bool(torch.all(torch.isnan(tsmidas._link_inv(torch.tensor(theta),
                                                         q))))


def test_sign_propagates_nan_as_jnp():
    v = np.asarray([np.nan, -2.0, 0.0, 3.0], np.float32)
    np.testing.assert_array_equal(tcommon.sign(torch.tensor(v)).numpy(),
                                  np.asarray(jnp.sign(jnp.asarray(v))))


def test_baselines_refuse_what_the_reference_refuses(lasso, logreg):
    _, tl = logreg
    for solve in (lambda p: tb.gpsr_bb_solve(p, 2),
                  lambda p: tb.iht_solve(p, 3, 2),
                  lambda p: tb.fpc_as_solve(p, 1, 1, 1, L=1.0),
                  lambda p: tb.l1_ls_solve(p, 1, 1, 1)):
        with pytest.raises(ValueError, match="Lasso only"):
            solve(tl)
    _, tp = lasso
    sparse = tp._replace(A=tsp.BlockedCSC.from_dense(tp.A, device="cpu"))
    for solve in (lambda p: tb.fista_solve(p, 2, L=1.0),
                  lambda p: tb.sparsa_solve(p, 2),
                  lambda p: tb.sgd_solve(p, torch.Generator(), 0.1, 100)):
        with pytest.raises(TypeError, match="dense designs only"):
            solve(sparse)
    with pytest.raises(ValueError, match="idx shape"):
        tb.sgd_solve(tp, None, 0.1, 250, idx=np.zeros(250, np.int64))
    with pytest.raises(ValueError, match=r"\[0, 32\)"):
        tb.parallel_sgd_solve(tp, None, 0.1, 10, K=4,
                              idx=np.full((4, 10), 32))
    with pytest.raises(ValueError, match="Generator"):
        tb.smidas_solve(tp, None, 0.1, 100)


def test_generator_draws_repeat_and_run_on_the_problem_device(logreg):
    _, tp = logreg
    a, b = (tb.smidas_solve(tp, torch.Generator().manual_seed(9), 0.05, 300)
            for _ in range(2))
    assert torch.equal(a.x, b.x) and a.objective.shape == (3,)
    assert a.x.device == tp.A.device and a.x.dtype == torch.float32


def test_bf16_design_keeps_the_iterate_in_f32(lasso):
    _, tp = lasso
    res = tb.gpsr_bb_solve(tp._replace(A=tp.A.to(torch.bfloat16)), 20)
    assert res.x.dtype == torch.float32
    assert bool(torch.all(torch.isfinite(res.objective)))


# ---------------------------------------------------------------------------
# tests/test_baselines.py's behaviour, with the port's own F*
# ---------------------------------------------------------------------------

def test_fista(lasso, fstar):
    assert float(tb.fista_solve(lasso[1], 2000).objective[-1]) \
        <= fstar * 1.002 + 1e-4


def test_sparsa(lasso, fstar):
    assert float(tb.sparsa_solve(lasso[1], 2000).objective[-1]) \
        <= fstar * 1.005 + 1e-3


def test_gpsr(lasso, fstar):
    assert float(tb.gpsr_bb_solve(lasso[1], 2000).objective[-1]) \
        <= fstar * 1.005 + 1e-3


def test_fpc_as(lasso, fstar):
    assert float(tb.fpc_as_solve(lasso[1]).objective[-1]) \
        <= fstar * 1.005 + 1e-3


def test_l1_ls(lasso, fstar):
    assert float(tb.l1_ls_solve(lasso[1], outer=30).objective[-1]) \
        <= fstar * 1.01 + 1e-3


def test_iht_recovers_support():
    """Hard_l0 is for compressed sensing: exact-sparsity recovery, so check
    support recovery on a well-conditioned problem instead of F*."""
    A, y, xt = jsyn.singlepixcam(seed=1, n=256, d=128, nnz_frac=0.04)
    prob = tobj.make_problem(A, y, lam=0.0, normalize=False, device="cpu")
    s = int((np.abs(xt) > 0).sum())
    res = tb.iht_solve(prob, s=s, iters=500)
    got = set(np.nonzero(res.x.numpy())[0].tolist())
    want = set(np.nonzero(xt)[0].tolist())
    assert len(got & want) >= int(0.9 * len(want))


def _f0(prob):
    return float(tobj.objective(torch.zeros(prob.d), prob))


def test_sgd_logistic_decreases():
    """The paper's SGD protocol: 14 exponential rates, keep the best
    training objective (Sec. 4.2.2); here 7 rates, as the reference's
    test, at 5000 steps a rate (the reference's test: 20000)."""
    A, y, _ = jsyn.logistic_data(seed=2, n=512, d=64)
    prob = tobj.make_problem(A, y, lam=0.05, loss="logistic", device="cpu")
    best, rate = tb.sgd_rate_search(prob, torch.Generator().manual_seed(0),
                                    steps=5000,
                                    rates=np.geomspace(1e-3, 1.0, 7))
    assert float(best.objective[-1]) < 0.75 * _f0(prob)


def test_sgd_rate_search_picks_finite():
    A, y, _ = jsyn.logistic_data(seed=5, n=128, d=32)
    prob = tobj.make_problem(A, y, lam=0.05, loss="logistic", device="cpu")
    best, rate = tb.sgd_rate_search(prob, torch.Generator().manual_seed(0),
                                    steps=500,
                                    rates=np.geomspace(1e-3, 1.0, 5))
    assert np.isfinite(float(best.objective[-1]))
    assert 1e-3 <= rate <= 1.0


def test_parallel_sgd_averaging():
    A, y, _ = jsyn.logistic_data(seed=3, n=512, d=64)
    prob = tobj.make_problem(A, y, lam=0.05, loss="logistic", device="cpu")
    res = tb.parallel_sgd_solve(prob, torch.Generator().manual_seed(0),
                                eta=1.0, steps=20000, K=4)
    assert float(res.objective[-1]) < 0.8 * _f0(prob)


def test_smidas_decreases():
    A, y, _ = jsyn.logistic_data(seed=4, n=256, d=64)
    prob = tobj.make_problem(A, y, lam=0.05, loss="logistic", device="cpu")
    res = tb.smidas_solve(prob, torch.Generator().manual_seed(0), eta=0.05,
                          steps=4000)
    assert float(res.objective[-1]) < 0.8 * _f0(prob)


def test_shotgun_matches_proximal_optimum(lasso, fstar):
    res = shotgun_solve(lasso[1], torch.Generator().manual_seed(0),
                        spec=SolverSpec(P=16, rounds=1500))
    assert float(res.trace.objective[-1]) <= fstar * 1.005 + 1e-3
