"""The port's Shotgun-CDN / Shooting-CDN (``repro_torch.core.cdn``) against
the JAX package's on the same problems and the same draws, and the
behaviour tests/test_cdn.py holds, at these small sizes.

The reference's active set draws with ``jax.random.categorical`` over
logits that depend on the iterate, which an external stream cannot fix, so
the traces are held at ``active_set=False``: the draws are then
``categorical`` over zero logits from the first half of each round's key
split, rebuilt here and handed to the port as ``idx``.  The active-set run
is held at the optimum.  F* comes from the reference's ``fista_solve``.

Tolerances: F traces rtol 1e-4, nnz exact, x rtol/atol 1e-4."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cdn as jcdn  # noqa: E402
from repro.core import objectives as jobj  # noqa: E402
from repro.core.baselines.fista import fista_solve  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import cdn as tcdn  # noqa: E402
from repro_torch.core import shotgun as tshot  # noqa: E402


def port_problem(jp):
    return convert.problem_from_numpy(
        np.asarray(jp.A), np.asarray(jp.y), float(jp.lam), jp.loss,
        scales=np.asarray(jp.scales), device="cpu")


def cdn_draws(key, rounds, P, d):
    """The draws of ``shotgun_cdn_solve(active_set=False)`` from ``key``."""
    keys = jax.random.split(key, rounds)
    return np.asarray(jax.vmap(lambda k: jax.random.categorical(
        jax.random.split(k)[0], jnp.zeros(d), shape=(P,)))(keys))


@pytest.fixture(scope="module")
def logreg():
    A, y, _ = jsyn.logistic_data(seed=0, n=256, d=32)
    jp = jobj.make_problem(A, y, lam=0.1, loss="logistic")
    return jp, port_problem(jp), float(fista_solve(jp, 6000).objective[-1])


@pytest.mark.parametrize("loss,P", [("lasso", 8), ("logistic", 8),
                                    ("logistic", 1)])
def test_cdn_matches_jax(loss, P):
    A, y, _ = (jsyn.sparco(seed=2, n=200, d=96) if loss == "lasso"
               else jsyn.logistic_data(seed=2, n=200, d=96))
    jp = jobj.make_problem(A, y, lam=0.5, loss=loss)
    key = jax.random.PRNGKey(1)
    rounds = 80
    jres = jcdn.shotgun_cdn_solve(jp, key, P=P, rounds=rounds,
                                  active_set=False)
    tres = tcdn.shotgun_cdn_solve(port_problem(jp), P=P, rounds=rounds,
                                  idx=cdn_draws(key, rounds, P, 96),
                                  active_set=False)
    t = convert.result_to_numpy(tres)
    np.testing.assert_allclose(t.trace.objective,
                               np.asarray(jres.trace.objective), rtol=1e-4)
    np.testing.assert_array_equal(t.trace.nnz, np.asarray(jres.trace.nnz))
    np.testing.assert_allclose(t.x, np.asarray(jres.x), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t.z, np.asarray(jres.z), rtol=1e-4, atol=1e-4)
    assert int(t.status) == int(jres.status)


def _loop_step(f0, decrease, trial):
    """The reference's ``while_loop`` (cdn.py:80-92) on the host."""
    a, it = 1.0, 0
    f_t = trial(0)
    while f_t > f0 + tcdn.ARMIJO_SIGMA * a * decrease \
            and it < tcdn.MAX_BACKTRACK:
        a, it = a * 0.5, it + 1
        f_t = trial(it)
    if f_t <= f0 + tcdn.ARMIJO_SIGMA * a * decrease:
        return a, f_t
    return 0.0, f0


@pytest.mark.parametrize("case", ["first", "third", "last", "none", "nan",
                                  "nan_decrease"])
def test_armijo_step_selects_the_loops_alpha(case):
    J = tcdn.MAX_BACKTRACK + 1
    alphas = 0.5 ** np.arange(J)
    f0, dec = np.float32(10.0), np.float32(-4.0)
    level = f0 + tcdn.ARMIJO_SIGMA * alphas * dec
    f_t = level + 1.0                                   # every trial fails
    if case == "first":
        f_t[0] = level[0] - 0.5
    elif case == "third":
        f_t[2:] = level[2:] - 0.01
    elif case == "last":
        f_t[-1] = level[-1] - 1e-3
    elif case == "nan":
        f_t[3] = np.nan                  # the loop stops there, refuses
        f_t[4:] = level[4:] - 1.0
    elif case == "nan_decrease":
        dec = np.float32(np.nan)
    f_t = f_t.astype(np.float32)
    want = _loop_step(float(f0), float(dec), lambda j: float(f_t[j]))
    alpha, f = tcdn.armijo_step(torch.tensor(f0), torch.tensor(dec),
                                torch.tensor(f_t))
    assert float(alpha) == want[0]
    assert float(f) == pytest.approx(want[1], rel=1e-6)


def test_repeat_is_bit_identical_with_duplicate_draws(logreg):
    _, tp, _ = logreg
    idx = torch.randint(0, 32, (40, 24),
                        generator=torch.Generator().manual_seed(0))
    runs = [tcdn.shotgun_cdn_solve(tp, P=24, rounds=40, idx=idx.clone(),
                                   active_set=False) for _ in range(2)]
    runs += [tcdn.shotgun_cdn_solve(tp, torch.Generator().manual_seed(4),
                                    P=24, rounds=40) for _ in range(2)]
    for a, b in (runs[:2], runs[2:]):
        assert torch.equal(a.x.view(torch.int32), b.x.view(torch.int32))
        assert torch.equal(a.trace.objective, b.trace.objective)


def test_interface_rejections(logreg):
    _, tp, _ = logreg
    with pytest.raises(ValueError, match="active_set=False"):
        tcdn.shotgun_cdn_solve(tp, P=2, rounds=2,
                               idx=np.zeros((2, 2), np.int64))
    with pytest.raises(ValueError, match="Generator"):
        tcdn.shotgun_cdn_solve(tp, P=2, rounds=2)
    S, y, _ = jsyn.large_sparse(seed=0, n=64, d=128, density=0.05,
                                layout="bcsc")
    sp = convert.problem_from_numpy(
        convert.bcsc_from_numpy(S.rows, S.vals, S.n, S.d, device="cpu"), y,
        0.5, "lasso", device="cpu")
    with pytest.raises(TypeError, match="dense"):
        tcdn.shotgun_cdn_solve(sp, torch.Generator(), P=2, rounds=2)


# ---------------------------------------------------------------------------
# Behaviour (tests/test_cdn.py at these sizes)
# ---------------------------------------------------------------------------

def test_shooting_cdn_converges(logreg):
    _, tp, fstar = logreg
    res = tcdn.shooting_cdn_solve(tp, torch.Generator().manual_seed(0),
                                  rounds=200)
    assert float(res.trace.objective[-1]) <= fstar * 1.005 + 1e-3


def test_shotgun_cdn_converges(logreg):
    _, tp, fstar = logreg
    res = tcdn.shotgun_cdn_solve(tp, torch.Generator().manual_seed(0), P=8,
                                 rounds=100)
    assert float(res.trace.objective[-1]) <= fstar * 1.005 + 1e-3


def test_cdn_faster_than_fixed_step_in_iterations(logreg):
    """Yuan et al. (2010): Newton + line search beats the β = 1/4 fixed
    step per iteration on logistic regression."""
    _, tp, fstar = logreg
    t_cdn = int(tshot.rounds_to_tolerance(tcdn.shooting_cdn_solve(
        tp, torch.Generator().manual_seed(1), rounds=200).trace.objective,
        fstar, rel_tol=0.01))
    t_fix = int(tshot.rounds_to_tolerance(tshot.shooting_solve(
        tp, torch.Generator().manual_seed(1), rounds=200).trace.objective,
        fstar, rel_tol=0.01))
    assert t_cdn < t_fix


def test_shotgun_cdn_parallel_speedup(logreg):
    _, tp, fstar = logreg
    t1 = int(tshot.rounds_to_tolerance(tcdn.shooting_cdn_solve(
        tp, torch.Generator().manual_seed(2), rounds=200).trace.objective,
        fstar, rel_tol=0.01))
    t8 = int(tshot.rounds_to_tolerance(tcdn.shotgun_cdn_solve(
        tp, torch.Generator().manual_seed(2), P=8, rounds=200)
        .trace.objective, fstar, rel_tol=0.01))
    assert t8 < t1 * 0.7


def test_active_set_does_not_change_optimum(logreg):
    _, tp, fstar = logreg
    for active in (True, False):
        res = tcdn.shotgun_cdn_solve(tp, torch.Generator().manual_seed(3),
                                     P=4, rounds=200, active_set=active)
        assert float(res.trace.objective[-1]) <= fstar * 1.01 + 1e-3
