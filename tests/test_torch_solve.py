"""``block_shotgun_solve`` of the port against the JAX package's on the same
normalized problem (carried across with ``convert``) and the same block
draws (the JAX solver's own threefry stream, via ``batched_draw_blocks``):
the fused path for lasso / logistic / Newton, the two-kernel path, the
guarded path far beyond P*, and the interface rejections.

Tolerances: F trace rtol 1e-4, nnz trace exact, x rtol/atol 1e-4 (as
tests/test_fused_kernels.py:133 holds x; entries of the normalized sparco
solution reach ~90, so an absolute bound alone would ask for 1e-6
relative).  JAX holds its fused path against its own two-kernel path at
rtol 2e-5; across frameworks the f32 sums (A_Bᵀr over n, Σ|x|, the loss)
run in another order, and those last-bit differences compound over the
rounds, so the bound is 1e-4."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import objectives as jobj  # noqa: E402
from repro.core.health import GuardConfig as JGuard  # noqa: E402
from repro.core.spec import SolverSpec as JSpec  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.batched import batched_draw_blocks  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import health as thealth  # noqa: E402
from repro_torch.core.spec import SolverSpec  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

BLOCK = 128


def _problems(loss, seed=6, n=300, d=500, lam=None):
    """Convergent fixtures by default: at P = 256 the lasso problem needs
    λ = 5 to descend (at λ = 1 F grows 400× in 16 rounds, and a divergent
    trajectory amplifies last-bit differences chaotically)."""
    if lam is None:
        lam = 5.0 if loss == "lasso" else 1.0
    A, y, _ = (jsyn.sparco(seed=seed, n=n, d=d) if loss == "lasso"
               else jsyn.logistic_data(seed=seed, n=n, d=d))
    jp = jobj.make_problem(A, y, lam=lam, loss=loss)
    tp = convert.problem_from_numpy(np.asarray(jp.A), np.asarray(jp.y),
                                    float(jp.lam), loss,
                                    scales=np.asarray(jp.scales),
                                    device="cpu")
    return jp, tp


def _jax_draws(key, rounds, K, d):
    """The block indices JAX's _solve/_fused_solve draw from ``key``."""
    nblk = -(-d // BLOCK)
    keys = jax.random.split(key, rounds)[None]
    return np.asarray(batched_draw_blocks(keys, K, nblk))[0]


def _assert_solves_close(tres, jres):
    t = convert.result_to_numpy(tres)
    np.testing.assert_allclose(t.trace.objective,
                               np.asarray(jres.trace.objective), rtol=1e-4)
    np.testing.assert_array_equal(t.trace.nnz, np.asarray(jres.trace.nnz))
    np.testing.assert_allclose(t.x, np.asarray(jres.x), rtol=1e-4,
                               atol=1e-4)
    assert t.x.shape == np.asarray(jres.x).shape
    assert t.z.shape == np.asarray(jres.z).shape
    assert int(t.status) == int(jres.status)


@pytest.mark.parametrize("loss,newton", [("lasso", False),
                                         ("logistic", False),
                                         ("logistic", True)])
def test_fused_solve_matches_jax(loss, newton):
    jp, tp = _problems(loss)
    key = jax.random.PRNGKey(0)
    kw = dict(loss=loss, P=256, rounds=16, fused=True, newton=newton)
    jres = jops.block_shotgun_solve(jp, key, spec=JSpec(**kw))
    tres = tops.block_shotgun_solve(
        tp, spec=SolverSpec(**kw), blk_idx=_jax_draws(key, 16, 2, jp.d))
    _assert_solves_close(tres, jres)


@pytest.mark.parametrize("loss", ["lasso", "logistic"])
def test_two_kernel_solve_matches_jax(loss):
    jp, tp = _problems(loss)
    key = jax.random.PRNGKey(1)
    kw = dict(loss=loss, P=256, rounds=12)
    jres = jops.block_shotgun_solve(jp, key, spec=JSpec(**kw))
    tres = tops.block_shotgun_solve(
        tp, spec=SolverSpec(**kw), blk_idx=_jax_draws(key, 12, 2, jp.d))
    _assert_solves_close(tres, jres)


def _rolled_back_launches(trace, R):
    """Launches whose R trace entries are all the snapshot objective — what
    a sentinel trip leaves in the trace (one per backoff)."""
    f = np.asarray(trace).reshape(-1, R)
    return int(np.sum(np.all(f == f[:, :1], axis=1)))


@pytest.mark.parametrize("fused", [True, False])
def test_guarded_solve_far_beyond_pstar_matches_jax(fused):
    """d ≫ n puts P* at ~1 coordinate; K = 16 blocks (P = 2048) diverges
    unguarded.  Both packages must back off the same number of times, end
    RECOVERED, and keep the trace finite."""
    jp, tp = _problems("lasso", seed=0, n=256, d=2048, lam=1.0)
    key = jax.random.PRNGKey(0)
    rounds = 48 if fused else 32
    kw = dict(loss="lasso", P=16 * BLOCK, rounds=rounds, fused=fused,
              guard=None)
    draws = _jax_draws(key, rounds, 16, jp.d)
    jres = jops.block_shotgun_solve(
        jp, key, spec=JSpec(**{**kw, "guard": JGuard(10.0, 1)}))
    tres = tops.block_shotgun_solve(
        tp, spec=SolverSpec(**{**kw, "guard": thealth.GuardConfig(10.0, 1)}),
        blk_idx=draws)
    f = tres.trace.objective
    assert torch.all(torch.isfinite(f))
    assert int(tres.status) == int(jres.status) == thealth.STATUS_RECOVERED
    if fused:
        n_t = _rolled_back_launches(f.numpy(), 8)
        assert n_t == _rolled_back_launches(jres.trace.objective, 8) > 0
    unguarded = tops.block_shotgun_solve(tp, spec=SolverSpec(**kw),
                                         blk_idx=draws)
    assert int(unguarded.status) == thealth.STATUS_DIVERGED


def test_default_draws_are_distinct_blocks_from_the_generator():
    _, tp = _problems("lasso", n=128, d=1024)
    spec = SolverSpec(loss="lasso", P=4 * BLOCK, rounds=8, fused=True)
    g = torch.Generator().manual_seed(5)
    a = tops.block_shotgun_solve(tp, g, spec=spec)
    b = tops.block_shotgun_solve(tp, torch.Generator().manual_seed(5),
                                 spec=spec)
    assert torch.equal(a.x, b.x) and torch.equal(a.trace.objective,
                                                 b.trace.objective)
    idx = tops._block_stream(None, torch.Generator().manual_seed(5), 8, 4, 8,
                             "cpu")
    assert idx.dtype == torch.int32 and idx.shape == (8, 4)
    assert all(len(set(row.tolist())) == 4 for row in idx)
    # the same stream through blk_idx reproduces the generator's solve
    c = tops.block_shotgun_solve(tp, spec=spec, blk_idx=idx)
    assert torch.equal(a.x, c.x)


def test_fused_alias_and_warm_start_match_jax():
    jp, tp = _problems("lasso", seed=2)
    key = jax.random.PRNGKey(3)
    x0 = np.random.default_rng(0).standard_normal(jp.d).astype(np.float32)
    x0 *= 0.05
    jres = jops.fused_block_shotgun_solve(
        jp, key, x0=jax.numpy.asarray(x0),
        spec=JSpec(loss="lasso", P=128, rounds=8))
    tres = tops.fused_block_shotgun_solve(
        tp, spec=SolverSpec(loss="lasso", P=128, rounds=8),
        blk_idx=_jax_draws(key, 8, 1, jp.d), x0=torch.tensor(x0))
    _assert_solves_close(tres, jres)


def test_solve_rejections():
    _, tp = _problems("lasso", n=128, d=256)
    idx = np.zeros((8, 1), np.int32)
    with pytest.raises(ValueError, match="newton"):
        SolverSpec(loss="lasso", P=128, rounds=8, newton=True)
    with pytest.raises(ValueError) as ei:
        tops.block_shotgun_solve(tp, spec=SolverSpec(loss="logistic", P=128,
                                                     rounds=8), blk_idx=idx)
    assert "logistic" in str(ei.value) and "lasso" in str(ei.value)
    with pytest.raises(ValueError, match="rounds_per_launch"):
        tops.block_shotgun_solve(tp, spec=SolverSpec(P=128, rounds=9,
                                                     fused=True),
                                 blk_idx=np.zeros((9, 1), np.int32))
    with pytest.raises(TypeError, match="spec"):
        tops.block_shotgun_solve(tp)
    with pytest.raises(ValueError, match=r"\[0, 2\)"):
        tops.block_shotgun_solve(tp, spec=SolverSpec(P=128, rounds=8),
                                 blk_idx=idx + 2)
    with pytest.raises(ValueError, match="shape"):
        tops.block_shotgun_solve(tp, spec=SolverSpec(P=128, rounds=8),
                                 blk_idx=np.zeros((8, 2), np.int32))
    with pytest.raises(ValueError, match="Generator"):
        tops.block_shotgun_solve(tp, spec=SolverSpec(P=128, rounds=8))


def _rounds_to(f, fstar, tol):
    hits = np.nonzero((f - fstar) / abs(fstar) <= tol)[0]
    return int(hits[0]) if hits.size else len(f)


def test_newton_beats_gradient_rounds_to_tolerance():
    """Per-block Newton (Bian et al.): with the true curvature
    h = Σ a²σ(1−σ) instead of β = 1/4 the port reaches the same target in
    fewer rounds on a well-conditioned problem (tests/test_logreg_fused.py
    :135, on the port's own generator draws)."""
    _, prob = _problems("logistic", seed=6, n=600, d=256, lam=0.5)
    kw = dict(loss="logistic", P=256, rounds=64, fused=True)
    rg = tops.block_shotgun_solve(prob, torch.Generator().manual_seed(0),
                                  spec=SolverSpec(**kw))
    rn = tops.block_shotgun_solve(prob, torch.Generator().manual_seed(0),
                                  spec=SolverSpec(**kw, newton=True))
    fg, fn = rg.trace.objective.numpy(), rn.trace.objective.numpy()
    fstar = min(fg.min(), fn.min())
    assert _rounds_to(fn, fstar, 0.005) < _rounds_to(fg, fstar, 0.005)


def test_logistic_beta_quarter_descends_at_one_block():
    """β = 1/4 (Eq. 6) keeps the fused logistic solve descending at K = 1
    (P = 128) on an n > d design."""
    _, tp = _problems("logistic", seed=5, n=800, d=512, lam=0.5)
    r = tops.block_shotgun_solve(tp, torch.Generator().manual_seed(0),
                                 spec=SolverSpec(loss="logistic", P=BLOCK,
                                                 rounds=200, fused=True))
    f = r.trace.objective
    assert torch.all(torch.isfinite(f)) and float(f[-1]) < float(f[0])
    assert int(r.status) == thealth.STATUS_OK
