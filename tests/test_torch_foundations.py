"""Port foundations against the JAX package on the same numpy inputs:
synthetic data, objectives, the health sentinel, SolverSpec, the
carry-across helpers, and the port's import purity (no JAX, no ``repro``)."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import health as jhealth  # noqa: E402
from repro.core import objectives as jobj  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.kernels import shotgun_block as jsb  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import health as thealth  # noqa: E402
from repro_torch.core import objectives as tobj  # noqa: E402
from repro_torch.core.shotgun import Result, Trace  # noqa: E402
from repro_torch.core.spec import SolverSpec, reject_legacy_kwargs  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.kernels import shotgun_block as tsb  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
# f32 elementwise maps and short reductions: the two frameworks agree to a
# few ulps; 1e-6 leaves room for a different summation order.
RTOL = 1e-6


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float32))


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("name,kw", [
    ("sparco", dict(seed=3, n=64, d=96)),
    ("sparco", dict(seed=4, n=64, d=96, corr=0.5)),
    ("singlepixcam", dict(seed=5, n=41, d=128)),
    ("logistic_data", dict(seed=6, n=80, d=64)),
    ("logistic_data", dict(seed=7, n=80, d=64, density=0.2)),
    ("sparse_imaging", dict(seed=8, n=60, d=200, density=0.05)),
    ("large_sparse", dict(seed=9, n=60, d=200, density=0.05)),
])
def test_synthetic_copy_is_bit_identical(name, kw):
    for a, b in zip(getattr(jsyn, name)(**kw), getattr(tsyn, name)(**kw)):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("loss", ["lasso", "logistic"])
def test_make_problem_matches_jax(loss):
    A, y, _ = (jsyn.sparco(seed=1, n=120, d=200) if loss == "lasso"
               else jsyn.logistic_data(seed=1, n=120, d=200))
    jp = jobj.make_problem(A, y, lam=0.3, loss=loss)
    tp = tobj.make_problem(A, y, lam=0.3, loss=loss, device="cpu")
    _close(tp.A, jp.A)
    _close(tp.scales, jp.scales)
    _close(tp.y, jp.y)
    _close(tp.lam, jp.lam)
    assert (tp.n, tp.d, tp.beta) == (jp.n, jp.d, jp.beta)
    _close(tobj.unscale_x(_t(np.ones(200)), tp.scales),
           jobj.unscale_x(jnp.ones(200), jp.scales))
    # normalize_columns on its own, with an all-zero column (scale -> 1)
    B = np.array(A, copy=True)
    B[:, 5] = 0.0
    for got, want in zip(tobj.normalize_columns(_t(B)),
                         jobj.normalize_columns(jnp.asarray(B))):
        _close(got, want)


@pytest.mark.parametrize("loss", ["lasso", "logistic"])
def test_objective_helpers_match_jax(loss):
    rng = np.random.default_rng(11)
    n = 257
    z = rng.standard_normal(n).astype(np.float32) * 3
    z[:6] = [80.0, -80.0, 30.0, -30.0, 15.0, -15.0]     # large |y·z|
    y = (np.where(rng.random(n) < 0.5, 1.0, -1.0) if loss == "logistic"
         else rng.standard_normal(n)).astype(np.float32)
    mask = (rng.random(n) < 0.9).astype(np.float32)
    _close(tobj.residual_like(_t(z), _t(y), loss),
           jobj.residual_like(jnp.asarray(z), jnp.asarray(y), loss))
    _close(tobj.masked_data_loss(_t(z), _t(y), _t(mask), loss),
           jobj.masked_data_loss(jnp.asarray(z), jnp.asarray(y),
                                 jnp.asarray(mask), loss))
    A = rng.standard_normal((n, 64)).astype(np.float32)
    _close(tobj.lambda_max(_t(A), _t(y), loss),
           jobj.lambda_max(jnp.asarray(A), jnp.asarray(y), loss))
    v = np.concatenate([z, [np.nan, np.inf, -np.inf, 0.0]]).astype(np.float32)
    _close(tobj.soft_threshold(_t(v), 0.7),
           jobj.soft_threshold(jnp.asarray(v), 0.7))


def test_stable_logistic_tile_matches_jax():
    rng = np.random.default_rng(12)
    z = np.concatenate([rng.standard_normal(200) * 4,
                        [88.0, -88.0, 40.0, -40.0, 0.0]]).astype(np.float32)
    y = np.where(rng.random(z.size) < 0.5, 1.0, -1.0).astype(np.float32)
    # atol 1e-30: at |m| = 88 the curvature weight is a denormal (~6e-39)
    # that XLA on the CPU flushes to zero and torch keeps.
    for got, want in zip(tsb._stable_logistic_tile(_t(z), _t(y)),
                         jsb._stable_logistic_tile(jnp.asarray(z),
                                                   jnp.asarray(y))):
        _close(got, want, atol=1e-30)
    m = (rng.random(z.size) < 0.8).astype(np.float32)
    for name in ("lasso", "logistic_newton"):
        tl, jl = tsb.resolve_loss(name), jsb.resolve_loss(name)
        for meth in ("residual", "curvature_weights", "data_loss"):
            _close(getattr(tl, meth)(_t(z), _t(y), _t(m)),
                   getattr(jl, meth)(jnp.asarray(z), jnp.asarray(y),
                                     jnp.asarray(m)), atol=1e-30)
    with pytest.raises(ValueError, match="unknown loss"):
        tsb.resolve_loss("hinge")


def test_logistic_label_rejection():
    A = np.ones((4, 2), np.float32)
    y = np.array([1.0, -1.0, 0.0, 2.0], np.float32)
    with pytest.raises(ValueError, match="logistic labels"):
        tobj.make_problem(A, y, 0.1, loss="logistic", device="cpu")
    with pytest.raises(ValueError, match="logistic labels"):
        convert.problem_from_numpy(A, y, 0.1, "logistic", device="cpu")
    tobj.make_problem(A, y, 0.1, loss="lasso", device="cpu")


_SENTINEL_CASES = {
    "improve": dict(f_new=9.0, f_good=10.0, health=None),
    "mild_rise": dict(f_new=11.0, f_good=10.0, health=None),
    "guard_trip": dict(f_new=500.0, f_good=10.0, health=None),
    "nan": dict(f_new=np.nan, f_good=10.0, health=None),
    "inf": dict(f_new=np.inf, f_good=10.0, health=0.0),
    "health_flag": dict(f_new=9.0, f_good=10.0, health=1.0),
}


@pytest.mark.parametrize("case", sorted(_SENTINEL_CASES))
def test_apply_sentinel_matches_jax(case):
    c = _SENTINEL_CASES[case]
    rng = np.random.default_rng(13)
    xg, zg, xn, zn = (rng.standard_normal(16).astype(np.float32)
                      for _ in range(4))
    kw = dict(factor=10.0, p_floor=2)
    jgs = jhealth.init_guard_state(jnp.asarray(xg), jnp.asarray(zg),
                                   c["f_good"], 8)
    tgs = thealth.init_guard_state(_t(xg), _t(zg), c["f_good"], 8)
    jh = None if c["health"] is None else jnp.float32(c["health"])
    th = None if c["health"] is None else torch.tensor(c["health"])
    jout = jhealth.apply_sentinel(jgs, jnp.asarray(xn), jnp.asarray(zn),
                                  jnp.float32(c["f_new"]), health=jh, **kw)
    tout = thealth.apply_sentinel(tgs, _t(xn), _t(zn),
                                  torch.tensor(c["f_new"]), health=th, **kw)
    for a, b in zip(jax_leaves(jout), torch_leaves(tout)):
        np.testing.assert_array_equal(b, a)


def jax_leaves(out):
    x, z, f, gs, bad = out
    return [np.asarray(v) for v in (x, z, f, *gs, bad)]


def torch_leaves(out):
    x, z, f, gs, bad = out
    return [v.numpy() for v in (x, z, f, *gs, bad)]


@pytest.mark.parametrize("trace,backoffs", [
    ([10.0, 5.0, 2.0], None),
    ([10.0, 5.0, 2.0], 3),
    ([10.0, np.nan, 2.0], 1),
    ([10.0, 5.0, 1e6], None),
    ([10.0, 5.0, 1e6], 2),
    ([np.inf, 5.0, 2.0], 0),
])
def test_status_from_trace_matches_jax(trace, backoffs):
    tr = np.asarray(trace, np.float32)
    jb = None if backoffs is None else jnp.int32(backoffs)
    tb = None if backoffs is None else torch.tensor(backoffs,
                                                    dtype=torch.int32)
    want = jhealth.status_from_trace(jnp.asarray(tr), jb)
    got = thealth.status_from_trace(_t(tr), tb)
    assert int(got) == int(want)
    assert got.dtype == torch.int32


def test_live_mask_and_guard_threshold_match_jax():
    for p in (0, 3, 8):
        np.testing.assert_array_equal(
            thealth.live_mask(8, torch.tensor(p)).numpy(),
            np.asarray(jhealth.live_mask(8, jnp.int32(p))))
    _close(thealth.guard_threshold(torch.tensor(-4.0), 10.0),
           jhealth.guard_threshold(jnp.float32(-4.0), 10.0))
    assert float(thealth.nonfinite_flag(torch.ones(3),
                                        torch.tensor([np.nan]))) == 1.0


def test_solver_spec_validation():
    with pytest.raises(ValueError, match="newton"):
        SolverSpec(loss="logistic", newton=True)
    with pytest.raises(ValueError, match="P >= 1"):
        SolverSpec(P=0)
    with pytest.raises(ValueError, match="rounds >= 1"):
        SolverSpec(rounds=0)
    spec = SolverSpec(loss="logistic", P=256, rounds=8, fused=True,
                      newton=True, guard=thealth.GuardConfig(5.0, 2))
    spec.check_loss("logistic")
    with pytest.raises(ValueError) as ei:
        spec.check_loss("lasso")
    assert "logistic" in str(ei.value) and "lasso" in str(ei.value)
    reject_legacy_kwargs(None, K=1)
    reject_legacy_kwargs(spec, K=None, rounds=None)
    with pytest.raises(ValueError, match="not both"):
        reject_legacy_kwargs(spec, K=1)


def test_problem_and_result_round_trip():
    A, y, _ = jsyn.logistic_data(seed=2, n=40, d=30)
    jp = jobj.make_problem(A, y, lam=0.2, loss="logistic")
    tp = convert.problem_from_numpy(np.asarray(jp.A), np.asarray(jp.y),
                                    float(jp.lam), jp.loss,
                                    scales=np.asarray(jp.scales),
                                    device="cpu")
    for a, b in ((tp.A, jp.A), (tp.y, jp.y), (tp.lam, jp.lam),
                 (tp.scales, jp.scales)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tp.loss == "logistic" and tp.beta == 0.25
    res = Result(x=torch.arange(3.0), z=torch.ones(2),
                 trace=Trace(objective=torch.tensor([2.0, 1.0]),
                             nnz=torch.tensor([1, 2], dtype=torch.int32)),
                 status=torch.tensor(0, dtype=torch.int32))
    out = convert.result_to_numpy(res)
    np.testing.assert_array_equal(out.x, [0.0, 1.0, 2.0])
    np.testing.assert_array_equal(out.trace.nnz, [1, 2])
    assert isinstance(out.trace.objective, np.ndarray) and out.status == 0


def test_entry_points_default_to_the_card():
    """The default device is CUDA; without a card it raises instead of
    carrying on quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card path is not "
                    "reachable here")
    A = np.ones((4, 2), np.float32)
    y = np.ones(4, np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        tobj.make_problem(A, y, 0.1)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.problem_from_numpy(A, y, 0.1, "lasso")
    with pytest.raises(RuntimeError, match="cuda"):
        tsyn.sparco_on_device(n=8, d=4)


def test_port_imports_no_jax_and_nothing_of_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 26     # every module was imported
