"""The port's round engines and what they run, on the CPU, against the JAX
package on the same numpy inputs and draws: the Δz-emitting fused kernels
(dense and BlockedCSC; their plain versions against the Pallas kernels in
interpret mode and the ``ref.py`` delta oracles), the five engines' ``run``
on one shard's columns, ``shooting_delta``, the BlockedCSC column-block
slice, the wire compression and the checkpoint store.

Tolerances (as tests/test_torch_sparse.py's): x rtol/atol 1e-4, dz 1e-3
(a sum over R rounds of contributions taken in another order), health
exact; bf16 storage 1e-3 against JAX fed the same rounded A.  Compression elementwise
1e-6 (int8 is deterministic rounding of the same quotients; bf16 a cast);
``wire_bytes`` exact."""
import pathlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.core import engines as jeng  # noqa: E402
from repro.core import objectives as jobj  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.dist import compression as jcomp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import shotgun_block as jsb  # noqa: E402
from repro.kernels import shotgun_sparse as jss  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.ckpt import checkpoint as tckpt  # noqa: E402
from repro_torch.core import engines as teng  # noqa: E402
from repro_torch.core import objectives as tobj  # noqa: E402
from repro_torch.dist import compression as tcomp  # noqa: E402
from repro_torch.dist import faults as tfaults  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import shotgun_block as tsb  # noqa: E402
from repro_torch.kernels import shotgun_sparse as tss  # noqa: E402

BLOCK = 128
R, K = 8, 2
LOSSES = ["lasso", "logistic", "logistic_newton"]


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _name(loss):
    return "lasso" if loss == "lasso" else "logistic"


def _dense(loss, seed=0, n=300, d=500, lam=0.4):
    """JAX-side padded dense problem as numpy (n, d not divisible)."""
    A, y, _ = (jsyn.sparco(seed=seed, n=n, d=d) if _name(loss) == "lasso"
               else jsyn.logistic_data(seed=seed, n=n, d=d))
    prob = jobj.make_problem(A, y, lam=lam, loss=_name(loss))
    Ap, yp, mask = jops.pad_problem(prob.A, prob.y)
    return dict(A=np.asarray(Ap), y=np.asarray(yp), mask=np.asarray(mask),
                lam=float(prob.lam), beta=prob.beta)


def _sparse(loss, seed=0, n=256, d=512, lam=0.5):
    category = "large_sparse" if _name(loss) == "lasso" else "logistic_data"
    density = 0.02 if category == "large_sparse" else 0.05
    S, y, _ = getattr(jsyn, category)(seed=seed, n=n, d=d, density=density,
                                      layout="bcsc")
    jp = jobj.make_problem(S, y, lam=lam, loss=_name(loss))
    return jp, convert.bcsc_from_numpy(np.asarray(jp.A.rows),
                                       np.asarray(jp.A.vals), jp.A.n,
                                       jp.A.d, device="cpu")


def _draws(nblk, seed=2, rounds=R, k=K):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, nblk, (rounds, k)).astype(np.int32)
    idx[rounds // 2, -1] = idx[rounds // 2, 0]     # duplicate draw
    return idx


def _x0(width, seed=1, scale=0.1, real=None):
    x = (np.random.default_rng(seed).standard_normal(width) * scale
         ).astype(np.float32)
    if real is not None:
        x[real:] = 0.0
    return x


def _close(got, want, tol_x=1e-4, tol_dz=1e-3):
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               rtol=tol_x, atol=tol_x)
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               rtol=tol_dz, atol=tol_dz)


# ---------------------------------------------------------------------------
# Kernel #7: fused_shotgun_delta_rounds (dense)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("loss", LOSSES)
def test_fused_delta_matches_jax_and_oracles(loss, store):
    p = _dense(loss)
    A = p["A"].astype(ml_dtypes.bfloat16) if store == "bf16" else p["A"]
    A32 = np.asarray(A, np.float32)
    x = _x0(A.shape[1])
    z = A32 @ x
    idx = _draws(A.shape[1] // BLOCK)
    args_j = (jnp.asarray(A), jnp.asarray(z), jnp.asarray(x),
              jnp.asarray(idx), p["lam"], p["beta"], jnp.asarray(p["y"]),
              jnp.asarray(p["mask"]))
    At = _t(A32, torch.bfloat16) if store == "bf16" else _t(A32)
    args_t = (At, _t(z), _t(x), torch.tensor(idx), p["lam"], p["beta"],
              _t(p["y"]), _t(p["mask"]))
    jout = jsb.fused_shotgun_delta_rounds(*args_j, loss=loss, interpret=True)
    tout = tsb.fused_shotgun_delta_rounds(*args_t, loss=loss)
    tol = 1e-3 if store == "bf16" else 1e-4
    _close(tout, jout, tol, 1e-3)
    assert float(tout[2]) == float(jout[2]) == 0.0
    rout = tref.fused_shotgun_delta_rounds_ref(*args_t, loss, BLOCK)
    jrout = jref.fused_shotgun_delta_rounds_ref(*args_j, loss, BLOCK)
    _close(rout, jrout, tol, 1e-3)
    _close(tout, rout)


@pytest.mark.parametrize("loss", ["lasso", "logistic_newton"])
def test_fused_delta_k_eff(loss):
    """k_eff = K is bit-exact with no mask; k_eff = K − 1 matches JAX."""
    p = _dense(loss)
    x = _x0(p["A"].shape[1])
    z = p["A"] @ x
    idx = _draws(p["A"].shape[1] // BLOCK)
    args_t = (_t(p["A"]), _t(z), _t(x), torch.tensor(idx), p["lam"],
              p["beta"], _t(p["y"]), _t(p["mask"]))
    a = tsb.fused_shotgun_delta_rounds(*args_t, loss=loss)
    b = tsb.fused_shotgun_delta_rounds(*args_t, loss=loss,
                                       k_eff=torch.tensor(K, dtype=torch.int32))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    got = tsb.fused_shotgun_delta_rounds(*args_t, loss=loss, k_eff=K - 1)
    want = jsb.fused_shotgun_delta_rounds(
        jnp.asarray(p["A"]), jnp.asarray(z), jnp.asarray(x),
        jnp.asarray(idx), p["lam"], p["beta"], jnp.asarray(p["y"]),
        jnp.asarray(p["mask"]), loss=loss, interpret=True, k_eff=K - 1)
    _close(got, want)


def test_fused_delta_nan_iterate_trips_health():
    p = _dense("lasso")
    x = _x0(p["A"].shape[1])
    idx = _draws(p["A"].shape[1] // BLOCK)
    x[int(idx[0, 0]) * BLOCK + 3] = np.nan
    z = np.zeros(p["A"].shape[0], np.float32)
    tout = tsb.fused_shotgun_delta_rounds(
        _t(p["A"]), _t(z), _t(x), torch.tensor(idx), p["lam"], p["beta"],
        _t(p["y"]), _t(p["mask"]))
    jout = jsb.fused_shotgun_delta_rounds(
        jnp.asarray(p["A"]), jnp.asarray(z), jnp.asarray(x),
        jnp.asarray(idx), p["lam"], p["beta"], jnp.asarray(p["y"]),
        jnp.asarray(p["mask"]), interpret=True)
    assert float(tout[2]) == float(jout[2]) == 1.0


def test_fused_delta_equals_margin_owning_kernel():
    """Δz of the delta kernel is the margin-owning kernel's z − z0, and x
    agrees bit for bit (same δ arithmetic on the same view)."""
    p = _dense("logistic_newton")
    x = _x0(p["A"].shape[1])
    z = p["A"] @ x
    idx = _draws(p["A"].shape[1] // BLOCK)
    args = (_t(p["A"]), _t(z), _t(x), torch.tensor(idx), p["lam"], p["beta"],
            _t(p["y"]), _t(p["mask"]))
    xd, dz, _ = tsb.fused_shotgun_delta_rounds(*args, loss="logistic_newton")
    xf, zf, *_ = tsb.fused_shotgun_rounds(*args, loss="logistic_newton")
    assert torch.equal(xd, xf)
    torch.testing.assert_close(dz, zf - _t(z), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Kernel #8: fused_sparse_shotgun_delta_rounds (BlockedCSC)
# ---------------------------------------------------------------------------

def _sparse_inputs(jp, store):
    S = jp.A if store == "f32" else jp.A.astype(jnp.bfloat16)
    T = convert.bcsc_from_numpy(np.asarray(S.rows), np.asarray(S.vals), S.n,
                                S.d, device="cpu")
    x = _x0(S.d_pad, real=S.d)
    z = np.asarray(S.matvec(jnp.asarray(x)))
    return S, T, x, z, _draws(S.nblk, rounds=6, k=3)


@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("loss", LOSSES)
def test_fused_sparse_delta_matches_jax_and_oracles(loss, store):
    jp, _ = _sparse(loss, lam=1.0 if _name(loss) == "logistic" else 0.5)
    S, T, x, z, idx = _sparse_inputs(jp, store)
    y = np.asarray(jp.y)
    args_j = (S.rows, S.vals, jnp.asarray(z), jnp.asarray(x),
              jnp.asarray(idx), float(jp.lam), jp.beta, jnp.asarray(y))
    args_t = (T.rows, T.vals, _t(z), _t(x), torch.tensor(idx),
              float(jp.lam), jp.beta, _t(y))
    jout = jss.fused_sparse_shotgun_delta_rounds(*args_j, loss=loss,
                                                 interpret=True)
    tout = tss.fused_sparse_shotgun_delta_rounds(*args_t, loss=loss)
    _close(tout, jout)
    assert float(tout[2]) == float(jout[2]) == 0.0
    rout = tref.fused_sparse_shotgun_delta_rounds_ref(*args_t, loss)
    jrout = jref.fused_sparse_shotgun_delta_rounds_ref(*args_j, loss)
    _close(rout, jrout)
    _close(tout, rout)


def test_fused_sparse_delta_k_eff():
    jp, T = _sparse("lasso")
    S, T, x, z, idx = _sparse_inputs(jp, "f32")
    args_t = (T.rows, T.vals, _t(z), _t(x), torch.tensor(idx),
              float(jp.lam), jp.beta, _t(np.asarray(jp.y)))
    a = tss.fused_sparse_shotgun_delta_rounds(*args_t)
    b = tss.fused_sparse_shotgun_delta_rounds(*args_t, k_eff=torch.tensor(3))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    got = tss.fused_sparse_shotgun_delta_rounds(*args_t, k_eff=2)
    want = jss.fused_sparse_shotgun_delta_rounds(
        S.rows, S.vals, jnp.asarray(z), jnp.asarray(x), jnp.asarray(idx),
        float(jp.lam), jp.beta, jp.y, interpret=True, k_eff=2)
    _close(got, want)


def test_fused_sparse_delta_nan_reaches_row_zero_and_trips_health():
    """A NaN iterate in a column with padding slots: its NaN δ reaches Δz[0]
    through the padding term and trips health, as in the reference."""
    jp, T = _sparse("lasso")
    zm = T.scatter_order().zmask.numpy()
    b, c = map(int, np.argwhere(zm)[0])
    x = np.zeros(T.d_pad, np.float32)
    x[b * BLOCK + c] = np.nan
    z = np.zeros(T.n, np.float32)
    idx = np.array([[b]], np.int32)
    tout = tss.fused_sparse_shotgun_delta_rounds(
        T.rows, T.vals, _t(z), _t(x), torch.tensor(idx), float(jp.lam),
        jp.beta, _t(np.asarray(jp.y)))
    jout = jss.fused_sparse_shotgun_delta_rounds(
        jp.A.rows, jp.A.vals, jnp.asarray(z), jnp.asarray(x),
        jnp.asarray(idx), float(jp.lam), jp.beta, jp.y, interpret=True)
    assert np.isnan(float(tout[1][0])) and np.isnan(float(jout[1][0]))
    assert float(tout[2]) == float(jout[2]) == 1.0


def test_fused_sparse_delta_equals_margin_owning_kernel():
    jp, _ = _sparse("logistic_newton", lam=1.0)
    S, T, x, z, idx = _sparse_inputs(jp, "f32")
    args = (T.rows, T.vals, _t(z), _t(x), torch.tensor(idx), float(jp.lam),
            jp.beta, _t(np.asarray(jp.y)))
    xd, dz, _ = tss.fused_sparse_shotgun_delta_rounds(
        *args, loss="logistic_newton")
    xf, zf, *_ = tss.fused_sparse_shotgun_rounds(*args, loss="logistic_newton")
    # the view adds a round's k-ordered sum as one term (z0 + Σ_k), the
    # margin-owning kernel term by term (z0 + b_0 + b_1 ...): last-bit
    # differences that later rounds carry on
    torch.testing.assert_close(xd, xf, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dz, zf - _t(z), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The five engines' run, one shard's columns, the same draws
# ---------------------------------------------------------------------------

SHARDS, ME, ROUNDS = 2, 1, 4


def _jax_draws(keys, engine, width, limit):
    if engine == "scalar":
        draw = lambda k: jax.random.randint(k, (width,), 0, limit)  # noqa: E731
    else:
        draw = lambda k: jax.random.choice(k, limit, (width,),  # noqa: E731
                                           replace=False)
    return np.asarray(jax.vmap(draw)(keys)).astype(np.int32)


def _shard(engine, loss):
    """Shard ME of a 2-shard layout, as the JAX driver pads and cuts it:
    (jax A_blk, port A_blk, y, mask, x_l, z, lam, beta, d_local)."""
    if engine.startswith("sparse"):
        jp, _ = _sparse(loss, lam=1.0 if _name(loss) == "logistic" else 0.5)
        from repro.data.sparse import pad_feature_blocks
        S = pad_feature_blocks(jp.A, SHARDS)
        nb = S.nblk // SHARDS
        rows = S.rows[ME * nb:(ME + 1) * nb]
        vals = S.vals[ME * nb:(ME + 1) * nb]
        T = convert.bcsc_from_numpy(np.asarray(S.rows), np.asarray(S.vals),
                                    S.n, S.d, device="cpu")
        A_j = types.SimpleNamespace(rows=rows, vals=vals)
        A_t = T.col_blocks(ME * nb, (ME + 1) * nb)
        y = np.asarray(jp.y)
        mask = np.ones(S.n, np.float32)
        d_local, lam, beta = nb * BLOCK, float(jp.lam), jp.beta
        x = _x0(d_local, scale=0.05)
        z = np.asarray(S.matvec(jnp.asarray(
            np.concatenate([np.zeros(ME * d_local, np.float32), x]))))
        return A_j, A_t, y, mask, x, z, lam, beta, d_local
    p = _dense(loss)
    A = p["A"]
    d_local = A.shape[1] // SHARDS
    cols = A[:, ME * d_local:(ME + 1) * d_local]
    x = _x0(d_local, scale=0.05)
    z = cols @ x
    return (jnp.asarray(cols), _t(cols), p["y"], p["mask"], x, z, p["lam"],
            p["beta"], d_local)


ENGINE_CASES = [("scalar", "lasso", False), ("block", "logistic", False),
                ("fused", "lasso", False), ("fused", "logistic", True),
                ("sparse_block", "lasso", False),
                ("sparse_fused", "logistic", True)]


@pytest.mark.parametrize("backoff", [False, True])
@pytest.mark.parametrize("engine,loss,newton", ENGINE_CASES)
def test_engine_run_matches_jax(engine, loss, newton, backoff):
    """Port engine.run against JAX engine.run (interpret mode, standalone —
    no shard_map) on shard 1 of 2, the same draws; with ``backoff`` at
    p_eff = p_full − 1."""
    A_j, A_t, y, mask, x, z, lam, beta, d_local = _shard(engine, loss)
    width = 4 if engine == "scalar" else K
    je = jeng.make_engine(engine, loss=_name(loss), P_local=width, K=width,
                          interpret=True, newton=newton)
    te = teng.make_engine(engine, loss=_name(loss), P_local=width, K=width,
                          newton=newton)
    assert je.p_full == te.p_full == width
    p_eff = width - 1 if backoff else width
    keys = jax.random.split(jax.random.PRNGKey(3), ROUNDS)
    limit = d_local if engine == "scalar" else d_local // BLOCK
    idx = _jax_draws(keys, engine, width, limit)
    jout = je.run(A_j, jnp.asarray(y), jnp.asarray(mask), lam, beta,
                  jnp.asarray(z), jnp.asarray(x), keys, jnp.int32(p_eff))
    tout = te.run(A_t, _t(y), _t(mask), lam, beta, _t(z), _t(x),
                  torch.tensor(idx), torch.tensor(p_eff, dtype=torch.int32))
    _close(tout, jout)
    assert float(tout[2]) == float(jout[2]) == 0.0


def test_engine_run_segment_is_run_on_the_pending_view():
    A_j, A_t, y, mask, x, z, lam, beta, d_local = _shard("fused", "lasso")
    te = teng.make_engine("fused", loss="lasso", K=K)
    idx = torch.tensor(_draws(d_local // BLOCK, rounds=3))
    w = _t(np.random.default_rng(4).standard_normal(z.shape[0]) * 0.01)
    p = torch.tensor(K, dtype=torch.int32)
    a = te.run_segment(A_t, _t(y), _t(mask), lam, beta, _t(z), w, _t(x), idx,
                       p)
    b = te.run(A_t, _t(y), _t(mask), lam, beta, _t(z) + w, _t(x), idx, p)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_make_engine_rules():
    assert teng.ENGINE_NAMES == jeng.ENGINE_NAMES
    with pytest.raises(ValueError, match="newton=True requires a fused"):
        teng.make_engine("block", loss="logistic", newton=True)
    with pytest.raises(ValueError, match="unknown engine"):
        teng.make_engine("warp", loss="lasso")
    e = teng.make_engine("sparse_fused", loss="logistic", newton=True)
    assert e.loss.newton and e.loss.name == "logistic"


def test_shooting_delta_matches_jax():
    rng = np.random.default_rng(5)
    xj, gj = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    xj[3] = np.nan
    want = np.asarray(jobj.shooting_delta(jnp.asarray(xj), jnp.asarray(gj),
                                          0.3, 0.25))
    got = tobj.shooting_delta(_t(xj), _t(gj), 0.3, 0.25).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.isnan(got[3]) and np.isnan(want[3])


def test_col_blocks_slice_is_its_own_container():
    jp, T = _sparse("lasso", d=700)
    dense = T.to_dense().numpy()
    part = T.col_blocks(2, 5)
    assert (part.nblk, part.n, part.d) == (3, T.n, 3 * BLOCK)
    assert T.col_blocks(5, T.nblk).d == 700 - 5 * BLOCK
    x = _x0(part.d_pad, seed=6)
    want = dense[:, 2 * BLOCK:5 * BLOCK] @ x
    np.testing.assert_allclose(part.matvec(_t(x)).numpy(), want, rtol=1e-5,
                               atol=1e-5)
    assert part.scatter_order() is part.scatter_order()
    assert part.scatter_order() is not T.scatter_order()
    with pytest.raises(ValueError, match="outside"):
        T.col_blocks(4, T.nblk + 1)


# ---------------------------------------------------------------------------
# Wire compression (dist/compression.py) against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["none", "bf16", "int8", "topk"])
def test_compress_grads_matches_jax(scheme):
    rng = np.random.default_rng(7)
    g = (rng.standard_normal(1000) * 0.01).astype(np.float32)
    e = (rng.standard_normal(1000) * 0.001).astype(np.float32)
    jw, je = jcomp.compress_grads({"dz": jnp.asarray(g)},
                                  {"dz": jnp.asarray(e)}, scheme=scheme,
                                  topk_frac=0.05)
    tw, te = tcomp.compress_grads({"dz": _t(g)}, {"dz": _t(e)}, scheme=scheme,
                                  topk_frac=0.05)
    for got, want in ((tw, jw), (te, je)):
        np.testing.assert_allclose(got["dz"].numpy(), np.asarray(want["dz"]),
                                   rtol=1e-6, atol=1e-9)
    assert (tcomp.wire_bytes({"dz": _t(g)}, scheme, topk_frac=0.05)
            == jcomp.wire_bytes({"dz": jnp.asarray(g)}, scheme,
                                topk_frac=0.05))


def test_int8_quantizer_roundtrip_and_stochastic_rounding():
    x = _t(np.linspace(-1.0, 1.0, 255))
    qt = tcomp.quantize_int8(x)
    assert qt.q.dtype == torch.int8
    torch.testing.assert_close(tcomp.dequantize_int8(qt), x, rtol=0,
                               atol=float(qt.scale) / 2 + 1e-7)
    g = torch.Generator().manual_seed(0)
    v = torch.full((20000,), 0.3)
    mean = torch.stack([tcomp.dequantize_int8(tcomp.quantize_int8(
        torch.cat([v, torch.ones(1)]), g))[:-1].mean() for _ in range(4)])
    assert abs(float(mean.mean()) - 0.3) < 2e-3        # unbiased
    tk = tcomp.topk_compress(_t([0.1, -3.0, 2.0, 0.0]), 2)
    assert tcomp.topk_decompress(tk).tolist() == [0.0, -3.0, 2.0, 0.0]
    assert tcomp.ef_init({"a": torch.ones(3)})["a"].tolist() == [0.0] * 3
    with pytest.raises(ValueError, match="unknown compression"):
        tcomp.wire_bytes({"a": torch.ones(3)}, "zip")


def test_fault_coins_and_stream_seeds():
    """Drop zeroes, dup doubles, NaN corruption poisons; the same seed
    gives the same coins."""
    dz = _t(np.arange(1.0, 9.0))
    g = torch.Generator()
    for plan, want in ((tfaults.FaultPlan(drop_prob=1.0), dz * 0),
                       (tfaults.FaultPlan(dup_prob=1.0), dz * 2),
                       (tfaults.FaultPlan(), dz)):
        g.manual_seed(1)
        assert torch.equal(tfaults.inject_dz(dz, g, plan), want)
    g.manual_seed(1)
    bad = tfaults.inject_dz(dz, g, tfaults.FaultPlan(corrupt_prob=1.0,
                                                     corrupt_nan=True))
    assert torch.all(torch.isnan(bad))
    plan = tfaults.FaultPlan(corrupt_prob=0.5)
    a = tfaults.inject_dz(dz, g.manual_seed(tfaults.stream_seed(3, 4)), plan)
    b = tfaults.inject_dz(dz, g.manual_seed(tfaults.stream_seed(3, 4)), plan)
    assert torch.equal(a, b)
    assert tfaults.stream_seed(1, 2) != tfaults.stream_seed(2, 1)
    assert 0 <= tfaults.stream_seed(7) < 2 ** 63


# ---------------------------------------------------------------------------
# Checkpoints (tests/test_ckpt_and_fault_tolerance.py:21-66 invariants)
# ---------------------------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(4, 6, generator=g),
            "nested": {"b": torch.arange(5, dtype=torch.int32),
                       "c": torch.tensor(3.5)}}


def _leaves(t):
    return [t["a"], t["nested"]["b"], t["nested"]["c"]]


def test_ckpt_save_restore_roundtrip(tmp_path):
    t = _tree()
    tckpt.save(tmp_path, 7, t)
    step, out = tckpt.restore(tmp_path, t, device="cpu")
    assert step == 7
    for a, b in zip(_leaves(t), _leaves(out)):
        assert torch.equal(a, b) and a.dtype == b.dtype


def test_ckpt_keep_pruning(tmp_path):
    for s in [1, 2, 3, 4, 5]:
        tckpt.save(tmp_path, s, _tree(), keep=2)
    assert tckpt.all_steps(tmp_path) == [4, 5]
    assert tckpt.latest_step(tmp_path) == 5
    assert (pathlib.Path(tmp_path) / "LATEST").read_text() == \
        "step_000000000005"


def test_ckpt_half_written_step_is_ignored(tmp_path):
    tckpt.save(tmp_path, 1, _tree())
    crashed = pathlib.Path(tmp_path) / "step_000000000002.tmp"
    crashed.mkdir()
    (crashed / "arrays.npz").write_bytes(b"partial garbage")
    assert tckpt.latest_step(tmp_path) == 1
    step, _ = tckpt.restore(tmp_path, _tree(), device="cpu")
    assert step == 1


def test_ckpt_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tckpt.restore(tmp_path, _tree(), device="cpu")


def test_ckpt_restore_shape_mismatch_raises(tmp_path):
    tckpt.save(tmp_path, 1, _tree())
    bad = _tree()
    bad["a"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(tmp_path, bad, device="cpu")


def test_ckpt_restore_defaults_to_the_card(tmp_path, monkeypatch):
    """``restore`` resolves its device like every entry point of the port:
    the card unless the caller asks for the CPU, and without a card it
    raises instead of carrying on on the host."""
    tckpt.save(tmp_path, 1, _tree())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        tckpt.restore(tmp_path, _tree())
    step, _ = tckpt.restore(tmp_path, _tree(), device="cpu")
    assert step == 1
