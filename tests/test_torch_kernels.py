"""The port's kernel wrappers on the CPU (their plain versions) against the
JAX package's Pallas kernels in interpret mode and its ``ref.py`` oracles,
on the same numpy inputs and block indices: gather, scatter, and the fused
multi-round kernel for lasso / logistic / logistic_newton, f32 and bf16 A,
plus the port's own bit-exact invariants (k_eff = K is a no-op, k_eff = 0
freezes, the guard trips health, padded coordinates stay zero).

Shapes mirror tests/test_fused_kernels.py: n=300→512, d=500→512, R=8, K=2,
tolerances x rtol/atol 1e-4, z 1e-3, f 1e-4, nnz exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.core import objectives as jobj  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import shotgun_block as jsb  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import shotgun_block as tsb  # noqa: E402

BLOCK = 128
R, K = 8, 2


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _padded(loss, seed=0, n=300, d=500, lam=0.4):
    """JAX-side padded problem as numpy (non-divisible n/d on purpose)."""
    name = "lasso" if loss == "lasso" else "logistic"
    A, y, _ = (jsyn.sparco(seed=seed, n=n, d=d) if name == "lasso"
               else jsyn.logistic_data(seed=seed, n=n, d=d))
    prob = jobj.make_problem(A, y, lam=lam, loss=name)
    Ap, yp, mask = jops.pad_problem(prob.A, prob.y)
    return dict(A=np.asarray(Ap), y=np.asarray(yp), mask=np.asarray(mask),
                lam=float(prob.lam), beta=prob.beta, n=prob.n, d=prob.d)


def _warm_start(A, seed=1, scale=0.1):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(A.shape[1]) * scale).astype(np.float32)
    return x, np.asarray(jnp.asarray(A) @ jnp.asarray(x))


def _idx_with_duplicates(nblk, seed=2):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, nblk, (R, K)).astype(np.int32)
    idx[R // 2, -1] = idx[R // 2, 0]          # duplicate draw inside a round
    return idx


def _assert_rounds_close(got, want, tol_x=1e-4, tol_z=1e-3, tol_f=1e-4):
    xg, zg, fg, ng = (np.asarray(v) for v in got[:4])
    xw, zw, fw, nw = (np.asarray(v) for v in want[:4])
    np.testing.assert_allclose(xg, xw, rtol=tol_x, atol=tol_x)
    np.testing.assert_allclose(zg, zw, rtol=tol_z, atol=tol_z)
    np.testing.assert_allclose(fg, fw, rtol=tol_f, atol=tol_f)
    np.testing.assert_array_equal(ng, nw)


def _port_fused(p, x, z, idx, loss, A=None, **kw):
    A = _t(p["A"]) if A is None else A
    return tsb.fused_shotgun_rounds(
        A, _t(z), _t(x), torch.tensor(idx), p["lam"], p["beta"], _t(p["y"]),
        _t(p["mask"]), loss=loss, **kw)


# ---------------------------------------------------------------------------
# gather / scatter against the two-kernel Pallas kernels (#3, #4)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("store", ["f32", "bf16"])
def test_gather_block_matvec_matches_jax(store):
    rng = np.random.default_rng(3)
    A = rng.standard_normal((1024, 512)).astype(np.float32)
    if store == "bf16":     # both sides see the same rounded A
        A = A.astype(ml_dtypes.bfloat16).astype(np.float32)
    r = rng.standard_normal(1024).astype(np.float32)
    idx = np.array([3, 0, 3], np.int32)
    want = jsb.gather_block_matvec(jnp.asarray(A), jnp.asarray(r),
                                   jnp.asarray(idx), interpret=True)
    dtype = torch.bfloat16 if store == "bf16" else torch.float32
    got = tsb.gather_block_matvec(_t(A, dtype), _t(r), torch.tensor(idx))
    assert got.dtype == torch.float32 and got.shape == (3, BLOCK)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        got.numpy(), tref.gather_block_matvec_ref(
            _t(A), _t(r), torch.tensor(idx), BLOCK).numpy(),
        rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("store", ["f32", "bf16"])
def test_scatter_block_update_matches_jax(store):
    rng = np.random.default_rng(4)
    A = rng.standard_normal((1024, 512)).astype(np.float32)
    z = rng.standard_normal(1024).astype(np.float32)
    delta = (rng.standard_normal((3, BLOCK)) * 0.1).astype(np.float32)
    idx = np.array([1, 2, 1], np.int32)
    if store == "bf16":
        A = A.astype(ml_dtypes.bfloat16).astype(np.float32)
        # the TPU kernel rounds δ to A's dtype before the product
        delta = delta.astype(ml_dtypes.bfloat16).astype(np.float32)
    want = jsb.scatter_block_update(jnp.asarray(A), jnp.asarray(z),
                                    jnp.asarray(idx), jnp.asarray(delta),
                                    interpret=True)
    dtype = torch.bfloat16 if store == "bf16" else torch.float32
    got = tsb.scatter_block_update(_t(A, dtype), _t(z), torch.tensor(idx),
                                   _t(delta))
    assert got.dtype == torch.float32 and got.shape == (1024,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("loss", ["lasso", "logistic"])
def test_block_round_matches_jax(loss):
    p = _padded(loss, seed=3, n=512, d=512)
    x, z = _warm_start(p["A"], seed=4)
    idx = np.array([1, 3, 0], np.int32)
    jout = jops.block_shotgun_round(
        jnp.asarray(p["A"]), jnp.asarray(z), jnp.asarray(x),
        jnp.asarray(idx), p["lam"], p["beta"], jnp.asarray(p["y"]),
        jnp.asarray(p["mask"]), loss=loss, interpret=True)
    tout = tops.block_shotgun_round(
        _t(p["A"]), _t(z), _t(x), torch.tensor(idx), p["lam"], p["beta"],
        _t(p["y"]), _t(p["mask"]), loss=loss)
    rout = tref.block_shotgun_round_ref(
        _t(p["A"]), _t(z), _t(x), torch.tensor(idx), p["lam"], p["beta"],
        _t(p["y"]), loss, BLOCK)
    jrout = jref.block_shotgun_round_ref(
        jnp.asarray(p["A"]), jnp.asarray(z), jnp.asarray(x),
        jnp.asarray(idx), p["lam"], p["beta"], jnp.asarray(p["y"]), loss,
        BLOCK)
    for got, want in ((tout, jout), (rout, jrout)):
        for g, w, tol in zip(got, want, (1e-4, 1e-3, 1e-4)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                       atol=tol)


# ---------------------------------------------------------------------------
# fused rounds against the fused Pallas kernel (#1) and its oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loss", ["lasso", "logistic", "logistic_newton"])
def test_fused_rounds_match_jax(loss):
    p = _padded(loss)
    x, z = _warm_start(p["A"])
    idx = _idx_with_duplicates(p["A"].shape[1] // BLOCK)
    jout = jsb.fused_shotgun_rounds(
        jnp.asarray(p["A"]), jnp.asarray(z), jnp.asarray(x),
        jnp.asarray(idx), p["lam"], p["beta"], jnp.asarray(p["y"]),
        jnp.asarray(p["mask"]), loss=loss, interpret=True)
    tout = _port_fused(p, x, z, idx, loss)
    _assert_rounds_close(tout, jout)
    assert float(tout[4]) == float(jout[4]) == 0.0
    # the port's oracle agrees with the JAX oracle on the same inputs
    rout = tref.fused_shotgun_rounds_ref(
        _t(p["A"]), _t(z), _t(x), torch.tensor(idx), p["lam"], p["beta"],
        _t(p["y"]), _t(p["mask"]), loss, BLOCK)
    jrout = jref.fused_shotgun_rounds_ref(
        jnp.asarray(p["A"]), jnp.asarray(z), jnp.asarray(x),
        jnp.asarray(idx), p["lam"], p["beta"], jnp.asarray(p["y"]),
        jnp.asarray(p["mask"]), loss, BLOCK)
    _assert_rounds_close(rout, jrout)
    _assert_rounds_close(tout, rout)


@pytest.mark.parametrize("loss", ["lasso", "logistic_newton"])
def test_fused_bf16_storage_matches_jax(loss):
    """bf16-stored A with f32 accumulation: the port on a bf16 tensor
    against the JAX kernel fed the same rounded A, at 1e-3."""
    p = _padded(loss)
    A16 = p["A"].astype(ml_dtypes.bfloat16)
    x, z = _warm_start(A16.astype(np.float32))
    idx = _idx_with_duplicates(p["A"].shape[1] // BLOCK)
    jout = jsb.fused_shotgun_rounds(
        jnp.asarray(A16), jnp.asarray(z), jnp.asarray(x), jnp.asarray(idx),
        p["lam"], p["beta"], jnp.asarray(p["y"]), jnp.asarray(p["mask"]),
        loss=loss, interpret=True)
    tout = _port_fused(p, x, z, idx, loss,
                       A=_t(A16.astype(np.float32), torch.bfloat16))
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tout[2].numpy(), np.asarray(jout[2]),
                               rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# In-port invariants (bit-exact) and edge cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loss", ["lasso", "logistic_newton"])
def test_k_eff_full_is_bitexact_noop(loss):
    p = _padded(loss)
    x, z = _warm_start(p["A"])
    idx = _idx_with_duplicates(p["A"].shape[1] // BLOCK)
    a = _port_fused(p, x, z, idx, loss)
    b = _port_fused(p, x, z, idx, loss, k_eff=torch.tensor(K))
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_k_eff_zero_freezes_x_and_z():
    p = _padded("logistic")
    x, z = _warm_start(p["A"])
    idx = _idx_with_duplicates(p["A"].shape[1] // BLOCK)
    xo, zo, f, _, h = _port_fused(p, x, z, idx, "logistic", k_eff=0)
    assert torch.equal(xo, _t(x)) and torch.equal(zo, _t(z))
    assert torch.all(f == f[0]) and float(h) == 0.0


def test_guard_below_f_trips_health():
    p = _padded("lasso")
    x, z = _warm_start(p["A"])
    idx = _idx_with_duplicates(p["A"].shape[1] // BLOCK)
    _, _, f, _, h = _port_fused(p, x, z, idx, "lasso")
    assert float(h) == 0.0
    *_, h2 = _port_fused(p, x, z, idx, "lasso",
                         guard_f=torch.tensor(float(f.min()) * 0.5))
    assert float(h2) == 1.0
    jh = jsb.fused_shotgun_rounds(
        jnp.asarray(p["A"]), jnp.asarray(z), jnp.asarray(x),
        jnp.asarray(idx), p["lam"], p["beta"], jnp.asarray(p["y"]),
        jnp.asarray(p["mask"]), loss="lasso", interpret=True,
        guard_f=float(f.min()) * 0.5)[4]
    assert float(jh) == 1.0


def test_fused_padded_coordinates_stay_zero():
    p = _padded("lasso")
    nblk = p["A"].shape[1] // BLOCK
    idx = np.tile(np.arange(nblk, dtype=np.int32), (R, 1))
    zeros_x = np.zeros(p["A"].shape[1], np.float32)
    zeros_z = np.zeros(p["A"].shape[0], np.float32)
    xk, zk, fk, _, _ = _port_fused(p, zeros_x, zeros_z, idx, "lasso")
    np.testing.assert_array_equal(xk[p["d"]:].numpy(), 0.0)
    np.testing.assert_allclose(zk[p["n"]:].numpy(), 0.0, atol=1e-6)
    assert torch.all(torch.isfinite(fk))


def test_wrappers_reject_untiled_shapes():
    z = torch.zeros(512)
    with pytest.raises(ValueError, match="divisible by block"):
        tsb.gather_block_matvec(torch.zeros(512, 200), z,
                                torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="pad_problem"):
        tsb.scatter_block_update(torch.zeros(300, 128), torch.zeros(300),
                                 torch.zeros(1, dtype=torch.int32),
                                 torch.zeros(1, BLOCK))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tsb.fused_shotgun_rounds(torch.zeros(512, 128, dtype=torch.float64),
                                 z, torch.zeros(128),
                                 torch.zeros(1, 1, dtype=torch.int32), 0.1,
                                 1.0, z, z)


_SASS = """
\tcode for sm_90a
\t\tFunction : _Z6kernelIfLb0ELb0EEvv
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
                                                                   /* 0x000fe20000000800 */
        /*0010*/                   EXIT ;                          /* 0x000000000000794d */
\t\tFunction : _Z6kernelIfLb0ELb1EEvv
        /*0000*/                   EXIT ;                          /* 0x000000000000794d */
"""


def test_compare_sass_parses_cuobjdump_listing():
    """The SASS comparison reads each kernel's instructions (whitespace
    normalized, encodings and addresses dropped) from a cuobjdump
    listing."""
    from repro_torch.kernels import compare_sass as cs
    got = cs.parse_sass(_SASS)
    assert got == {"_Z6kernelIfLb0ELb0EEvv": ["LDC R1, c[0x0][0x28]", "EXIT"],
                   "_Z6kernelIfLb0ELb1EEvv": ["EXIT"]}


@pytest.mark.parametrize("new,want", [
    ("_Z6kernelIfLb0ELb0EEvv", "_Z6kernelIfLb0EEvv"),      # one flag added
    ("_Z6kernelIfLb0ELb0ELb0EEvv", "_Z6kernelIfLb0EEvv"),  # two flags added
    ("_Z6kernelIfLb1EEvv", "_Z6kernelIfLb1EEvv"),          # unchanged name
    ("_Z6kernelIfLb1ELb1EEvv", None),                      # new flag set
    ("_Z5otherv", None),                                   # no counterpart
])
def test_compare_sass_maps_a_new_template_flag_to_the_old_kernel(new, want):
    """A kernel that gained trailing false bool template arguments is
    compared with the kernel that lacks them; an instantiation with a new
    flag set has no counterpart."""
    from repro_torch.kernels import compare_sass as cs
    old = {"_Z6kernelIfLb0EEvv": [], "_Z6kernelIfLb1EEvv": []}
    assert cs.counterpart(new, old) == want


# ---------------------------------------------------------------------------
# The fused kernel's phase stamps: (2 + 3·R,) int64 on the launch's device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stamps,ok", [
    (None, True),
    (torch.zeros(2 + 3 * 4, dtype=torch.int64), True),
    (torch.zeros(2 + 3 * 4 + 5, dtype=torch.int64), True),
    (torch.zeros(2 + 3 * 4 - 1, dtype=torch.int64), False),
    (torch.zeros(2 + 3 * 4, dtype=torch.int32), False),
    (torch.zeros(2 + 3 * 4, dtype=torch.int64, device="meta"), False),
])
def test_fused_stamps_are_checked(stamps, ok):
    if ok:
        tsb._check_stamps(stamps, 4, torch.device("cpu"))
    else:
        with pytest.raises(ValueError, match="stamps must be an int64"):
            tsb._check_stamps(stamps, 4, torch.device("cpu"))


# ---------------------------------------------------------------------------
# The two-kernel pair's launch rule, its plain versions at K = 1 and with
# many duplicate draws, and its CPU route (#3, #4)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slots", [528, 132])
@pytest.mark.parametrize("K", [1, 2, 8, 72])
def test_gather_chunks_cover_every_row_once(K, slots):
    """For every TILE_N-padded n up to zeta's 500,224 (and n = 256): the
    C chunks of ``gather_block_matvec``'s launch tile [0, n) in order, none
    empty, each a multiple of 8 rows, sizes within 8 rows of each other,
    and K·C fits the card's resident slots (or C = 1)."""
    for n in (256, *range(512, 500_225, 512)):
        C = tsb._gather_chunks(n, K, slots)
        assert 1 <= C <= n // 8
        assert K * C <= slots or C == 1
        lo, hi = tsb._chunk_rows(n, C, np.arange(C))
        assert lo[0] == 0 and hi[-1] == n
        assert np.array_equal(hi[:-1], lo[1:])
        assert np.all(hi > lo) and np.all(lo % 8 == 0) and np.all(hi % 8 == 0)
        assert (hi - lo).max() - (hi - lo).min() <= 8
    assert tsb._gather_chunks(500_224, 2, 528) == 264       # one whole wave


@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("K", [1, 72])
def test_pair_plain_matches_jax_at_one_draw_and_many_duplicates(K, store):
    """K = 1, and K = 72 draws from 8 blocks (every block drawn many times,
    duplicates accumulating in k order), against the Pallas kernels in
    interpret mode; bf16 A with δ given in f32 (both sides round it)."""
    rng = np.random.default_rng(20 + K)
    A = rng.standard_normal((512, 8 * BLOCK)).astype(np.float32)
    r = rng.standard_normal(512).astype(np.float32)
    z = rng.standard_normal(512).astype(np.float32)
    delta = (rng.standard_normal((K, BLOCK)) * 0.1).astype(np.float32)
    idx = rng.integers(0, 8, K).astype(np.int32)
    if K > 1:
        idx[-1] = idx[0]
    jA = jnp.asarray(A.astype(ml_dtypes.bfloat16) if store == "bf16" else A)
    tA = _t(A, torch.bfloat16 if store == "bf16" else torch.float32)
    want_g = jsb.gather_block_matvec(jA, jnp.asarray(r), jnp.asarray(idx),
                                     interpret=True)
    want_z = jsb.scatter_block_update(jA, jnp.asarray(z), jnp.asarray(idx),
                                      jnp.asarray(delta), interpret=True)
    got_g = tsb.gather_block_matvec(tA, _t(r), torch.tensor(idx))
    got_z = tsb.scatter_block_update(tA, _t(z), torch.tensor(idx),
                                     _t(delta))
    assert got_g.shape == (K, BLOCK) and got_z.shape == (512,)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got_z.numpy(), np.asarray(want_z),
                               rtol=1e-5, atol=1e-4)


def test_pair_wrappers_take_the_plain_version_on_cpu(monkeypatch):
    """CPU operands go to the plain versions without loading the kernels
    or counting a launch; a CPU design with an operand elsewhere raises."""
    def no_library():
        raise AssertionError("the CPU route loaded the kernel library")

    monkeypatch.setattr(tsb, "_lib", no_library)
    before = dict(tsb.LAUNCHES)
    rng = np.random.default_rng(7)
    A = _t(rng.standard_normal((512, 2 * BLOCK)))
    r = _t(rng.standard_normal(512))
    idx = torch.tensor([1, 0, 1], dtype=torch.int32)
    delta = _t(rng.standard_normal((3, BLOCK)))
    assert torch.equal(tsb.gather_block_matvec(A, r, idx),
                       tsb.gather_block_matvec_plain(A, r, idx))
    assert torch.equal(tsb.scatter_block_update(A, r, idx, delta),
                       tsb.scatter_block_update_plain(A, r, idx, delta))
    assert tsb.LAUNCHES == before
    with pytest.raises(ValueError, match="one CUDA device or all on"):
        tsb.gather_block_matvec(A, r.to("meta"), idx)
    with pytest.raises(ValueError, match="one CUDA device or all on"):
        tsb.scatter_block_update(A, r, idx, delta.to("meta"))
