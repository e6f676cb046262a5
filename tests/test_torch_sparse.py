"""The port's BlockedCSC slice against the JAX package on the same numpy
inputs and block draws: the container, its layouts (the range-start table
against numpy's ``searchsorted``) and its linear ops, the sparse
generators, the three sparse kernels' plain versions against the Pallas
kernels in interpret mode and the ``ref.py`` oracles, the sparse solves
(fused and two-kernel; lasso, logistic, Newton; guarded, warm-started)
against JAX's, the sparse trajectory against the dense one, and the
spectral estimates.

Tolerances as in tests/test_torch_kernels.py and test_torch_solve.py:
kernels x 1e-4, z 1e-3, f 1e-4, nnz exact; solves F rtol 1e-4, nnz exact,
x rtol/atol 1e-4; container ops 1e-5 (f32 sums of a few terms in another
order); spectral radius rel 1e-3 from the same start vector.  The sparse
trajectory against the dense one on the densified matrix: rtol 1e-4 (the
same draws; only the order of the f32 sums differs)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import objectives as jobj  # noqa: E402
from repro.core import spectral as jspec  # noqa: E402
from repro.core.health import GuardConfig as JGuard  # noqa: E402
from repro.core.shotgun import shotgun_solve  # noqa: E402
from repro.core.spec import SolverSpec as JSpec  # noqa: E402
from repro.data import sparse as jsp  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import shotgun_sparse as jss  # noqa: E402
from repro.kernels.batched import batched_draw_blocks  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import health as thealth  # noqa: E402
from repro_torch.core import objectives as tobj  # noqa: E402
from repro_torch.core import spectral as tspec  # noqa: E402
from repro_torch.core.spec import SolverSpec  # noqa: E402
from repro_torch.data import sparse as tsp  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import shotgun_sparse as tss  # noqa: E402

BLOCK = 128


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _gen_kw(category, **kw):
    density = 0.05 if category == "logistic_data" else 0.02
    return {"seed": 0, "n": 256, "d": 512, "density": density, **kw}


def _gen(category, layout, **kw):
    return getattr(jsyn, category)(layout=layout, **_gen_kw(category, **kw))


def _port_bcsc(S):
    """The port's container for a JAX one (numpy across)."""
    return convert.bcsc_from_numpy(np.asarray(S.rows), np.asarray(S.vals),
                                   S.n, S.d, device="cpu")


def _problems(loss="lasso", category=None, seed=0, n=256, d=512,
              density=0.02, lam=0.5):
    """The same normalized BlockedCSC problem in both packages."""
    if category is None:
        category = "large_sparse" if loss == "lasso" else "logistic_data"
    if category == "logistic_data":
        density = max(density, 0.05)
    S, y, _ = getattr(jsyn, category)(seed=seed, n=n, d=d, density=density,
                                      layout="bcsc")
    jp = jobj.make_problem(S, y, lam=lam, loss=loss)
    tp = convert.problem_from_numpy(_port_bcsc(jp.A), np.asarray(jp.y),
                                    float(jp.lam), loss,
                                    scales=np.asarray(jp.scales),
                                    device="cpu")
    return jp, tp


def _jax_draws(key, rounds, K, nblk):
    keys = jax.random.split(key, rounds)[None]
    return np.asarray(batched_draw_blocks(keys, K, nblk))[0]


def _idx_with_duplicate(nblk, R, K, seed=2):
    idx = np.random.default_rng(seed).integers(0, nblk, (R, K)).astype(
        np.int32)
    idx[R // 2, -1] = idx[R // 2, 0]
    return idx


def _assert_rounds_close(got, want, tol_x=1e-4, tol_z=1e-3, tol_f=1e-4):
    for g, w, tol in zip(got[:3], want[:3], (tol_x, tol_z, tol_f)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=tol,
                                   atol=tol)
    np.testing.assert_array_equal(np.asarray(got[3]), np.asarray(want[3]))


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


# ---------------------------------------------------------------------------
# Container, layouts and linear ops (tests/test_sparse.py:34-138)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("category", ["sparse_imaging", "large_sparse",
                                      "logistic_data"])
def test_bcsc_pack_is_bit_identical_and_round_trips(category):
    Ad, yd, xd = _gen(category, "dense")
    S, y, x = _gen(category, "bcsc")
    T, ty, tx = getattr(tsyn, category)(layout="bcsc", **_gen_kw(category))
    np.testing.assert_array_equal(T.rows.numpy(), np.asarray(S.rows))
    np.testing.assert_array_equal(T.vals.numpy(), np.asarray(S.vals))
    np.testing.assert_array_equal(ty, np.asarray(y))
    np.testing.assert_array_equal(tx, np.asarray(x))
    assert T.rows.dtype == torch.int32 and T.device.type == "cpu"
    assert (T.n, T.d, T.tile, T.nblk, T.d_pad) == (S.n, S.d, S.tile, S.nblk,
                                                   S.d_pad)
    np.testing.assert_array_equal(T.to_dense().numpy(), Ad)
    assert int(T.nnz) == int((Ad != 0).sum()) == int(S.nnz)
    # the dense layout of the port's copy is the JAX package's matrix too
    Td, _, _ = getattr(tsyn, category)(**_gen_kw(category))
    np.testing.assert_array_equal(Td, Ad)


def test_bcsc_rejects_undersized_tile_and_unknown_layout():
    Ad, _, _ = _gen("sparse_imaging", "dense")
    with pytest.raises(ValueError, match="tile=1"):
        tsp.BlockedCSC.from_dense(Ad, tile=1, device="cpu")
    with pytest.raises(ValueError, match="layout"):
        tsyn.large_sparse(n=16, d=8, layout="csr")
    with pytest.raises(ValueError, match="layout"):
        tsyn.logistic_data(n=16, d=8, layout="csr")
    T = tsp.BlockedCSC.from_dense(Ad, tile=64, device="cpu")
    assert T.tile == 64
    np.testing.assert_array_equal(T.to_dense().numpy(), Ad)


def test_bcsc_astype_bf16_matches_jax():
    S = _gen("sparse_imaging", "bcsc")[0]
    Sb = S.astype(jnp.bfloat16)
    Tb = _port_bcsc(S).astype(torch.bfloat16)
    assert Tb.dtype == torch.bfloat16 and Tb.rows.dtype == torch.int32
    assert Tb.vals.element_size() == 2
    np.testing.assert_array_equal(
        Tb.vals.float().numpy(), np.asarray(Sb.vals).astype(np.float32))
    assert int(Tb.nnz) == int(Sb.nnz)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(S.d).astype(np.float32)
    r = rng.standard_normal(S.n).astype(np.float32)
    mv = tobj.matvec(Tb, _t(x))
    assert mv.dtype == torch.float32
    np.testing.assert_allclose(mv.numpy(),
                               np.asarray(jobj.matvec(Sb, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tobj.rmatvec(Tb, _t(r)).numpy(),
                               np.asarray(jobj.rmatvec(Sb, jnp.asarray(r))),
                               rtol=1e-5, atol=1e-5)
    # the bf16 copy made from the JAX container's bf16 tiles is the same
    Tc = convert.bcsc_from_numpy(np.asarray(Sb.rows), np.asarray(Sb.vals),
                                 Sb.n, Sb.d, device="cpu")
    assert Tc.dtype == torch.bfloat16 and torch.equal(Tc.vals, Tb.vals)


@pytest.mark.parametrize("category", ["sparse_imaging", "large_sparse"])
def test_bcsc_linear_ops_match_jax_and_dense(category):
    Ad = _gen(category, "dense")[0]
    S = _gen(category, "bcsc")[0]
    T = _port_bcsc(S)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(S.d).astype(np.float32)
    r = rng.standard_normal(S.n).astype(np.float32)
    for got, jax_want, dense_want in (
            (T.matvec(_t(x)), S.matvec(jnp.asarray(x)), Ad @ x),
            (T.rmatvec(_t(r)), S.rmatvec(jnp.asarray(r)), Ad.T @ r),
            (T.col_norms(), S.col_norms(), np.linalg.norm(Ad, axis=0))):
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_want),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), dense_want, rtol=1e-4,
                                   atol=1e-4)
    xp = np.pad(x, (0, S.d_pad - S.d))
    np.testing.assert_allclose(
        tsp.bcsc_matvec(T.rows, T.vals, _t(xp), T.n).numpy(),
        np.asarray(jsp.bcsc_matvec(S.rows, S.vals, jnp.asarray(xp), S.n)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tsp.bcsc_rmatvec(T.rows, T.vals, _t(r)).numpy(),
        np.asarray(jsp.bcsc_rmatvec(S.rows, S.vals, jnp.asarray(r))),
        rtol=1e-5, atol=1e-5)
    s = (rng.random(S.d) + 0.5).astype(np.float32)
    np.testing.assert_array_equal(T.scale_cols(_t(s)).vals.numpy(),
                                  np.asarray(S.scale_cols(jnp.asarray(s)).vals))


def test_matvec_padding_nan_semantics_match_jax():
    """A padding slot's 0·x is NaN for a non-finite x, landing on row 0."""
    S = _gen("large_sparse", "bcsc")[0]
    T = _port_bcsc(S)
    zm = T.scatter_order().zmask.reshape(-1).numpy().astype(bool)
    x = np.zeros(S.d_pad, np.float32)
    j = int(np.nonzero(zm[: S.d])[0][0])
    x[j] = np.inf
    got = T.matvec(_t(x)).numpy()
    want = np.asarray(jsp.bcsc_matvec(S.rows, S.vals, jnp.asarray(x), S.n))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[0])
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])


def test_scatter_order_and_row_table_layouts():
    S = _gen("sparse_imaging", "bcsc")[0]
    T = _port_bcsc(S)
    od = T.scatter_order()
    assert od.order.dtype == torch.int32 and od.order.shape == (
        T.nblk, T.tile * BLOCK)
    rows = T.rows.reshape(T.nblk, -1).numpy()
    vals = T.vals.reshape(T.nblk, -1).numpy()
    for b in range(T.nblk):
        m = int(od.count[b])
        stored = ~((rows[b] == 0) & (vals[b] == 0))
        assert m == int(stored.sum())
        o = od.order[b, :m].numpy()
        assert np.all(stored[o])
        r = rows[b][o]
        assert np.all(np.diff(r) >= 0)                  # sorted by row
        same = np.diff(r) == 0
        assert np.all(np.diff(o)[same] > 0)             # stable
        assert sorted(od.order[b].tolist()) == list(range(T.tile * BLOCK))
        np.testing.assert_array_equal(
            od.zmask[b].numpy().astype(bool),
            (~stored).reshape(T.tile, BLOCK).any(axis=0))
    assert T.scatter_order() is od                      # cached
    table = T.row_table()
    flat_rows = T.rows.reshape(-1).numpy()
    for i in range(0, T.n, 37):
        slots = table[i][table[i] < T.rows.numel()].numpy()
        assert np.all(flat_rows[slots] == i) and np.all(np.diff(slots) > 0)


def _boundary_bcsc(n, d=700, seed=3):
    """A (JAX, port) container pair at n rows with stored entries on the
    range boundaries (rows q·RANGE_ROWS - 1 and q·RANGE_ROWS) and two
    all-padding tail blocks from ``pad_feature_blocks`` (count 0)."""
    rng = np.random.default_rng(seed)
    A = ((rng.random((n, d)) < 0.03)
         * rng.standard_normal((n, d))).astype(np.float32)
    R = tsp.RANGE_ROWS
    for q in range(1, -(-n // R)):
        A[q * R - 1, 3 * q] = 1.5
        A[q * R, 3 * q] = -2.0
        A[q * R, 3 * q + 1] = 0.25
    A[n - 1, 1] = 0.5
    S = jsp.pad_feature_blocks(jsp.BlockedCSC.from_dense(A), 4)
    assert S.nblk == 8
    return S, _port_bcsc(S)


@pytest.mark.parametrize("n", [300, 385, 256])
def test_range_starts_match_numpy_searchsorted(n):
    S, T = _boundary_bcsc(n)
    od = T.scatter_order()
    rs = T.range_starts()
    R = tsp.RANGE_ROWS
    nq = -(-n // R)
    assert rs.dtype == torch.int32 and rs.shape == (T.nblk, nq + 1)
    assert T.range_starts() is rs                       # cached
    rows = T.rows.reshape(T.nblk, -1).numpy()
    vals = T.vals.reshape(T.nblk, -1).numpy()
    bounds = np.arange(nq + 1) * R
    for b in range(T.nblk):
        stored = ~((rows[b] == 0) & (vals[b] == 0))
        keys = np.sort(rows[b][stored], kind="stable")
        want = np.searchsorted(keys, bounds, side="left")
        np.testing.assert_array_equal(rs[b].numpy(), want)
        assert int(rs[b, -1]) == int(od.count[b])
        # each range's segment of the sorted order holds exactly its rows
        o = od.order[b].numpy()
        for q in range(nq):
            seg = rows[b][o[int(rs[b, q]):int(rs[b, q + 1])]]
            assert np.all(seg // R == q)
    assert int(od.count[-1]) == 0 and not rs[-1].any()  # padded tail block
    boundary = np.isin(rows[:, :], bounds[1:-1])
    assert boundary.any()                               # rows on a boundary
    np.testing.assert_array_equal(
        tsp.range_starts(T.rows, od, n).numpy(), rs.numpy())


@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("K", [1, 8, 64])
def test_scatter_plain_with_range_table_matches_jax(K, store):
    """The scatter's plain version, given the range-start table, against
    the Pallas kernel (interpret): duplicate draws, a count-0 block, bf16
    values."""
    S, _ = _boundary_bcsc(300)
    S, T = _stored(S, store)
    rng = np.random.default_rng(K)
    idx = rng.integers(0, S.nblk, K).astype(np.int32)
    idx[0] = S.nblk - 1                                  # count-0 block
    if K > 1:
        idx[-1] = idx[K // 2]                            # duplicate draw
    z = rng.standard_normal(S.n).astype(np.float32)
    delta = (rng.standard_normal((K, BLOCK)) * 0.1).astype(np.float32)
    got = tss.sparse_scatter_block_update_plain(
        T.rows, T.vals, _t(z), torch.tensor(idx), _t(delta),
        order=T.scatter_order(), rstart=T.range_starts())
    want = jss.sparse_scatter_block_update(S.rows, S.vals, jnp.asarray(z),
                                           jnp.asarray(idx),
                                           jnp.asarray(delta),
                                           interpret=True)
    assert got.dtype == torch.float32 and got.shape == (S.n,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    wrapped = tss.sparse_scatter_block_update(
        T.rows, T.vals, _t(z), torch.tensor(idx), _t(delta),
        order=T.scatter_order(), rstart=T.range_starts())
    assert torch.equal(wrapped, got)


@pytest.mark.parametrize("store", ["f32", "bf16"])
def test_scatter_plain_with_range_table_nan_through_padding(store):
    """A non-finite δ in a padding column reaches row 0 (and only row 0
    gains a NaN), as in the Pallas kernel."""
    S, _ = _boundary_bcsc(300)
    S, T = _stored(S, store)
    zm = T.scatter_order().zmask.numpy()
    b, c = map(int, np.argwhere(zm[:-2])[0])
    idx = np.array([b, S.nblk - 1, b], np.int32)
    delta = np.full((3, BLOCK), 0.01, np.float32)
    delta[2, c] = np.inf
    z = np.ones(S.n, np.float32)
    got = tss.sparse_scatter_block_update_plain(
        T.rows, T.vals, _t(z), torch.tensor(idx), _t(delta),
        order=T.scatter_order(), rstart=T.range_starts())
    want = np.asarray(jss.sparse_scatter_block_update(
        S.rows, S.vals, jnp.asarray(z), jnp.asarray(idx),
        jnp.asarray(delta), interpret=True))
    assert np.isnan(got[0].item())
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], rtol=1e-5,
                               atol=1e-5)


def test_scatter_rejects_a_foreign_range_table():
    S, T = _boundary_bcsc(300)
    _, U = _boundary_bcsc(300, seed=4)
    idx = torch.tensor([0, 1, 2], dtype=torch.int32)
    args = (T.rows, T.vals, torch.zeros(300), idx, torch.ones(3, BLOCK))
    with pytest.raises(ValueError, match="rstart"):
        tss.sparse_scatter_block_update(*args, order=T.scatter_order(),
                                        rstart=U.range_starts())


@pytest.mark.parametrize("bad", ["columns", "dtype", "rank", "device"])
@pytest.mark.parametrize("wrapper", ["rounds", "delta"])
def test_fused_wrappers_reject_a_wrong_range_table(wrapper, bad):
    """The fused wrappers check ``rstart``'s type, shape and device before
    they dispatch: on CPU tensors (the plain version, which takes no table)
    a wrong table raises as it would on the card, and the right one
    passes."""
    _, T = _boundary_bcsc(300)
    rs = T.range_starts()
    table = {"columns": rs[:, :-1].contiguous(), "dtype": rs.long(),
             "rank": rs[None], "device": rs.to("meta")}[bad]
    idx = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    args = (T.rows, T.vals, torch.zeros(300), torch.zeros(T.d_pad), idx,
            0.1, 1.0, torch.zeros(300))
    fn = (tss.fused_sparse_shotgun_rounds if wrapper == "rounds"
          else tss.fused_sparse_shotgun_delta_rounds)
    with pytest.raises(ValueError, match="rstart"):
        fn(*args, order=T.scatter_order(), rstart=table)
    want = fn(*args)
    got = fn(*args, order=T.scatter_order(), rstart=rs)
    assert all(torch.equal(u, v) for u, v in zip(got, want))


@pytest.mark.parametrize("numel,ok", [(None, True), (18, True), (19, True),
                                      (17, False), (14, False),
                                      ("int32", False)])
def test_ovf_stamps_are_three_a_round(numel, ok):
    """An OVF launch (a design with an overflow store) stamps 3R + 4 clocks
    (three barriers a round: A, A2, BC) and two ns times: R = 4 needs 18
    int64 elements, and the 2R + 6 of the other fused launches are short."""
    stamps = (None if numel is None else
              torch.zeros(18, dtype=torch.int32) if numel == "int32" else
              torch.zeros(numel, dtype=torch.int64))
    if ok:
        tss._check_stamps(stamps, 4, torch.device("cpu"), ovf=True)
    else:
        with pytest.raises(ValueError, match=">= 18 elements"):
            tss._check_stamps(stamps, 4, torch.device("cpu"), ovf=True)


@pytest.mark.parametrize("numel,ok", [(None, True), (14, True), (15, True),
                                      (13, False), ("int32", False)])
def test_fused_sparse_stamps_are_two_a_round(numel, ok):
    """The fused sparse kernels stamp 2R + 4 clocks (two barriers a round)
    and two ns times: R = 4 needs 14 int64 elements."""
    stamps = (None if numel is None else
              torch.zeros(14, dtype=torch.int32) if numel == "int32" else
              torch.zeros(numel, dtype=torch.int64))
    if ok:
        tss._check_stamps(stamps, 4, torch.device("cpu"))
    else:
        with pytest.raises(ValueError, match="stamps must be an int64"):
            tss._check_stamps(stamps, 4, torch.device("cpu"))


def test_fused_scalars_go_by_value_or_by_pointer():
    """Numbers go to the kernel by value; tensors stay tensors (S values,
    a single value serving every slot) and go by pointer."""
    cpu = torch.device("cpu")
    lam = torch.tensor(0.5)
    ptrs, nums, keep = tss._scalar_args((lam, 2.0, 3, float("inf")), 1, cpu)
    assert [bool(p) for p in ptrs] == [True, False, False, False]
    assert ptrs[0] == keep[0].data_ptr() and float(keep[0][0]) == 0.5
    assert list(nums)[1:3] == [2.0, 3.0] and np.isinf(nums[3])
    ptrs, nums, keep = tss._scalar_args(
        (torch.arange(3.0), 1.0, torch.tensor(2), 0.0), 3, cpu)
    assert [bool(p) for p in ptrs] == [True, False, True, False]
    assert keep[1].tolist() == [2.0, 2.0, 2.0] and keep[1].is_contiguous()
    with pytest.raises(ValueError, match="scalar of shape"):
        tss._scalar_args((torch.ones(2), 1.0, 1.0, 1.0), 3, cpu)


def test_pad_feature_blocks_zero_tail():
    S = _gen("sparse_imaging", "bcsc")[0]
    T = _port_bcsc(S)
    Tp = tsp.pad_feature_blocks(T, 3)
    Sp = jsp.pad_feature_blocks(S, 3)
    assert Tp.nblk == Sp.nblk and Tp.nblk % 3 == 0
    np.testing.assert_array_equal(Tp.vals.numpy(), np.asarray(Sp.vals))
    np.testing.assert_array_equal(Tp.rows.numpy(), np.asarray(Sp.rows))
    assert tsp.pad_feature_blocks(Tp, 3) is Tp


@pytest.mark.parametrize("loss", ["lasso", "logistic"])
def test_make_problem_and_lambda_max_on_bcsc_match_jax(loss):
    category = "large_sparse" if loss == "lasso" else "logistic_data"
    S, y, _ = _gen(category, "bcsc")
    jp = jobj.make_problem(S, y, lam=0.5, loss=loss)
    tp = tobj.make_problem(_port_bcsc(S), y, 0.5, loss=loss, device="cpu")
    assert isinstance(tp.A, tsp.BlockedCSC)
    assert (tp.n, tp.d) == (jp.n, jp.d)
    np.testing.assert_allclose(tp.scales.numpy(), np.asarray(jp.scales),
                               rtol=1e-6)
    np.testing.assert_allclose(tp.A.vals.numpy(), np.asarray(jp.A.vals),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        float(tobj.lambda_max(tp.A, tp.y, loss)),
        float(jobj.lambda_max(jp.A, jp.y, loss)), rtol=1e-5)
    Ad = np.asarray(S.to_dense())
    np.testing.assert_allclose(
        float(tobj.lambda_max(tp.A, tp.y, loss)),
        float(tobj.lambda_max(tobj.make_problem(Ad, y, 0.5, loss=loss,
                                                device="cpu").A,
                              tp.y, loss)), rtol=1e-5)
    # normalize_columns on its own, with an all-zero column (scale -> 1)
    for got, want in zip(tobj.normalize_columns(_port_bcsc(S)),
                         jobj.normalize_columns(S)):
        vals = got.vals if isinstance(got, tsp.BlockedCSC) else got
        wv = want.vals if isinstance(want, jsp.BlockedCSC) else want
        np.testing.assert_allclose(vals.numpy(), np.asarray(wv), rtol=1e-6,
                                   atol=1e-7)


def test_on_device_generators_on_the_cpu():
    """The on-device generators (here on the CPU): rows ascend within a
    column with no repeats, padding is (row 0, value 0), the padded tail
    columns are empty, the density is near the asked one, and the labels
    are ±1."""
    n, d, density = 500, 700, 0.02
    S, y, x = tsyn.large_sparse_bcsc_on_device(seed=3, n=n, d=d,
                                               density=density, device="cpu")
    L, ly, _ = tsyn.logistic_bcsc_on_device(seed=4, n=n, d=d,
                                            density=density, device="cpu")
    for T in (S, L):
        assert (T.n, T.d, T.nblk) == (n, d, -(-d // BLOCK))
        assert T.tile % 8 == 0 and T.rows.dtype == torch.int32
        rows, vals = T.rows.numpy(), T.vals.numpy()
        live = vals != 0
        assert np.all(rows[~live] == 0)
        for b in range(T.nblk):
            for c in range(BLOCK):
                col = rows[b, :, c][live[b, :, c]]
                k = col.size
                assert np.all(live[b, :k, c]) and not live[b, k:, c].any()
                assert np.all(np.diff(col) > 0)
        assert not live.reshape(T.nblk, T.tile, BLOCK).transpose(
            0, 2, 1).reshape(-1, T.tile)[d:].any()
        assert abs(live.sum() / (n * d) - density) < 0.2 * density
    assert np.all(S.vals.numpy() >= 0)
    assert y.shape == (n,) and x.shape == (d,)
    np.testing.assert_allclose(y.numpy(), S.matvec(x).numpy(), atol=0.1)
    assert set(np.unique(ly.numpy())) <= {-1.0, 1.0}


# ---------------------------------------------------------------------------
# The three kernels' plain versions against the Pallas kernels (interpret)
# ---------------------------------------------------------------------------

def _stored(S, store):
    """(JAX container, port container) with the same stored values."""
    if store == "bf16":
        S = S.astype(jnp.bfloat16)
    T = convert.bcsc_from_numpy(np.asarray(S.rows), np.asarray(S.vals), S.n,
                                S.d, device="cpu")
    return S, T


@pytest.mark.parametrize("store", ["f32", "bf16"])
def test_sparse_gather_and_scatter_match_jax(store):
    S, T = _stored(_gen("sparse_imaging", "bcsc", seed=4)[0], store)
    rng = np.random.default_rng(5)
    r = rng.standard_normal(S.n).astype(np.float32)
    z = rng.standard_normal(S.n).astype(np.float32)
    delta = (rng.standard_normal((3, BLOCK)) * 0.1).astype(np.float32)
    idx = np.array([2, 0, 2], np.int32)                  # duplicate draw
    g = tss.sparse_gather_block_matvec(T.rows, T.vals, _t(r),
                                       torch.tensor(idx))
    jg = jss.sparse_gather_block_matvec(S.rows, S.vals, jnp.asarray(r),
                                        jnp.asarray(idx), interpret=True)
    assert g.dtype == torch.float32 and g.shape == (3, BLOCK)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)
    zk = tss.sparse_scatter_block_update(T.rows, T.vals, _t(z),
                                         torch.tensor(idx), _t(delta))
    jz = jss.sparse_scatter_block_update(S.rows, S.vals, jnp.asarray(z),
                                         jnp.asarray(idx),
                                         jnp.asarray(delta), interpret=True)
    assert zk.dtype == torch.float32 and zk.shape == (S.n,)
    np.testing.assert_allclose(zk.numpy(), np.asarray(jz), rtol=1e-5,
                               atol=1e-5)
    # against the dense oracles on the densified matrix
    Ad = jnp.asarray(np.asarray(S.to_dense()))
    np.testing.assert_allclose(
        g.numpy(), np.asarray(jref.gather_block_matvec_ref(
            Ad, jnp.asarray(r), jnp.asarray(idx), BLOCK)), rtol=1e-4,
        atol=1e-4)


def _fused_inputs(S, R=4, K=2, seed=11):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(S.d_pad) * 0.1).astype(np.float32)
    x[S.d:] = 0.0
    z = np.asarray(S.matvec(jnp.asarray(x)))
    return x, z, _idx_with_duplicate(S.nblk, R, K, seed)


@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("loss", ["lasso", "logistic", "logistic_newton"])
def test_fused_sparse_matches_jax_and_oracles(loss, store):
    name = "lasso" if loss == "lasso" else "logistic"
    jp, _ = _problems(name, lam=1.0 if name == "logistic" else 0.5)
    S, T = _stored(jp.A, store)
    x, z, idx = _fused_inputs(S)
    y = np.asarray(jp.y)
    args_j = (S.rows, S.vals, jnp.asarray(z), jnp.asarray(x),
              jnp.asarray(idx), float(jp.lam), jp.beta, jnp.asarray(y))
    args_t = (T.rows, T.vals, _t(z), _t(x), torch.tensor(idx),
              float(jp.lam), jp.beta, _t(y))
    jout = jss.fused_sparse_shotgun_rounds(*args_j, loss=loss,
                                           interpret=True)
    tout = tss.fused_sparse_shotgun_rounds(*args_t, loss=loss)
    _assert_rounds_close(tout, jout)
    assert float(tout[4]) == float(jout[4]) == 0.0
    rout = tref.fused_sparse_shotgun_rounds_ref(*args_t, loss)
    jrout = jref.fused_sparse_shotgun_rounds_ref(*args_j, loss)
    _assert_rounds_close(rout, jrout)
    _assert_rounds_close(tout, rout)


def test_sparse_round_matches_jax():
    jp, tp = _problems("logistic", lam=1.0)
    S, T = jp.A, tp.A
    x, z, _ = _fused_inputs(S)
    idx = np.array([1, 3, 1], np.int32)
    jout = jops.sparse_block_shotgun_round(
        S.rows, S.vals, jnp.asarray(z), jnp.asarray(x), jnp.asarray(idx),
        float(jp.lam), jp.beta, jp.y, loss="logistic", interpret=True)
    tout = tops.sparse_block_shotgun_round(
        T.rows, T.vals, _t(z), _t(x), torch.tensor(idx), float(jp.lam),
        jp.beta, tp.y, loss="logistic", order=T.scatter_order())
    for g, w, tol in zip(tout, jout, (1e-4, 1e-3, 1e-4)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("loss", ["lasso", "logistic_newton"])
def test_sparse_k_eff_full_is_bitexact_noop(loss):
    jp, tp = _problems("lasso" if loss == "lasso" else "logistic", lam=1.0)
    x, z, idx = _fused_inputs(jp.A, R=6, K=3)
    args = (tp.A.rows, tp.A.vals, _t(z), _t(x), torch.tensor(idx),
            tp.lam, tp.beta, tp.y)
    a = tss.fused_sparse_shotgun_rounds(*args, loss=loss)
    b = tss.fused_sparse_shotgun_rounds(*args, loss=loss,
                                        k_eff=torch.tensor(3))
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_sparse_k_eff_zero_freezes_and_guard_trips_health():
    jp, tp = _problems("logistic", lam=1.0)
    x, z, idx = _fused_inputs(jp.A)
    args = (tp.A.rows, tp.A.vals, _t(z), _t(x), torch.tensor(idx),
            tp.lam, tp.beta, tp.y)
    xo, zo, f, _, h = tss.fused_sparse_shotgun_rounds(*args, loss="logistic",
                                                      k_eff=0)
    assert torch.equal(xo, _t(x)) and torch.equal(zo, _t(z))
    assert torch.all(f == f[0]) and float(h) == 0.0
    _, _, f, _, h = tss.fused_sparse_shotgun_rounds(*args, loss="logistic")
    assert float(h) == 0.0
    guard = float(f.min()) * 0.5
    *_, h2 = tss.fused_sparse_shotgun_rounds(*args, loss="logistic",
                                             guard_f=torch.tensor(guard))
    jh = jss.fused_sparse_shotgun_rounds(
        jp.A.rows, jp.A.vals, jnp.asarray(z), jnp.asarray(x),
        jnp.asarray(idx), float(jp.lam), jp.beta, jp.y, loss="logistic",
        interpret=True, guard_f=guard)[4]
    assert float(h2) == float(jh) == 1.0


def test_nan_delta_reaches_row_zero_through_padding():
    """A non-finite δ in a column with padding slots makes z[0] NaN in the
    scatter and trips health in the fused rounds, as in the reference."""
    S = _gen("large_sparse", "bcsc")[0]
    T = _port_bcsc(S)
    zm = T.scatter_order().zmask.numpy()
    b, c = map(int, np.argwhere(zm)[0])
    delta = np.zeros((1, BLOCK), np.float32)
    delta[0, c] = np.nan
    z = np.ones(S.n, np.float32)
    idx = np.array([b], np.int32)
    got = tss.sparse_scatter_block_update(T.rows, T.vals, _t(z),
                                          torch.tensor(idx), _t(delta))
    want = jss.sparse_scatter_block_update(S.rows, S.vals, jnp.asarray(z),
                                           jnp.asarray(idx),
                                           jnp.asarray(delta),
                                           interpret=True)
    np.testing.assert_array_equal(np.isnan(got.numpy()),
                                  np.isnan(np.asarray(want)))
    assert np.isnan(got[0].item())
    x = np.zeros(S.d_pad, np.float32)
    x[b * BLOCK + c] = np.nan
    *_, h = tss.fused_sparse_shotgun_rounds(
        T.rows, T.vals, _t(np.zeros(S.n)), _t(x),
        torch.tensor([[b]], dtype=torch.int32), 0.1, 1.0, _t(z))
    assert float(h) == 1.0


def test_sparse_wrappers_reject_bad_tiles():
    rows = torch.zeros(2, 8, BLOCK, dtype=torch.int32)
    vals = torch.zeros(2, 8, BLOCK)
    idx = torch.zeros(1, dtype=torch.int32)
    z = torch.zeros(16)
    with pytest.raises(ValueError, match="int32"):
        tss.sparse_gather_block_matvec(rows.long(), vals, z, idx)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tss.sparse_gather_block_matvec(rows, vals.double(), z, idx)
    with pytest.raises(ValueError, match="block width"):
        tss.sparse_scatter_block_update(rows[..., :64], vals[..., :64], z,
                                        idx, torch.zeros(1, 64))
    with pytest.raises(ValueError, match="one"):
        tss.fused_sparse_shotgun_rounds(rows, vals[:, :4], z,
                                        torch.zeros(256), idx[None], 0.1,
                                        1.0, z)


# ---------------------------------------------------------------------------
# Odd tile depths (1, 3, 5, 7) and bf16 packing, held against the reference
# ---------------------------------------------------------------------------

def _odd_tile_design(loss, seed=7, tile=7):
    """A 40 x 256 design with 1..tile nonzeros per column (column 3 has
    tile), so ``from_dense(tile=tile)`` packs it, and its labels."""
    rng = np.random.default_rng(seed)
    n, d = 40, 256
    A = np.zeros((n, d), np.float32)
    for j in range(d):
        k = tile if j == 3 else int(rng.integers(1, tile + 1))
        A[rng.choice(n, k, replace=False), j] = rng.standard_normal(k)
    x = np.zeros(d, np.float32)
    x[rng.choice(d, 12, replace=False)] = rng.standard_normal(12)
    y = A @ x + 0.05 * rng.standard_normal(n).astype(np.float32)
    if loss == "logistic":
        y = np.where(y >= 0, 1.0, -1.0).astype(np.float32)
    return A, y


def _odd_tile_problems(loss, lam, tile=7):
    A, y = _odd_tile_design(loss, tile=tile)
    S = jsp.BlockedCSC.from_dense(A, tile=tile)
    T = tsp.BlockedCSC.from_dense(torch.tensor(A), tile=tile, device="cpu")
    assert S.tile == T.tile == tile
    np.testing.assert_array_equal(T.rows.numpy(), np.asarray(S.rows))
    np.testing.assert_array_equal(T.vals.numpy(), np.asarray(S.vals))
    jp = jobj.make_problem(S, y, lam=lam, loss=loss)
    tp = convert.problem_from_numpy(_port_bcsc(jp.A), np.asarray(jp.y),
                                    float(jp.lam), loss,
                                    scales=np.asarray(jp.scales),
                                    device="cpu")
    return jp, tp


@pytest.mark.parametrize("store", ["f32", "bf16"])
def test_tile7_gather_and_scatter_match_jax(store):
    _odd_tile_gather_and_scatter(store, 7)


@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("tile", [1, 3, 5])
def test_odd_tile_gather_and_scatter_match_jax(tile, store):
    _odd_tile_gather_and_scatter(store, tile)


def _odd_tile_gather_and_scatter(store, tile):
    jp, _ = _odd_tile_problems("lasso", 0.5, tile)
    S, T = _stored(jp.A, store)
    rng = np.random.default_rng(8)
    r = rng.standard_normal(S.n).astype(np.float32)
    z = rng.standard_normal(S.n).astype(np.float32)
    delta = (rng.standard_normal((3, BLOCK)) * 0.1).astype(np.float32)
    idx = np.array([1, 0, 1], np.int32)                  # duplicate draw
    g = tss.sparse_gather_block_matvec(T.rows, T.vals, _t(r),
                                       torch.tensor(idx))
    jg = jss.sparse_gather_block_matvec(S.rows, S.vals, jnp.asarray(r),
                                        jnp.asarray(idx), interpret=True)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)
    zk = tss.sparse_scatter_block_update(T.rows, T.vals, _t(z),
                                         torch.tensor(idx), _t(delta))
    jz = jss.sparse_scatter_block_update(S.rows, S.vals, jnp.asarray(z),
                                         jnp.asarray(idx),
                                         jnp.asarray(delta), interpret=True)
    np.testing.assert_allclose(zk.numpy(), np.asarray(jz), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("loss,newton,fused", [
    ("lasso", False, True), ("lasso", False, False),
    ("logistic", True, True), ("logistic", False, False)])
def test_tile7_solve_matches_jax(loss, newton, fused):
    _odd_tile_solve(loss, newton, fused, 7)


@pytest.mark.parametrize("newton,fused", [(True, True), (False, False)])
def test_odd_tile_solve_matches_jax(newton, fused):
    _odd_tile_solve("logistic", newton, fused, 3)


def _odd_tile_solve(loss, newton, fused, tile):
    jp, tp = _odd_tile_problems(loss, 1.0 if loss == "logistic" else 0.2, tile)
    key = jax.random.PRNGKey(3)
    kw = dict(loss=loss, P=128, rounds=16, fused=fused, newton=newton)
    jres = jops.block_shotgun_solve(jp, key, spec=JSpec(**kw))
    tres = tops.block_shotgun_solve(
        tp, spec=SolverSpec(**kw), blk_idx=_jax_draws(key, 16, 1, jp.A.nblk))
    _assert_solves_close(tres, jres)


def test_from_dense_of_bf16_is_bit_identical_to_jax():
    Ad, _, _ = _gen("sparse_imaging", "dense")
    Ab = torch.tensor(Ad).to(torch.bfloat16)
    S = jsp.BlockedCSC.from_dense(jnp.asarray(Ad, jnp.bfloat16))
    T = tsp.BlockedCSC.from_dense(Ab, device="cpu")
    assert T.vals.dtype == torch.float32 and T.tile == S.tile
    np.testing.assert_array_equal(T.rows.numpy(), np.asarray(S.rows))
    np.testing.assert_array_equal(T.vals.numpy().view(np.int32),
                                  np.asarray(S.vals).view(np.int32))
    np.testing.assert_array_equal(T.to_dense().numpy(), Ab.float().numpy())


# ---------------------------------------------------------------------------
# Solves against JAX on the same draws (tests/test_sparse.py:179-415,
# tests/test_logreg_fused.py:71, :115)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loss,newton", [("lasso", False),
                                         ("logistic", False),
                                         ("logistic", True)])
def test_sparse_fused_solve_matches_jax(loss, newton):
    jp, tp = _problems(loss, lam=1.0 if loss == "logistic" else 0.5)
    key = jax.random.PRNGKey(0)
    kw = dict(loss=loss, P=256, rounds=16, fused=True, newton=newton)
    jres = jops.block_shotgun_solve(jp, key, spec=JSpec(**kw))
    tres = tops.block_shotgun_solve(
        tp, spec=SolverSpec(**kw), blk_idx=_jax_draws(key, 16, 2, jp.A.nblk))
    _assert_solves_close(tres, jres)
    assert tres.z.shape == (jp.n,)


@pytest.mark.parametrize("loss", ["lasso", "logistic"])
def test_sparse_two_kernel_solve_matches_jax(loss):
    jp, tp = _problems(loss, seed=1, lam=1.0 if loss == "logistic" else 0.5)
    key = jax.random.PRNGKey(1)
    kw = dict(loss=loss, P=256, rounds=12)
    jres = jops.block_shotgun_solve(jp, key, spec=JSpec(**kw))
    tres = tops.block_shotgun_solve(
        tp, spec=SolverSpec(**kw), blk_idx=_jax_draws(key, 12, 2, jp.A.nblk))
    _assert_solves_close(tres, jres)


@pytest.mark.parametrize("fused", [True, False])
def test_sparse_guarded_solve_beyond_pstar_matches_jax(fused):
    """Nonnegative columns at density 0.5 put ρ near d/2, so P* ≈ 2; K = 3
    blocks (P = 384) diverges unguarded.  Both packages back off, end
    RECOVERED, and trace the same objective."""
    jp, tp = _problems("lasso", category="large_sparse", seed=0, n=64,
                       d=1024, density=0.5, lam=0.1)
    key = jax.random.PRNGKey(0)
    rounds = 24 if fused else 16
    kw = dict(loss="lasso", P=3 * BLOCK, rounds=rounds, fused=fused)
    draws = _jax_draws(key, rounds, 3, jp.A.nblk)
    jres = jops.block_shotgun_solve(jp, key,
                                    spec=JSpec(**kw, guard=JGuard(10.0, 1)))
    tres = tops.block_shotgun_solve(
        tp, spec=SolverSpec(**kw, guard=thealth.GuardConfig(10.0, 1)),
        blk_idx=draws)
    assert torch.all(torch.isfinite(tres.trace.objective))
    assert int(tres.status) == int(jres.status) == thealth.STATUS_RECOVERED
    np.testing.assert_allclose(tres.trace.objective.numpy(),
                               np.asarray(jres.trace.objective), rtol=1e-4)
    unguarded = tops.block_shotgun_solve(tp, spec=SolverSpec(**kw),
                                         blk_idx=draws)
    assert int(unguarded.status) == thealth.STATUS_DIVERGED


@pytest.mark.parametrize("fused", [True, False])
def test_sparse_warm_start_matches_jax(fused):
    jp, tp = _problems("lasso", category="sparse_imaging", seed=2)
    key = jax.random.PRNGKey(3)
    x0 = (np.random.default_rng(0).standard_normal(jp.d) * 0.05).astype(
        np.float32)
    kw = dict(loss="lasso", P=256, rounds=8, fused=fused)
    jres = jops.block_shotgun_solve(jp, key, x0=jnp.asarray(x0),
                                    spec=JSpec(**kw))
    tres = tops.block_shotgun_solve(
        tp, spec=SolverSpec(**kw), blk_idx=_jax_draws(key, 8, 2, jp.A.nblk),
        x0=torch.tensor(x0))
    _assert_solves_close(tres, jres)


@pytest.mark.parametrize("category", ["sparse_imaging", "large_sparse"])
def test_sparse_trajectory_matches_dense(category):
    """The port's sparse and dense solves on the same draws (the dense one
    on the densified matrix) follow one trajectory, fused and two-kernel."""
    Ad, y, _ = getattr(tsyn, category)(seed=0, n=256, d=512, density=0.02)
    S, _, _ = getattr(tsyn, category)(seed=0, n=256, d=512, density=0.02,
                                      layout="bcsc")
    pd = tobj.make_problem(Ad, y, 0.5, device="cpu")
    ps = tobj.make_problem(S, y, 0.5, device="cpu")
    draws = np.random.default_rng(4).integers(0, 4, (16, 1)).astype(np.int32)
    draws = np.concatenate([draws, (draws + 1) % 4], axis=1)
    for fused in (True, False):
        spec = SolverSpec(loss="lasso", P=256, rounds=16, fused=fused)
        rd = tops.block_shotgun_solve(pd, spec=spec, blk_idx=draws)
        rs = tops.block_shotgun_solve(ps, spec=spec, blk_idx=draws)
        np.testing.assert_allclose(rs.trace.objective.numpy(),
                                   rd.trace.objective.numpy(), rtol=1e-4)
        np.testing.assert_array_equal(rs.trace.nnz.numpy(),
                                      rd.trace.nnz.numpy())
        np.testing.assert_allclose(rs.x.numpy(), rd.x.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_fused_logistic_bcsc_optimum_matches_jax_scalar():
    """The port's fused logistic BlockedCSC solve reaches the optimum of
    JAX's scalar Shotgun (tests/test_logreg_fused.py:115)."""
    S, y, _ = jsyn.logistic_data(seed=4, n=512, d=256, density=0.05,
                                 layout="bcsc")
    jp = jobj.make_problem(S, y, lam=0.3, loss="logistic")
    tp = convert.problem_from_numpy(_port_bcsc(jp.A), np.asarray(jp.y),
                                    float(jp.lam), "logistic",
                                    device="cpu")
    rf = tops.block_shotgun_solve(
        tp, torch.Generator().manual_seed(0),
        spec=SolverSpec(loss="logistic", P=128, rounds=600, fused=True))
    rs = shotgun_solve(jp, jax.random.PRNGKey(1),
                       spec=JSpec(loss="logistic", P=128, rounds=2000))
    ff, fs = float(rf.trace.objective[-1]), float(rs.trace.objective[-1])
    assert abs(ff - fs) / abs(fs) < 1e-3, (ff, fs)
    np.testing.assert_allclose(rf.x.numpy(), np.asarray(rs.x), atol=1e-4)


def test_sparse_solve_generator_draws_and_rejections():
    _, tp = _problems("lasso", n=128, d=600)
    spec = SolverSpec(loss="lasso", P=2 * BLOCK, rounds=8, fused=True)
    a = tops.block_shotgun_solve(tp, torch.Generator().manual_seed(5),
                                 spec=spec)
    b = tops.block_shotgun_solve(tp, torch.Generator().manual_seed(5),
                                 spec=spec)
    assert torch.equal(a.x, b.x) and a.x.shape == (600,)
    assert torch.equal(a.trace.objective, b.trace.objective)
    with pytest.raises(ValueError, match="rounds_per_launch"):
        tops.block_shotgun_solve(tp, spec=SolverSpec(P=128, rounds=9,
                                                     fused=True),
                                 blk_idx=np.zeros((9, 1), np.int32))
    with pytest.raises(ValueError, match=r"\[0, 5\)"):
        tops.block_shotgun_solve(tp, spec=SolverSpec(P=128, rounds=8),
                                 blk_idx=np.full((8, 1), 5, np.int32))
    with pytest.raises(ValueError, match="K=6"):
        tops.block_shotgun_solve(tp, torch.Generator(),
                                 spec=SolverSpec(P=6 * BLOCK, rounds=8))


# ---------------------------------------------------------------------------
# Spectral radius and P* (core/spectral.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["dense", "bcsc"])
def test_spectral_radius_and_pstar_match_jax(layout):
    S, y, _ = jsyn.large_sparse(seed=5, n=256, d=512, density=0.02,
                                layout=layout)
    jp = jobj.make_problem(S, y, lam=0.5)
    A = (_port_bcsc(jp.A) if layout == "bcsc"
         else torch.tensor(np.asarray(jp.A)))
    key = jax.random.PRNGKey(0)
    v0 = np.asarray(jax.random.normal(key, (jp.d,), jnp.float32))
    rho_t = float(tspec.spectral_radius(A, iters=100, v0=_t(v0)))
    rho_j = float(jspec.spectral_radius(jp.A, key, 100))
    np.testing.assert_allclose(rho_t, rho_j, rtol=1e-3)
    assert tspec.p_star(A, v0=_t(v0)) == jspec.p_star(jp.A, key)
    assert tspec.p_star_blocks(A, v0=_t(v0)) == jspec.p_star_blocks(
        jp.A, key=key)
    # the default start vector converges to the same radius
    np.testing.assert_allclose(float(tspec.spectral_radius(A)), rho_j,
                               rtol=1e-3)
