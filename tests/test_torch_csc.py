"""Designs with an overflow store (``BlockedCSC.from_csc``) on the CPU, at
tiny sizes: the store round-trips to the dense matrix with columns 1×, 3×
and 40× deeper than the tile; the linear ops and the bfloat16 cast match
plain ``torch`` on the dense matrix; a guarded Newton solve and a Lasso
solve through ``block_shotgun_solve`` match the JAX package's solves of
the same matrix on its draws; a design with no spilled column takes
today's path bit for bit; and the paths that read tiles only refuse a
store."""
import numpy as np
import pytest
import torch

import jax  # noqa: E402

from repro.core import objectives as jobj  # noqa: E402
from repro.core.health import GuardConfig as JGuard  # noqa: E402
from repro.core.spec import SolverSpec as JSpec  # noqa: E402
from repro.data import sparse as jsp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.batched import batched_draw_blocks  # noqa: E402
from repro_torch.core import batched as tcb  # noqa: E402
from repro_torch.core import objectives as tobj  # noqa: E402
from repro_torch.core.health import GuardConfig  # noqa: E402
from repro_torch.core.spec import SolverSpec  # noqa: E402
from repro_torch.data import sparse as tsp  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

TILE = 8


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dense(n=400, d=300, deep=(8, 24, 320), seed=0):
    """A sparse (n, d) matrix whose columns 0, 131, 262 hold ``deep``
    entries and the rest at most a handful."""
    rng = np.random.default_rng(seed)
    A = ((rng.random((n, d)) < 0.004) * rng.standard_normal((n, d)))
    for c, k in zip((0, 131, 262), deep):
        A[:, c] = 0.0
        A[rng.permutation(n)[:k], c] = rng.standard_normal(k)
    return A.astype(np.float32)


def _csc(A):
    cols, rows = np.nonzero(A.T)
    col_ptr = np.r_[0, np.cumsum(np.bincount(cols, minlength=A.shape[1]))]
    return col_ptr, rows, A[rows, cols]


def _from_csc(A, tile=TILE):
    return tsp.BlockedCSC.from_csc(*_csc(A), *A.shape, tile=tile,
                                   device="cpu")


@pytest.mark.parametrize("factor", [1, 3, 40])
def test_from_csc_round_trips_to_dense(factor):
    A = _dense(deep=(TILE, TILE * factor // 2 + 1, TILE * factor))
    S = _from_csc(A)
    assert torch.equal(S.to_dense(), torch.from_numpy(A))
    assert int(S.nnz) == int((A != 0).sum())
    if factor == 1:
        assert S.ovf is None
        return
    o = S.ovf
    depth = TILE * factor - TILE
    assert o.depth == depth and o.rows.numel() == int(
        np.maximum((A != 0).sum(0) - TILE, 0).sum())
    assert int(o.seg_ptr[-1]) == o.seg_col.numel() == int(np.ceil(
        np.maximum((A != 0).sum(0) - TILE, 0) / tsp.SEG).sum())
    assert o.seg_slots == max(np.diff(o.blk_seg))


def test_linear_ops_and_bf16_match_dense():
    A = _dense()
    S = _from_csc(A)
    At = torch.from_numpy(A).double()
    g = torch.Generator().manual_seed(1)
    x, r = torch.randn(A.shape[1], generator=g), torch.randn(
        A.shape[0], generator=g)
    torch.testing.assert_close(S.matvec(x), (At @ x.double()).float(),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(S.rmatvec(r), (At.T @ r.double()).float(),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(S.col_norms(), At.norm(dim=0).float(),
                               rtol=1e-6, atol=1e-6)
    B = S.astype(torch.bfloat16)
    assert B.ovf.vals.dtype == torch.bfloat16
    Ab = torch.from_numpy(A).to(torch.bfloat16).double()
    assert torch.equal(B.to_dense().double(), Ab)
    torch.testing.assert_close(B.matvec(x), (Ab @ x.double()).float(),
                               rtol=1e-5, atol=1e-5)
    cols = torch.tensor([0, 5, 262])
    got = S.gather_cols(cols)
    want = torch.zeros(A.shape[0], 3)
    for j in range(3):
        want[:, j].index_add_(0, got.rows[j].long(), got.vals[j])
    assert torch.equal(want, torch.from_numpy(A[:, cols.numpy()]))


def _jax_draws(key, rounds, K, nblk):
    keys = jax.random.split(key, rounds)[None]
    return np.asarray(batched_draw_blocks(keys, K, nblk))[0]


@pytest.mark.parametrize("loss,newton", [("lasso", False),
                                         ("logistic", True)])
def test_overflow_solves_match_jax(loss, newton):
    """The same matrix, tiled whole by the JAX package and with an overflow
    store here, solved on the same draws (fused, K = 2)."""
    A = _dense(n=160, d=600, deep=(40, 90, 160), seed=4)
    rng = np.random.default_rng(5)
    y = (np.where(rng.random(A.shape[0]) < 0.5, 1.0, -1.0) if newton
         else rng.standard_normal(A.shape[0])).astype(np.float32)
    jp = jobj.make_problem(jsp.BlockedCSC.from_dense(A), y, lam=0.1,
                           loss=loss)
    tp = tobj.make_problem(_from_csc(A), y, float(jp.lam), loss=loss,
                           device="cpu")
    assert tp.A.ovf is not None
    key = jax.random.PRNGKey(2)
    guard = dict(guard=JGuard(10.0, 1)) if newton else {}
    kw = dict(loss=loss, P=256, rounds=16, fused=True, newton=newton)
    jres = jops.block_shotgun_solve(jp, key, spec=JSpec(**kw, **guard))
    tres = tops.block_shotgun_solve(
        tp, spec=SolverSpec(**kw, **({"guard": GuardConfig(10.0, 1)}
                                     if newton else {})),
        blk_idx=_jax_draws(key, 16, 2, jp.A.nblk))
    np.testing.assert_allclose(tres.trace.objective.numpy(),
                               np.asarray(jres.trace.objective), rtol=1e-4)
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x),
                               rtol=1e-4, atol=1e-4)
    assert int(tres.status) == int(jres.status)


def test_empty_overflow_takes_todays_path_bit_for_bit():
    """No column deeper than the tile: no store, the tiles ``from_dense``
    packs, and a fused solve equal bit for bit to theirs."""
    A = _dense(deep=(5, 6, 7))
    S, D = _from_csc(A), tsp.BlockedCSC.from_dense(A, tile=TILE,
                                                   device="cpu")
    assert S.ovf is None
    assert torch.equal(S.rows, D.rows) and torch.equal(S.vals, D.vals)
    y = np.random.default_rng(1).standard_normal(A.shape[0]).astype(
        np.float32)
    spec = SolverSpec(P=256, rounds=8, fused=True)
    idx = np.random.default_rng(2).integers(0, S.nblk, (8, 2)).astype(
        np.int32)
    a, b = (tops.block_shotgun_solve(
        tobj.make_problem(M, y, 0.1, device="cpu"), spec=spec, blk_idx=idx,
        rounds_per_launch=4) for M in (S, D))
    assert torch.equal(a.x, b.x) and torch.equal(a.z, b.z)
    assert torch.equal(a.trace.objective, b.trace.objective)


def test_tiles_only_paths_refuse_a_store():
    """The served path, the two-kernel round and the tile views name the
    overflow store instead of dropping its entries."""
    A = _dense()
    prob = tobj.make_problem(_from_csc(A), np.ones(A.shape[0], np.float32),
                             0.1, device="cpu")
    with pytest.raises(ValueError, match="overflow store"):
        tcb.normalize_problem(prob, tcb.batch_meta_of(prob))
    with pytest.raises(ValueError, match="overflow store"):
        tops.block_shotgun_solve(prob, torch.Generator().manual_seed(0),
                                 spec=SolverSpec(P=128, rounds=2))
    for view in (lambda S: S.col_blocks(0, 1), lambda S: S.on_canvas(3, 8),
                 lambda S: S.row_table()):
        with pytest.raises(ValueError, match="overflow store"):
            view(prob.A)


def test_overflow_layouts_sort_each_blocks_entries_by_row():
    """Each block's run of the order holds its stored tile slots and
    spilled entries, by row, cut into row ranges by the table."""
    A = _dense()
    S = _from_csc(A)
    od, rs = S.scatter_order(), S.range_starts()
    T = S.tile * S.block
    for b in range(S.nblk):
        lo = b * T + int(S.ovf.ptr[b * S.block])
        run = od.order[lo: lo + int(od.count[b])].long()
        ob = int(S.ovf.ptr[b * S.block])
        rows = torch.where(run < T, S.rows[b].reshape(-1)[run.clamp_max(
            T - 1)], S.ovf.rows[(ob + run - T).clamp_min(0)]).long()
        assert bool(torch.all(rows[1:] >= rows[:-1]))
        q = torch.arange(rs.shape[1] - 1)
        want = torch.searchsorted(rows, (q * tsp.RANGE_ROWS).clamp_max(
            S.n))
        assert torch.equal(rs[b, :-1].long(), want)
        assert int(rs[b, -1]) == int(od.count[b])
