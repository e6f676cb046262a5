"""BlockedCSC Block-Shotgun kernels for Hopper and their plain PyTorch
versions.

Port of ``repro.kernels.shotgun_sparse``.  Four kernels, written in CUDA
C++ in ``csrc/shotgun_sparse.cu`` and built by ``kernels/_build.py``:

  sparse_gather_block_matvec   g[k] = Σ_t vals·r[rows] over block k's tile
  sparse_scatter_block_update  z + scatter-add of vals·δ_k at rows
  fused_sparse_shotgun_rounds  R sparse Block-Shotgun rounds in one launch
  fused_sparse_shotgun_delta_rounds  R rounds against a margin snapshot,
                               emitting Δz (the sharded driver's engine)

Each wrapper keeps the JAX signature and return tuple, minus ``interpret``;
the scatter and the fused kernels take the container's row-sorted slot
order as ``order=`` (``BlockedCSC.scatter_order()``, cached per problem;
built here when not given) and its range-start table as ``rstart=``
(``BlockedCSC.range_starts()``, likewise).  A wrapper given
CPU tensors runs its plain version (``*_plain``, same module, same
dataflow); given CUDA tensors it launches the kernel or raises — it never
falls back.  ``LAUNCHES`` counts kernel launches per wrapper.

There is no sample mask on the sparse path: z is full length (n,), and
padded tile slots (row 0, value 0) are additive no-ops in both directions
(0·δ is NaN for a non-finite δ, as in the reference).

``fused_sparse_shotgun_rounds`` also takes a design's overflow store
(``ovf=``, ``data/sparse.py::Overflow``): a column's spilled segments add
their partial sums to its tile sum in segment order, and its spilled
entries reach z through the same row-range owners as its tile slots.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import obs
from repro_torch.data.sparse import (BLOCK, RANGE_ROWS, SEG, Overflow,
                                     ScatterOrder, overflow_layouts,
                                     range_starts, scatter_order)
from repro_torch.kernels.shotgun_block import (LASSO, _RAW_STREAM, Loss, _as,
                                               _check_rc, _contig,
                                               _launch_device, _lib,
                                               _loss_code, _on_cuda, _ptr,
                                               _scalars, _soft_threshold,
                                               _stream, resolve_loss)

# Kernel launches per wrapper (``reset_launches`` zeroes them).
LAUNCHES = {"fused_sparse_shotgun_rounds": 0,
            "sparse_gather_block_matvec": 0,
            "sparse_scatter_block_update": 0,
            "fused_sparse_shotgun_delta_rounds": 0}

_THREADS = 256     # CUDA threads per block, every sparse kernel
_WARPS = _THREADS // 32
_XCHUNK = 4096     # |x| / nnz partial: elements per item (fused kernel)
_OVF_GRID = 16     # grid-size query's bit for the OVF kernel

# The host side of a launch's overflow work (its workspaces, sized from the
# store's segment slots on the host), and its counters: launches, the
# segments of the drawn blocks that they cover (counted on the device), and
# BC's row items, with those whose inputs a warp loaded under its last one.
OVERFLOW_SPAN = "repro_torch.solve.overflow"


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def block_delta(x_sel, g, lam, beta):
    """The per-block Shotgun update δ_B = S(x_B − g_B/β, λ/β) − x_B (Alg. 2
    soft-threshold step), shared by ``ops.sparse_block_shotgun_round`` and
    the fused plain version."""
    return _soft_threshold(x_sel - g / beta, lam / beta) - x_sel


# ---------------------------------------------------------------------------
# Checks and plumbing
# ---------------------------------------------------------------------------

def _check_tiles(rows: torch.Tensor, vals: torch.Tensor) -> tuple[int, int]:
    """Raise (don't assert) when the tiles are not what the kernels index:
    (nblk, tile, 128) int32 rows and f32/bf16 vals of one shape (any tile
    depth >= 1)."""
    if rows.dim() != 3 or rows.shape != vals.shape:
        raise ValueError(f"rows {tuple(rows.shape)} and vals "
                         f"{tuple(vals.shape)} must be one (nblk, tile, "
                         f"{BLOCK}) shape")
    nblk, tile, block = rows.shape
    if block != BLOCK:
        raise ValueError(f"block width {block} != {BLOCK}")
    if tile < 1:
        raise ValueError(f"tile={tile} must be >= 1")
    if rows.dtype != torch.int32:
        raise ValueError(f"rows must be int32, got {rows.dtype}")
    if vals.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"vals must be float32 or bfloat16, got {vals.dtype}")
    return nblk, tile


def _require_contiguous(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous rows/vals "
                             "tiles")


def _check_stamps(stamps, R: int, dev, ovf: bool = False) -> None:
    """Two clock stamps a round and six more; an OVF launch (a design with
    an overflow store) stamps three a round."""
    need = (3 if ovf else 2) * R + 6
    if stamps is not None and (stamps.dtype != torch.int64
                               or stamps.numel() < need
                               or stamps.device != dev):
        raise ValueError(f"stamps must be an int64 tensor of >= {need} "
                         f"elements on {dev}")


def _check_rstart(rstart, lead: tuple, nblk: int, n: int, dev) -> None:
    """Raise unless ``rstart`` is None or a contiguous int32 range-start
    table of shape ``lead + (nblk, ceil(n / RANGE_ROWS) + 1)`` on ``dev``,
    the operands' device (a table elsewhere would reach the kernel as a
    pointer it cannot read)."""
    want = (*lead, nblk, -(-n // RANGE_ROWS) + 1)
    if rstart is not None and (rstart.dtype != torch.int32
                               or not rstart.is_contiguous()
                               or tuple(rstart.shape) != want
                               or rstart.device != dev):
        raise ValueError(f"rstart must be a contiguous int32 {want} "
                         f"range-start table on {dev}, got {rstart.dtype} "
                         f"{tuple(rstart.shape)} on {rstart.device}")


def _scalar_args(values, S: int, dev):
    """The fused kernels' four scalars [lam, beta, k_eff, guard_f]: a
    ctypes array of 4 device pointers, a ctypes array of 4 floats and the
    tensors behind the pointers.  A tensor stays on the device (never read
    back): S values, one a slot (a single value serves every slot), read by
    the kernel through its pointer.  A number goes by value."""
    ptrs, nums, keep = (ctypes.c_void_p * 4)(), (ctypes.c_float * 4)(), []
    for j, v in enumerate(values):
        if not isinstance(v, torch.Tensor):
            nums[j] = float(v)
            continue
        t = v.to(device=dev, dtype=torch.float32)
        if t.numel() == 1:
            t = t.reshape(1).expand(S)
        if tuple(t.shape) != (S,):
            raise ValueError(f"scalar of shape {tuple(v.shape)} for {S} "
                             f"slot(s)")
        t = t.contiguous()
        keep.append(t)
        ptrs[j] = t.data_ptr()
    return ptrs, nums, keep


def _take_tiles(rows, vals, idx):
    """(K, tile, 128) long rows and f32 vals of the drawn blocks."""
    idx = idx.long()
    return rows[idx].long(), vals[idx].float()


def _scatter_plain(rows_k, vals_k, z, delta):
    """z + Σ_k A_{B_k} δ_k, each row's sum in the fused kernels' order:
    block k's contributions land in row k of a (K, n) buffer, then the rows
    are added to z in k order."""
    K = rows_k.shape[0]
    n = z.shape[0]
    contrib = vals_k * delta[:, None, :]
    buf = torch.zeros((K, n), dtype=torch.float32, device=z.device)
    for k in range(K):
        buf[k].index_add_(0, rows_k[k].reshape(-1), contrib[k].reshape(-1))
    out = z.float().clone()
    for k in range(K):
        out = out + buf[k]
    return out


# ---------------------------------------------------------------------------
# Kernel 1: g[k] = A_{B_k}ᵀ r from nnz tiles
# ---------------------------------------------------------------------------

def sparse_gather_block_matvec_plain(rows, vals, r, blk_idx):
    """Plain version of ``sparse_gather_block_matvec``."""
    rows_k, vals_k = _take_tiles(rows, vals, blk_idx)
    return torch.sum(vals_k * r.float()[rows_k], dim=1)


def sparse_gather_block_matvec(rows, vals, r, blk_idx):
    """g (K, 128) f32 = A_Bᵀ r for the drawn blocks, from nnz tiles.

    rows/vals (nblk, tile, 128) BlockedCSC tiles; r (n,); blk_idx (K,)."""
    _, tile = _check_tiles(rows, vals)
    K = blk_idx.shape[0]
    dev = _launch_device(vals, rows, r, blk_idx)
    if dev < 0:
        return sparse_gather_block_matvec_plain(rows, vals, r, blk_idx)
    _require_contiguous(rows, vals)
    lib = _lib()
    rv = _as(r, torch.float32)
    idx = _as(blk_idx, torch.int32)
    g = torch.empty((K, BLOCK), dtype=torch.float32, device=vals.device)
    rc = lib.sp_gather_block_matvec(
        rows.data_ptr(), vals.data_ptr(), vals.dtype == torch.bfloat16,
        rv.data_ptr(), idx.data_ptr(), g.data_ptr(), tile, K,
        _RAW_STREAM(dev))
    _check_rc(rc, "sparse_gather_block_matvec")
    LAUNCHES["sparse_gather_block_matvec"] += 1
    return g


# ---------------------------------------------------------------------------
# Kernel 2: z + Σ_k A_{B_k} δ_k from nnz tiles
# ---------------------------------------------------------------------------

def sparse_scatter_block_update_plain(rows, vals, z, blk_idx, delta, *,
                                      order: ScatterOrder | None = None,
                                      rstart: torch.Tensor | None = None):
    """Plain version of ``sparse_scatter_block_update``, with the kernel's
    dataflow: row range q takes, for each k in order, the segment
    ``rstart[b_k, q] .. rstart[b_k, q + 1]`` of block b_k's row-sorted
    stored slots (``order``); its rows get the run sums s_k added to z in k
    order; the padding terms Σ_c 0·δ_k,c over the columns with a padding
    slot reach row 0 last.  ``order``/``rstart`` are built when not given."""
    n = z.shape[0]
    od = scatter_order(rows, vals) if order is None else order
    rs = range_starts(rows, od, n) if rstart is None else rstart
    nblk, tile, block = rows.shape
    nq = rs.shape[1] - 1
    flat_rows = rows.reshape(nblk, -1).long()
    flat_vals = vals.reshape(nblk, -1).float()
    delta = delta.float()
    out = z.float().clone()
    for k, b in enumerate(blk_idx.long().tolist()):
        bounds = rs[b].long()
        pos = torch.arange(int(bounds[0]), int(bounds[-1]), device=z.device)
        q = torch.repeat_interleave(torch.arange(nq, device=z.device),
                                    bounds[1:] - bounds[:-1])
        s = od.order[b].long()[pos]
        row = flat_rows[b][s]
        if bool(torch.any(row // RANGE_ROWS != q)):
            raise ValueError("rstart does not match the tiles' row-sorted "
                             "order (range_starts of rows, order, n)")
        run = torch.zeros(n, dtype=torch.float32, device=z.device)
        run.index_add_(0, row, flat_vals[b][s] * delta[k][s % block])
        out = out + run
    for k, b in enumerate(blk_idx.long().tolist()):
        out[0] = out[0] + torch.sum(0.0 * delta[k][od.zmask[b].bool()])
    return out.to(z.dtype)


def sparse_scatter_block_update(rows, vals, z, blk_idx, delta, *,
                                order: ScatterOrder | None = None,
                                rstart: torch.Tensor | None = None):
    """z_new = z + Σ_k A_{B_k} δ_k from nnz tiles — f32 accumulation, in a
    fixed order (repeat runs are bit-identical).  delta (K, 128); duplicate
    blocks in ``blk_idx`` accumulate.  ``order``/``rstart`` are the
    container's ``scatter_order()``/``range_starts()`` (built here when not
    given)."""
    nblk, tile = _check_tiles(rows, vals)
    K = blk_idx.shape[0]
    n = z.shape[0]
    dev = _launch_device(vals, rows, z, blk_idx, delta)
    if dev < 0:
        return sparse_scatter_block_update_plain(rows, vals, z, blk_idx,
                                                 delta, order=order,
                                                 rstart=rstart)
    _require_contiguous(rows, vals)
    _check_rstart(rstart, (), nblk, n, vals.device)
    od = scatter_order(rows, vals) if order is None else order
    rs = range_starts(rows, od, n) if rstart is None else rstart
    lib = _lib()
    z_in = _as(z, torch.float32)
    idx = _as(blk_idx, torch.int32)
    dlt = _as(delta, torch.float32)
    z_out = torch.empty(n, dtype=torch.float32, device=vals.device)
    rc = lib.sp_scatter_block_update(
        rows.data_ptr(), vals.data_ptr(), vals.dtype == torch.bfloat16,
        od.order.data_ptr(), rs.data_ptr(), od.zmask.data_ptr(),
        z_in.data_ptr(), idx.data_ptr(), dlt.data_ptr(), z_out.data_ptr(), n,
        tile, K, _RAW_STREAM(dev))
    _check_rc(rc, "sparse_scatter_block_update")
    LAUNCHES["sparse_scatter_block_update"] += 1
    return z_out if z.dtype == torch.float32 else z_out.to(z.dtype)


# ---------------------------------------------------------------------------
# Kernel 3: fused multi-round sparse Shotgun — R rounds per launch
# ---------------------------------------------------------------------------

def _spilled(ovf: Overflow, b: int):
    """Block b's spilled entries: (rows long, vals f32, columns long within
    the block, segment of each within the block)."""
    lo, hi = (int(v) for v in ovf.ptr[[b * BLOCK, (b + 1) * BLOCK]])
    cols = ovf.cols[lo:hi].long()
    cj = b * BLOCK + cols
    seg = (ovf.seg_ptr[cj].long() - int(ovf.seg_ptr[b * BLOCK])
           + (torch.arange(lo, hi, device=cols.device) - ovf.ptr[cj]) // SEG)
    return ovf.rows[lo:hi].long(), ovf.vals[lo:hi].float(), cols, seg


def _spilled_sums(ovf: Overflow, idx, terms):
    """(K, 128): each drawn block's columns' sums of ``terms(rows, vals)``
    over its spilled entries, as the kernel adds them: each segment's sum,
    then a column's segment sums in segment order."""
    out = []
    for b in idx.tolist():
        r, v, cols, seg = _spilled(ovf, b)
        nseg = int(ovf.blk_seg[b + 1] - ovf.blk_seg[b])
        part = torch.zeros(nseg, device=v.device).index_add_(0, seg,
                                                             terms(r, v))
        col_of = torch.zeros(nseg, dtype=torch.long, device=v.device)
        col_of[seg] = cols
        out.append(torch.zeros(BLOCK, device=v.device).index_add_(
            0, col_of, part))
    return torch.stack(out)


def _plain_round(ls: Loss, rows, vals, z, xb, idx, lam, beta, y, one, live,
                 ovf: Overflow | None = None):
    """One round of the fused plain versions: every δ from the residual
    (and Newton weights) of the round-start margin z and the pre-round x;
    x[blk] += δ in k order in place.  Returns the drawn tiles and δ."""
    rows_k, vals_k = _take_tiles(rows, vals, idx)
    res = ls.residual(z, y, one)
    g = torch.sum(vals_k * res[rows_k], dim=1)
    if ovf is not None:
        g = g + _spilled_sums(ovf, idx, lambda r, v: v * res[r])
    if ls.newton:
        w = ls.curvature_weights(z, y, one)
        hs = torch.sum(vals_k * vals_k * w[rows_k], dim=1)
        if ovf is not None:
            hs = hs + _spilled_sums(ovf, idx, lambda r, v: v * v * w[r])
        h = torch.clamp_min(hs, 1e-8)
    else:
        h = beta
    dlt = block_delta(xb[idx], g, lam, h) * live
    for k in range(idx.shape[0]):
        xb.index_add_(0, idx[k:k + 1], dlt[k:k + 1])
    return rows_k, vals_k, dlt


def _scatter_spilled(ovf: Overflow, idx, z, delta):
    """z + each drawn block's spilled entries' vals·δ, block by block."""
    out = z
    for k, b in enumerate(idx.tolist()):
        r, v, cols, _ = _spilled(ovf, b)
        out = out + torch.zeros_like(z).index_add_(0, r, v * delta[k][cols])
    return out


def fused_sparse_shotgun_rounds_plain(rows, vals, z, x, blk_idx, lam, beta,
                                      y, loss: str | Loss = LASSO,
                                      k_eff=None, guard_f=None,
                                      ovf: Overflow | None = None):
    """Plain version of ``fused_sparse_shotgun_rounds``, with the kernel's
    dataflow: each round takes the residual (and Newton weights) of the
    round-start margin, computes every δ from the pre-round x, adds block
    k's contributions to z through row k of a (K, n) buffer in k order,
    applies x[blk] += δ in k order at round end (duplicates accumulate),
    then computes F and nnz from the updated (x, z).  With ``ovf`` a
    column's spilled terms join its sums segment by segment, and the
    spilled entries' vals·δ reach z after the tiles'."""
    ls = resolve_loss(loss)
    nblk, _ = _check_tiles(rows, vals)
    R, K = blk_idx.shape
    lam, beta, k_eff, guard = _scalars(
        lam, beta, K if k_eff is None else k_eff,
        math.inf if guard_f is None else guard_f, vals.device).unbind()
    y = y.float()
    one = torch.ones_like(y)
    z = z.float().clone()
    xb = x.float().reshape(nblk, BLOCK).clone()
    live = (torch.arange(K, device=vals.device) < k_eff.int()).float()[:, None]
    health = torch.zeros((), dtype=torch.float32, device=vals.device)
    fs, nnzs = [], []
    for t in range(R):
        idx = blk_idx[t].long()
        rows_k, vals_k, dlt = _plain_round(ls, rows, vals, z, xb, idx, lam,
                                           beta, y, one, live, ovf)
        z = _scatter_plain(rows_k, vals_k, z, dlt)
        if ovf is not None:
            z = _scatter_spilled(ovf, idx, z, dlt)
        f = ls.objective(z, y, one, xb, lam)
        bad = ~torch.isfinite(f) | (f > guard)
        health = torch.maximum(health, bad.float())
        fs.append(f)
        nnzs.append(torch.sum(xb != 0))
    return (xb.reshape(-1), z, torch.stack(fs),
            torch.stack(nnzs).to(torch.int32), health)


def _bc_items(n: int, R: int, warps: int | None) -> tuple[int, int]:
    """BC's row items in an OVF launch of R rounds over n rows (one a
    256-row tile a round), and those a warp starts with its range-start
    pairs already loaded under its previous item: each of the grid's
    ``warps`` walks items w, w + warps, …, so all but its first.  None
    (the plain version on the CPU) walks no warps."""
    n_lt = -(-n // _THREADS)
    return R * n_lt, 0 if warps is None else R * (n_lt - min(n_lt, warps))


def _ovf_warps(ls: Loss, dtype, dev) -> int:
    """Warps in the OVF kernel's cooperative grid on ``dev``."""
    with torch.cuda.device(dev):
        g = _lib().sp_fused_grid_blocks(int(dtype == torch.bfloat16),
                                        _loss_code(ls) | _OVF_GRID)
    if g <= 0:
        raise RuntimeError(f"sp_fused_grid_blocks: CUDA error {-g}")
    return _WARPS * g


def _overflow_work(ovf: Overflow, ls: Loss, nblk: int, n: int, blk_idx,
                   dtype, on_cuda: bool, dev):
    """The host side of a launch's overflow work: check the store, count
    the launch, the drawn blocks' segments (a device sum, read after the
    profiled window) and BC's row items (``_bc_items``), and on the card
    allocate the workspaces (gpart, hpart (K, seg_slots); gt, ht (K, 128);
    the h ones one element unless Newton)."""
    R, K = blk_idx.shape
    with obs.span(OVERFLOW_SPAN):
        if K > _THREADS:
            raise ValueError(f"K={K} blocks a round > {_THREADS}: the "
                             "overflow launch takes at most that many")
        if ovf.ptr.numel() != nblk * BLOCK + 1 or ovf.vals.dtype != dtype:
            raise ValueError(f"overflow store of {ovf.ptr.numel() - 1} "
                             f"columns in {ovf.vals.dtype} for {nblk} "
                             f"blocks of {dtype} tiles")
        slots = max(1, ovf.seg_slots)
        obs.count("solver.overflow_launches", 1)
        if obs.enabled():
            drawn = blk_idx.reshape(-1).to(ovf.seg_ptr.device)
            obs.count("solver.overflow_segments",
                      ovf.seg_ptr[BLOCK::BLOCK].index_select(0, drawn).sum()
                      - ovf.seg_ptr[:-1:BLOCK].index_select(0, drawn).sum())
            items, piped = _bc_items(
                n, R, _ovf_warps(ls, dtype, dev) if on_cuda else None)
            obs.count("solver.overflow_bc_items", items)
            obs.count("solver.overflow_bc_pipelined_items", piped)
        if not on_cuda:
            return None
        f32 = dict(dtype=torch.float32, device=dev)
        return (torch.empty((K, slots), **f32),
                torch.empty((K, slots) if ls.newton else 1, **f32),
                torch.empty((K, BLOCK), **f32),
                torch.empty((K, BLOCK) if ls.newton else 1, **f32))


def fused_sparse_shotgun_rounds(rows, vals, z, x, blk_idx, lam, beta, y,
                                loss: str | Loss = LASSO, k_eff=None,
                                guard_f=None, *,
                                order: ScatterOrder | None = None,
                                rstart: torch.Tensor | None = None,
                                stamps: torch.Tensor | None = None,
                                ovf: Overflow | None = None):
    """R Block-Shotgun rounds over BlockedCSC tiles in ONE kernel launch.

    rows/vals  (nblk, tile, 128) BlockedCSC tiles, vals f32 or bf16.
    z          (n,) margin A x;  x (nblk·128,) iterate;  y (n,).
    blk_idx    (R, K) int — round t updates blocks blk_idx[t, 0..K-1]
               (duplicates allowed, multiset semantics).
    loss       ``"lasso"`` / ``"logistic"`` / ``"logistic_newton"`` or a
               ``Loss``; Newton divides by max(Σ vals²·w[rows], 1e-8).
    k_eff      blocks k >= k_eff are drawn but masked out.  None = all K.
    guard_f    health trips when a round's F exceeds it or goes non-finite.
    order/rstart  the container's ``scatter_order()`` and
               ``range_starts()`` (built here when not given).
    stamps     optional (2R + 6,) int64 CUDA tensor: the grid's last block
               writes the SM clock at launch start, after each grid-wide
               barrier (two a round: A, then BC) and at the end (phase
               breakdown), then the card's ns timer at launch start and at
               the end (ignored on the CPU).
    ovf        the design's overflow store, or None.  With it, ``order``
               and ``rstart`` are ``overflow_layouts``'s (the container's
               own), K is at most 256, and the launch adds a phase a round
               (A, the spilled segments' partials beside the tile sums;
               A2, a column's sums and δ; then BC, a warp a row item):
               ``stamps`` then takes (3R + 6,), three barriers a round (A,
               A2, BC).  Under a profiler a few small device operations
               beside the launch count the drawn blocks' segments.

    ``lam``, ``beta``, ``k_eff`` and ``guard_f`` are numbers (passed by
    value) or one-element device tensors (read by the kernel, never read
    back).  With operands in the kernel's types (f32 z, x and y, int32
    blk_idx), a call is the one launch and no other device operation.

    Returns (x_new (nblk·128,) f32, z_new (n,) f32, f (R,) f32,
    nnz (R,) int32, health () f32).
    """
    ls = resolve_loss(loss)
    nblk, tile = _check_tiles(rows, vals)
    R, K = blk_idx.shape
    n = z.shape[0]
    dev = vals.device
    _check_rstart(rstart, (), nblk, n, dev)
    on_cuda = _on_cuda(rows, vals, z, x, blk_idx, y,
                       *(() if ovf is None else (ovf.rows, ovf.vals)))
    if ovf is not None:
        work = _overflow_work(ovf, ls, nblk, n, blk_idx, vals.dtype,
                              on_cuda, dev)
    if not on_cuda:
        return fused_sparse_shotgun_rounds_plain(rows, vals, z, x, blk_idx,
                                                 lam, beta, y, ls, k_eff,
                                                 guard_f, ovf=ovf)
    _require_contiguous(rows, vals)
    if ovf is not None and (order is None or rstart is None):
        order, rstart = overflow_layouts(rows, vals, ovf, n)
    od = scatter_order(rows, vals) if order is None else order
    rs = range_starts(rows, od, n) if rstart is None else rstart
    if ovf is not None and od.order.numel() != rows.numel() + \
            ovf.rows.numel():
        raise ValueError("order must be overflow_layouts' (the container's "
                         "scatter_order()) for a design with an overflow "
                         "store")
    from repro_torch.kernels import _build
    lib = _build.load()
    d_pad = nblk * BLOCK
    sp, sv, keep = _scalar_args(
        (lam, beta, K if k_eff is None else k_eff,
         math.inf if guard_f is None else guard_f), 1, dev)
    idx = _contig(blk_idx, torch.int32)
    yv = _contig(y, torch.float32)
    z0 = _contig(z, torch.float32)
    x0 = _contig(x, torch.float32)
    f32 = dict(dtype=torch.float32, device=dev)
    n_xc = -(-d_pad // _XCHUNK)
    z_out = torch.empty(n, **f32)            # every output filled by the
    x_out = torch.empty(d_pad, **f32)        # kernel
    r = torch.empty(n, **f32)
    w = torch.empty(n if ls.newton else 1, **f32)
    dlt = torch.empty((K, BLOCK), **f32)
    lpart = torch.empty((2, -(-n // _THREADS)), **f32)
    xl1 = torch.empty(n_xc, **f32)
    xnz = torch.empty(n_xc, dtype=torch.int32, device=dev)
    f = torch.empty(R, **f32)
    nnz = torch.empty(R, dtype=torch.int32, device=dev)
    health = torch.empty((), **f32)
    _check_stamps(stamps, R, dev, ovf is not None)
    args = (_ptr(rows), _ptr(vals), int(vals.dtype == torch.bfloat16),
            _loss_code(ls), _ptr(od.order), _ptr(rs), _ptr(od.zmask),
            _ptr(yv), _ptr(idx), sp, sv, _ptr(z0), _ptr(z_out), _ptr(x0),
            _ptr(x_out), _ptr(r), _ptr(w), _ptr(dlt), _ptr(lpart),
            _ptr(xl1), _ptr(xnz), _ptr(f), _ptr(nnz), _ptr(health),
            _ptr(stamps) if stamps is not None else None, n, d_pad, R, K,
            tile)
    with torch.cuda.device(dev):
        if ovf is None:
            rc = lib.sp_fused_shotgun_rounds(*args, _stream(dev))
        else:
            rc = lib.sp_fused_shotgun_rounds_ovf(
                *args, _ptr(ovf.rows), _ptr(ovf.vals), _ptr(ovf.cols),
                _ptr(ovf.ptr), _ptr(ovf.seg_ptr), _ptr(ovf.seg_col),
                *(_ptr(t) for t in work), work[0].shape[1], _stream(dev))
    _check_rc(rc, "fused_sparse_shotgun_rounds")
    LAUNCHES["fused_sparse_shotgun_rounds"] += 1
    del keep
    return x_out, z_out, f, nnz, health


# ---------------------------------------------------------------------------
# Kernel 4: R fused sparse rounds against a margin snapshot, emitting Δz
# ---------------------------------------------------------------------------

def fused_sparse_shotgun_delta_rounds_plain(rows, vals, z, x, blk_idx, lam,
                                            beta, y,
                                            loss: str | Loss = LASSO,
                                            k_eff=None):
    """Plain version of ``fused_sparse_shotgun_delta_rounds``, with the
    kernel's dataflow: each round's contribution c = Σ_k (row k of the
    (K, n) buffer), summed in k order from zero, is added to a live view
    z0 + own contributions and to a Δz accumulator; residual (and Newton
    weights) of the round-start view; every δ from the pre-round x; x[blk]
    += δ in k order; health 1 once the view holds a non-finite value."""
    ls = resolve_loss(loss)
    nblk, _ = _check_tiles(rows, vals)
    R, K = blk_idx.shape
    lam, beta, k_eff, _ = _scalars(lam, beta, K if k_eff is None else k_eff,
                                   math.inf, vals.device).unbind()
    y = y.float()
    one = torch.ones_like(y)
    view = z.float().clone()
    dz = torch.zeros_like(view)
    xb = x.float().reshape(nblk, BLOCK).clone()
    live = (torch.arange(K, device=vals.device) < k_eff.int()).float()[:, None]
    health = torch.zeros((), dtype=torch.float32, device=vals.device)
    for t in range(R):
        rows_k, vals_k, dlt = _plain_round(ls, rows, vals, view, xb,
                                           blk_idx[t].long(), lam, beta, y,
                                           one, live)
        c = _scatter_plain(rows_k, vals_k, torch.zeros_like(view), dlt)
        view = view + c
        dz = dz + c
        health = torch.maximum(
            health, (~torch.all(torch.isfinite(view))).float())
    return xb.reshape(-1), dz, health


def fused_sparse_shotgun_delta_rounds(rows, vals, z, x, blk_idx, lam, beta,
                                      y, loss: str | Loss = LASSO,
                                      k_eff=None, *,
                                      order: ScatterOrder | None = None,
                                      rstart: torch.Tensor | None = None):
    """The sharded driver's fused sparse engine: R rounds over BlockedCSC
    tiles in ONE launch against a read-only margin snapshot ``z``.

    A live view z + own contributions and a Δz = A_shard δx accumulator, as
    ``shotgun_block.fused_shotgun_delta_rounds``; no sample mask, no
    objective or nnz; ``health`` trips when the view holds a non-finite
    value after a round (a non-finite δ in a column with padding slots
    reaches row 0, as in the reference).  Arguments as
    ``fused_sparse_shotgun_rounds`` (no ``guard_f``, no ``stamps``).

    Returns (x_new (nblk·128,) f32, dz (n,) f32, health () f32).
    """
    ls = resolve_loss(loss)
    nblk, tile = _check_tiles(rows, vals)
    R, K = blk_idx.shape
    n = z.shape[0]
    _check_rstart(rstart, (), nblk, n, vals.device)
    if not _on_cuda(rows, vals, z, x, blk_idx, y):
        return fused_sparse_shotgun_delta_rounds_plain(
            rows, vals, z, x, blk_idx, lam, beta, y, ls, k_eff)
    _require_contiguous(rows, vals)
    od = scatter_order(rows, vals) if order is None else order
    rs = range_starts(rows, od, n) if rstart is None else rstart
    from repro_torch.kernels import _build
    lib = _build.load()
    dev = vals.device
    d_pad = nblk * BLOCK
    sp, sv, keep = _scalar_args(
        (lam, beta, K if k_eff is None else k_eff, math.inf), 1, dev)
    idx = _contig(blk_idx, torch.int32)
    yv = _contig(y, torch.float32)
    z0 = _contig(z, torch.float32)
    x0 = _contig(x, torch.float32)
    f32 = dict(dtype=torch.float32, device=dev)
    view = torch.empty(n, **f32)             # filled from z0 by the kernel
    dz = torch.empty(n, **f32)               # zeroed by the kernel
    x_out = torch.empty(d_pad, **f32)        # filled from x0 by the kernel
    r = torch.empty(n, **f32)
    w = torch.empty(n if ls.newton else 1, **f32)
    dlt = torch.empty((K, BLOCK), **f32)
    health = torch.empty((), **f32)          # zeroed by the kernel
    with torch.cuda.device(dev):
        rc = lib.sp_fused_shotgun_delta_rounds(
            _ptr(rows), _ptr(vals), int(vals.dtype == torch.bfloat16),
            _loss_code(ls), _ptr(od.order), _ptr(rs), _ptr(od.zmask),
            _ptr(yv), _ptr(idx), sp, sv, _ptr(z0), _ptr(view), _ptr(dz),
            _ptr(x0), _ptr(x_out), _ptr(r), _ptr(w), _ptr(dlt),
            _ptr(health), n, d_pad, R, K, tile, _stream(dev))
    _check_rc(rc, "fused_sparse_shotgun_delta_rounds")
    LAUNCHES["fused_sparse_shotgun_delta_rounds"] += 1
    del keep
    return x_out, dz, health
