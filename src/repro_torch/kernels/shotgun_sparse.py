"""BlockedCSC Block-Shotgun kernels for Hopper and their plain PyTorch
versions.

Port of ``repro.kernels.shotgun_sparse``.  Three kernels, written in CUDA
C++ in ``csrc/shotgun_sparse.cu`` and built by ``kernels/_build.py``:

  sparse_gather_block_matvec   g[k] = Σ_t vals·r[rows] over block k's tile
  sparse_scatter_block_update  z + scatter-add of vals·δ_k at rows
  fused_sparse_shotgun_rounds  R sparse Block-Shotgun rounds in one launch

Each wrapper keeps the JAX signature and return tuple, minus ``interpret``;
the scatter and the fused kernel take the container's row-sorted slot order
as ``order=`` (``BlockedCSC.scatter_order()``, cached per problem; built
here when not given).  A wrapper given CPU tensors runs its plain version
(``*_plain``, same module, same dataflow); given CUDA tensors it launches
the kernel or raises — it never falls back.  ``LAUNCHES`` counts kernel
launches per wrapper.

There is no sample mask on the sparse path: z is full length (n,), and
padded tile slots (row 0, value 0) are additive no-ops in both directions
(0·δ is NaN for a non-finite δ, as in the reference).
"""
from __future__ import annotations

import math

import torch

from repro_torch.data.sparse import BLOCK, ScatterOrder, scatter_order
from repro_torch.kernels.shotgun_block import (LASSO, Loss, _check_rc,
                                               _contig, _loss_code, _on_cuda,
                                               _ptr, _scalars,
                                               _soft_threshold, _stream,
                                               resolve_loss)

# Kernel launches per wrapper (``reset_launches`` zeroes them).
LAUNCHES = {"fused_sparse_shotgun_rounds": 0,
            "sparse_gather_block_matvec": 0,
            "sparse_scatter_block_update": 0}

_THREADS = 256     # CUDA threads per block, every sparse kernel
_XCHUNK = 4096     # |x| / nnz partial: elements per item (fused kernel)


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
    (nblk, tile, 128) int32 rows and f32/bf16 vals of one shape, tile a
    multiple of 2 (the scatter's 256-slot items)."""
    if rows.dim() != 3 or rows.shape != vals.shape:
        raise ValueError(f"rows {tuple(rows.shape)} and vals "
                         f"{tuple(vals.shape)} must be one (nblk, tile, "
                         f"{BLOCK}) shape")
    nblk, tile, block = rows.shape
    if block != BLOCK:
        raise ValueError(f"block width {block} != {BLOCK}")
    if tile % 2:
        raise ValueError(f"tile={tile} must be even (BlockedCSC pads it to "
                         "a multiple of 8)")
    if rows.dtype != torch.int32:
        raise ValueError(f"rows must be int32, got {rows.dtype}")
    if vals.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"vals must be float32 or bfloat16, got {vals.dtype}")
    return nblk, tile


def _require_contiguous(*tensors: torch.Tensor) -> None:
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA kernels take contiguous rows/vals tiles")


def _take_tiles(rows, vals, idx):
    """(K, tile, 128) long rows and f32 vals of the drawn blocks."""
    idx = idx.long()
    return rows[idx].long(), vals[idx].float()


def _scatter_plain(rows_k, vals_k, z, delta):
    """z + Σ_k A_{B_k} δ_k with the kernel's dataflow: block k's
    contributions land in row k of a (K, n) buffer, then the rows are added
    to z in k order."""
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
    if not _on_cuda(rows, vals, r, blk_idx):
        return sparse_gather_block_matvec_plain(rows, vals, r, blk_idx)
    _require_contiguous(rows, vals)
    from repro_torch.kernels import _build
    lib = _build.load()
    dev = vals.device
    rv = _contig(r, torch.float32)
    idx = _contig(blk_idx, torch.int32)
    g = torch.empty((K, BLOCK), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.sp_gather_block_matvec(
            _ptr(rows), _ptr(vals), int(vals.dtype == torch.bfloat16),
            _ptr(rv), _ptr(idx), _ptr(g), tile, K, _stream(dev))
    _check_rc(rc, "sparse_gather_block_matvec")
    LAUNCHES["sparse_gather_block_matvec"] += 1
    return g


# ---------------------------------------------------------------------------
# Kernel 2: z + Σ_k A_{B_k} δ_k from nnz tiles
# ---------------------------------------------------------------------------

def sparse_scatter_block_update_plain(rows, vals, z, blk_idx, delta):
    """Plain version of ``sparse_scatter_block_update``."""
    rows_k, vals_k = _take_tiles(rows, vals, blk_idx)
    return _scatter_plain(rows_k, vals_k, z, delta.float()).to(z.dtype)


def sparse_scatter_block_update(rows, vals, z, blk_idx, delta, *,
                                order: ScatterOrder | None = None):
    """z_new = z + Σ_k A_{B_k} δ_k from nnz tiles — f32 accumulation, in a
    fixed order (repeat runs are bit-identical).  delta (K, 128); duplicate
    blocks in ``blk_idx`` accumulate."""
    _, tile = _check_tiles(rows, vals)
    K = blk_idx.shape[0]
    n = z.shape[0]
    if not _on_cuda(rows, vals, z, blk_idx, delta):
        return sparse_scatter_block_update_plain(rows, vals, z, blk_idx,
                                                 delta)
    _require_contiguous(rows, vals)
    od = scatter_order(rows, vals) if order is None else order
    from repro_torch.kernels import _build
    lib = _build.load()
    dev = vals.device
    f32 = dict(dtype=torch.float32, device=dev)
    z_in = _contig(z, torch.float32)
    idx = _contig(blk_idx, torch.int32)
    dlt = _contig(delta, torch.float32)
    buf = torch.zeros(K * n, **f32)
    padterm = torch.empty(K, **f32)
    z_out = torch.empty(n, **f32)
    with torch.cuda.device(dev):
        rc = lib.sp_scatter_block_update(
            _ptr(rows), _ptr(vals), int(vals.dtype == torch.bfloat16),
            _ptr(od.order), _ptr(od.count), _ptr(od.zmask), _ptr(z_in),
            _ptr(idx), _ptr(dlt), _ptr(buf), _ptr(padterm), _ptr(z_out), n,
            tile, K, _stream(dev))
    _check_rc(rc, "sparse_scatter_block_update")
    LAUNCHES["sparse_scatter_block_update"] += 1
    return z_out.to(z.dtype)


# ---------------------------------------------------------------------------
# Kernel 3: fused multi-round sparse Shotgun — R rounds per launch
# ---------------------------------------------------------------------------

def fused_sparse_shotgun_rounds_plain(rows, vals, z, x, blk_idx, lam, beta,
                                      y, loss: str | Loss = LASSO,
                                      k_eff=None, guard_f=None):
    """Plain version of ``fused_sparse_shotgun_rounds``, with the kernel's
    dataflow: each round takes the residual (and Newton weights) of the
    round-start margin, computes every δ from the pre-round x, adds block
    k's contributions to z through row k of a (K, n) buffer in k order,
    applies x[blk] += δ in k order at round end (duplicates accumulate),
    then computes F and nnz from the updated (x, z)."""
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
        r = ls.residual(z, y, one)
        rows_k, vals_k = _take_tiles(rows, vals, idx)
        g = torch.sum(vals_k * r[rows_k], dim=1)
        if ls.newton:
            w = ls.curvature_weights(z, y, one)
            h = torch.clamp_min(torch.sum(vals_k * vals_k * w[rows_k], dim=1),
                                1e-8)
        else:
            h = beta
        dlt = block_delta(xb[idx], g, lam, h) * live
        z = _scatter_plain(rows_k, vals_k, z, dlt)
        for k in range(K):
            xb.index_add_(0, idx[k:k + 1], dlt[k:k + 1])
        f = ls.objective(z, y, one, xb, lam)
        bad = ~torch.isfinite(f) | (f > guard)
        health = torch.maximum(health, bad.float())
        fs.append(f)
        nnzs.append(torch.sum(xb != 0))
    return (xb.reshape(-1), z, torch.stack(fs),
            torch.stack(nnzs).to(torch.int32), health)


def fused_sparse_shotgun_rounds(rows, vals, z, x, blk_idx, lam, beta, y,
                                loss: str | Loss = LASSO, k_eff=None,
                                guard_f=None, *,
                                order: ScatterOrder | None = None,
                                stamps: torch.Tensor | None = None):
    """R Block-Shotgun rounds over BlockedCSC tiles in ONE kernel launch.

    rows/vals  (nblk, tile, 128) BlockedCSC tiles, vals f32 or bf16.
    z          (n,) margin A x;  x (nblk·128,) iterate;  y (n,).
    blk_idx    (R, K) int — round t updates blocks blk_idx[t, 0..K-1]
               (duplicates allowed, multiset semantics).
    loss       ``"lasso"`` / ``"logistic"`` / ``"logistic_newton"`` or a
               ``Loss``; Newton divides by max(Σ vals²·w[rows], 1e-8).
    k_eff      blocks k >= k_eff are drawn but masked out.  None = all K.
    guard_f    health trips when a round's F exceeds it or goes non-finite.
    stamps     optional (3R + 4,) int64 CUDA tensor: the kernel writes the
               SM clock at launch start, after each grid-wide barrier and at
               the end (phase breakdown; ignored on the CPU).

    Returns (x_new (nblk·128,) f32, z_new (n,) f32, f (R,) f32,
    nnz (R,) int32, health () f32).
    """
    ls = resolve_loss(loss)
    nblk, tile = _check_tiles(rows, vals)
    R, K = blk_idx.shape
    n = z.shape[0]
    if not _on_cuda(rows, vals, z, x, blk_idx, y):
        return fused_sparse_shotgun_rounds_plain(rows, vals, z, x, blk_idx,
                                                 lam, beta, y, ls, k_eff,
                                                 guard_f)
    _require_contiguous(rows, vals)
    od = scatter_order(rows, vals) if order is None else order
    from repro_torch.kernels import _build
    lib = _build.load()
    dev = vals.device
    d_pad = nblk * BLOCK
    scal = _scalars(lam, beta, K if k_eff is None else k_eff,
                    math.inf if guard_f is None else guard_f, dev)
    idx = _contig(blk_idx, torch.int32)
    yv = _contig(y, torch.float32)
    z_out = z.to(torch.float32, copy=True).contiguous()
    x_out = x.to(torch.float32, copy=True).contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    n_xc = -(-d_pad // _XCHUNK)
    r = torch.empty(n, **f32)
    w = torch.empty(n if ls.newton else 1, **f32)
    buf = torch.empty(K * n, **f32)          # zeroed by the kernel
    padterm = torch.empty(K, **f32)
    dlt = torch.empty((K, BLOCK), **f32)
    lpart = torch.empty(-(-n // _THREADS), **f32)
    xl1 = torch.empty(n_xc, **f32)
    xnz = torch.empty(n_xc, dtype=torch.int32, device=dev)
    f = torch.empty(R, **f32)
    nnz = torch.empty(R, dtype=torch.int32, device=dev)
    health = torch.zeros((), **f32)
    if stamps is not None and (stamps.dtype != torch.int64
                               or stamps.numel() < 3 * R + 4
                               or stamps.device != dev):
        raise ValueError(f"stamps must be an int64 tensor of >= {3 * R + 4} "
                         f"elements on {dev}")
    with torch.cuda.device(dev):
        rc = lib.sp_fused_shotgun_rounds(
            _ptr(rows), _ptr(vals), int(vals.dtype == torch.bfloat16),
            _loss_code(ls), _ptr(od.order), _ptr(od.count), _ptr(od.zmask),
            _ptr(yv), _ptr(idx), _ptr(scal), _ptr(z_out), _ptr(x_out),
            _ptr(r), _ptr(w), _ptr(buf), _ptr(padterm), _ptr(dlt),
            _ptr(lpart), _ptr(xl1), _ptr(xnz), _ptr(f), _ptr(nnz),
            _ptr(health), _ptr(stamps) if stamps is not None else None, n,
            d_pad, R, K, tile, _stream(dev))
    _check_rc(rc, "fused_sparse_shotgun_rounds")
    LAUNCHES["fused_sparse_shotgun_rounds"] += 1
    return x_out, z_out, f, nnz, health
