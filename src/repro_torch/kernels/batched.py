"""Batched (multi-slot) fused Shotgun kernels for Hopper and their plain
PyTorch versions.

Port of ``repro.kernels.batched``.  The serving layer stacks up to S
independent (problem, λ) *slots* on a leading axis and advances them all R
rounds in ONE launch.  Two kernels, the ``BATCHED`` templates of the fused
kernels in ``csrc/shotgun_block.cu`` and ``csrc/shotgun_sparse.cu``:

  batched_fused_shotgun_rounds         R dense rounds on S stacked slots
  batched_fused_sparse_shotgun_rounds  R BlockedCSC rounds on S slots

Every per-slot scalar — λ, β, the backoff count ``k_eff`` and the objective
guard ``guard_f`` — is an (S,) device tensor (never read back to the host),
so a stream's slots can differ in all four without another kernel.  Two
invariants the serving layer is built on:

  * slot i of a batched launch is bit-identical to the unbatched kernel
    (``fused_shotgun_rounds`` / ``fused_sparse_shotgun_rounds``) on that
    slot's state: the launch gains a slot dimension, the arithmetic and its
    order are the slot's own;
  * ``k_eff[s] = 0`` freezes slot s exactly (every δ is multiplied by 0), so
    empty, converged and backed-off slots ride along unchanged.  The guard
    only raises ``health[s]``; the slot keeps updating to the launch's end.

``shared_design=True`` gives every slot one design (a slot stride of 0 on
A, or on the tiles and their scatter order), not S copies of it.

A wrapper given CPU tensors runs its plain version — the unbatched plain
version slot by slot, so on the CPU slot i equals the standalone plain
solve bit for bit; given CUDA tensors it launches the kernel or raises, and
never falls back.  ``LAUNCHES`` counts kernel launches per wrapper.

``batched_draw_blocks`` draws (S, R, K) block indices, one
``torch.Generator`` per slot, by the method of ``ops.draw_blocks``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.data.sparse import (BLOCK, ScatterOrder, range_starts,
                                     scatter_order)
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import draw_blocks
from repro_torch.kernels.shotgun_block import (LASSO, Loss, _SCATTER_ROWS,
                                               _check_design, _check_rc,
                                               _contig, _gather_rows,
                                               _loss_code, _on_cuda, _ptr,
                                               _stream,
                                               fused_shotgun_rounds_plain,
                                               resolve_loss)
from repro_torch.kernels.shotgun_sparse import (_THREADS, _XCHUNK,
                                                _check_rstart, _check_stamps,
                                                _check_tiles,
                                                _require_contiguous,
                                                _scalar_args,
                                                fused_sparse_shotgun_rounds_plain)

# Kernel launches per wrapper (``reset_launches`` zeroes them).
LAUNCHES = {"batched_fused_shotgun_rounds": 0,
            "batched_fused_sparse_shotgun_rounds": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _slot_scalars(lam, beta, k_eff, guard_f, S: int, device) -> torch.Tensor:
    """The (S, 4) f32 rows [lam, beta, k_eff, guard_f] on ``device``.  Each
    argument is an (S,) tensor (kept on the device, never read back) or one
    number for every slot (filled on the device)."""
    cols = []
    for v in (lam, beta, k_eff, guard_f):
        t = (v.to(device=device, dtype=torch.float32)
             if isinstance(v, torch.Tensor) else
             torch.full((S,), float(v), dtype=torch.float32, device=device))
        if t.numel() == 1:
            t = t.reshape(1).expand(S)
        if tuple(t.shape) != (S,):
            raise ValueError(f"per-slot scalar of shape {tuple(t.shape)} for "
                             f"{S} slots")
        cols.append(t)
    return torch.stack(cols, dim=1).contiguous()


def _check_draws(blk_idx: torch.Tensor, S: int) -> tuple[int, int]:
    if blk_idx.dim() != 3 or blk_idx.shape[0] != S:
        raise ValueError(f"blk_idx must be (S, R, K) with S = {S}, got "
                         f"{tuple(blk_idx.shape)}")
    return blk_idx.shape[1], blk_idx.shape[2]


def _check_vectors(S: int, **named) -> None:
    for name, (t, shape) in named.items():
        if tuple(t.shape) != (S, shape):
            raise ValueError(f"{name} must be ({S}, {shape}), got "
                             f"{tuple(t.shape)}")


# ---------------------------------------------------------------------------
# Kernel 9: R fused dense rounds on S stacked slots
# ---------------------------------------------------------------------------

def _check_dense(A, z, x, y, mask, blk_idx, shared_design):
    """(S, n, d, R, K), raising (not asserting) on what the kernel does not
    take."""
    if z.dim() != 2:
        raise ValueError(f"z must be (S, n), got {tuple(z.shape)}")
    S = z.shape[0]
    if shared_design:
        n, d = _check_design(A)
    else:
        if A.dim() != 3 or A.shape[0] != S:
            raise ValueError(f"A must be (S, n, d) with S = {S} (or (n, d) "
                             f"with shared_design=True), got "
                             f"{tuple(A.shape)}")
        n, d = _check_design(A[0])
    _check_vectors(S, z=(z, n), x=(x, d), y=(y, n), mask=(mask, n))
    R, K = _check_draws(blk_idx, S)
    return S, n, d, R, K


def batched_fused_shotgun_rounds_plain(A, z, x, blk_idx, lam, beta, y, mask,
                                       k_eff, guard_f, *,
                                       loss: str | Loss = LASSO,
                                       shared_design: bool = False):
    """Plain version of ``batched_fused_shotgun_rounds``: the unbatched
    plain version (``fused_shotgun_rounds_plain``) slot by slot."""
    S = z.shape[0]
    sc = _slot_scalars(lam, beta, k_eff, guard_f, S, z.device)
    outs = [fused_shotgun_rounds_plain(
        A if shared_design else A[s], z[s], x[s], blk_idx[s], sc[s, 0],
        sc[s, 1], y[s], mask[s], loss, sc[s, 2], sc[s, 3]) for s in range(S)]
    return tuple(torch.stack(o) for o in zip(*outs))


def batched_fused_shotgun_rounds(A, z, x, blk_idx, lam, beta, y, mask, k_eff,
                                 guard_f, *, loss: str | Loss = LASSO,
                                 shared_design: bool = False):
    """R fused dense rounds on S stacked slots in ONE kernel launch.

    A        (S, n, d) stacked designs, or (n, d) with ``shared_design``
             (one design for every slot, not copied); f32 or bf16.
    z/y/mask (S, n);  x (S, d);  blk_idx (S, R, K) int per-slot draws.
    lam/beta/k_eff/guard_f  (S,) per-slot scalars — ``k_eff[s] = 0``
             freezes slot s exactly; ``guard_f[s]`` (+inf = unguarded)
             raises ``health[s]`` when a round's F passes it or goes
             non-finite.
    loss     ``"lasso"`` / ``"logistic"`` / ``"logistic_newton"`` or a
             ``Loss``.

    Returns (x (S, d), z (S, n), f (S, R), nnz (S, R) int32, health (S,)).
    """
    ls = resolve_loss(loss)
    S, n, d, R, K = _check_dense(A, z, x, y, mask, blk_idx, shared_design)
    if not _on_cuda(A, z, x, blk_idx, y, mask):
        return batched_fused_shotgun_rounds_plain(
            A, z, x, blk_idx, lam, beta, y, mask, k_eff, guard_f, loss=ls,
            shared_design=shared_design)
    if not A.is_contiguous():
        raise ValueError("the CUDA kernels take a row-major contiguous A")
    from repro_torch.kernels import _build
    lib = _build.load()
    dev = A.device
    rows = _gather_rows(n)
    T = math.ceil(n / rows)
    scal = _slot_scalars(lam, beta, k_eff, guard_f, S, dev)
    idx = _contig(blk_idx, torch.int32)
    yv = _contig(y, torch.float32)
    mv = _contig(mask, torch.float32)
    z_out = z.to(torch.float32, copy=True).contiguous()
    x_out = x.to(torch.float32, copy=True).contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    r = torch.empty((S, n), **f32)
    w = torch.empty((S, n) if ls.newton else (1,), **f32)
    gpart = torch.empty((S, K, T, BLOCK), **f32)
    hpart = torch.empty((S, K, T, BLOCK) if ls.newton else (1,), **f32)
    dlt = torch.empty((S, K, BLOCK), **f32)
    lpart = torch.empty((S, n // _SCATTER_ROWS), **f32)
    f = torch.empty((S, R), **f32)
    nnz = torch.empty((S, R), dtype=torch.int32, device=dev)
    health = torch.zeros(S, **f32)
    with torch.cuda.device(dev):
        rc = lib.sb_batched_fused_shotgun_rounds(
            _ptr(A), int(A.dtype == torch.bfloat16), _loss_code(ls),
            0 if shared_design else n * d, _ptr(yv), _ptr(mv), _ptr(idx),
            _ptr(scal), _ptr(z_out), _ptr(x_out), _ptr(r), _ptr(w),
            _ptr(gpart), _ptr(hpart), _ptr(dlt), _ptr(lpart), _ptr(f),
            _ptr(nnz), _ptr(health), n, d, S, R, K, rows, T, _stream(dev))
    _check_rc(rc, "batched_fused_shotgun_rounds")
    LAUNCHES["batched_fused_shotgun_rounds"] += 1
    return x_out, z_out, f, nnz, health


# ---------------------------------------------------------------------------
# Kernel 10: R fused BlockedCSC rounds on S stacked slots
# ---------------------------------------------------------------------------

def stacked_scatter_order(rows: torch.Tensor,
                          vals: torch.Tensor) -> ScatterOrder:
    """The ``ScatterOrder`` of (nblk, tile, 128) tiles, or of (S, nblk, tile,
    128) stacked tiles slot by slot (fields with a leading slot axis)."""
    if rows.dim() == 3:
        return scatter_order(rows, vals)
    S, nblk, tile, block = rows.shape
    od = scatter_order(rows.reshape(S * nblk, tile, block),
                       vals.reshape(S * nblk, tile, block))
    return ScatterOrder(od.order.reshape(S, nblk, tile * block),
                        od.count.reshape(S, nblk),
                        od.zmask.reshape(S, nblk, block))


def stacked_range_starts(rows: torch.Tensor, od: ScatterOrder,
                         n: int) -> torch.Tensor:
    """``range_starts`` of (nblk, tile, 128) tiles, or slot by slot of (S,
    nblk, tile, 128) stacked tiles and their stacked ``od``: (S, nblk,
    ceil(n / RANGE_ROWS) + 1)."""
    if rows.dim() == 3:
        return range_starts(rows, od, n)
    S, nblk, tile, block = rows.shape
    flat = ScatterOrder(od.order.reshape(S * nblk, tile * block),
                        od.count.reshape(S * nblk),
                        od.zmask.reshape(S * nblk, block))
    rs = range_starts(rows.reshape(S * nblk, tile, block), flat, n)
    return rs.reshape(S, nblk, -1)


def _check_sparse(rows, vals, z, x, y, blk_idx, shared_design):
    """(S, nblk, tile, n, R, K), raising on what the kernel does not take."""
    if z.dim() != 2:
        raise ValueError(f"z must be (S, n), got {tuple(z.shape)}")
    S, n = z.shape
    if shared_design:
        nblk, tile = _check_tiles(rows, vals)
    else:
        if (rows.dim() != 4 or rows.shape[0] != S
                or vals.shape != rows.shape):
            raise ValueError(f"rows/vals must be one (S, nblk, tile, {BLOCK})"
                             f" shape with S = {S} (or 3-D with "
                             f"shared_design=True), got {tuple(rows.shape)} "
                             f"and {tuple(vals.shape)}")
        nblk, tile = _check_tiles(rows[0], vals[0])
    _check_vectors(S, x=(x, nblk * BLOCK), y=(y, n))
    R, K = _check_draws(blk_idx, S)
    return S, nblk, tile, n, R, K


def batched_fused_sparse_shotgun_rounds_plain(rows, vals, z, x, blk_idx,
                                              lam, beta, y, k_eff, guard_f,
                                              *, loss: str | Loss = LASSO,
                                              shared_design: bool = False):
    """Plain version of ``batched_fused_sparse_shotgun_rounds``: the
    unbatched plain version (``fused_sparse_shotgun_rounds_plain``) slot by
    slot."""
    S = z.shape[0]
    sc = _slot_scalars(lam, beta, k_eff, guard_f, S, z.device)
    outs = [fused_sparse_shotgun_rounds_plain(
        rows if shared_design else rows[s],
        vals if shared_design else vals[s], z[s], x[s], blk_idx[s], sc[s, 0],
        sc[s, 1], y[s], loss, sc[s, 2], sc[s, 3]) for s in range(S)]
    return tuple(torch.stack(o) for o in zip(*outs))


def batched_fused_sparse_shotgun_rounds(rows, vals, z, x, blk_idx, lam, beta,
                                        y, k_eff, guard_f, *,
                                        loss: str | Loss = LASSO,
                                        shared_design: bool = False,
                                        order: ScatterOrder | None = None,
                                        rstart: torch.Tensor | None = None,
                                        stamps: torch.Tensor | None = None):
    """R fused BlockedCSC rounds on S stacked slots in ONE kernel launch.

    rows/vals  (S, nblk, tile, 128) stacked tiles (vals f32 or bf16), or
               (nblk, tile, 128) with ``shared_design``.
    z/y        (S, n);  x (S, nblk·128);  blk_idx (S, R, K) int.
    lam/beta/k_eff/guard_f  (S,) per-slot scalars, as
               ``batched_fused_shotgun_rounds`` (a number, or a
               one-element tensor, serves every slot).
    order      the tiles' ``ScatterOrder`` (``stacked_scatter_order``;
               a stream builds it once per admitted slot), built here when
               not given.
    rstart     the tiles' range-start tables, (S, nblk, ceil(n / 128) + 1)
               or (nblk, ceil(n / 128) + 1) with ``shared_design``
               (``stacked_range_starts``; a stream keeps them in its
               ``SlotArrays``), built here when not given.
    stamps     optional (2R + 6,) int64 CUDA tensor: the grid's last
               block's SM clock at launch start, after each grid-wide
               barrier and at the end, then the card's ns timer at launch
               start and at the end, as for ``fused_sparse_shotgun_rounds``
               (ignored on the CPU).

    Returns (x (S, nblk·128), z (S, n), f (S, R), nnz (S, R) int32,
    health (S,)).
    """
    ls = resolve_loss(loss)
    S, nblk, tile, n, R, K = _check_sparse(rows, vals, z, x, y, blk_idx,
                                           shared_design)
    _check_rstart(rstart, () if shared_design else (S,), nblk, n,
                  vals.device)
    if not _on_cuda(rows, vals, z, x, blk_idx, y):
        return batched_fused_sparse_shotgun_rounds_plain(
            rows, vals, z, x, blk_idx, lam, beta, y, k_eff, guard_f, loss=ls,
            shared_design=shared_design)
    _require_contiguous(rows, vals)
    od = stacked_scatter_order(rows, vals) if order is None else order
    slots = 1 if shared_design else S
    if (od.order.numel() != slots * nblk * tile * BLOCK
            or od.zmask.numel() != slots * nblk * BLOCK):
        raise ValueError("order does not match the tiles "
                         "(stacked_scatter_order of rows, vals)")
    rs = stacked_range_starts(rows, od, n) if rstart is None else rstart
    from repro_torch.kernels import _build
    lib = _build.load()
    dev = vals.device
    d_pad = nblk * BLOCK
    sp, sv, keep = _scalar_args((lam, beta, k_eff, guard_f), S, dev)
    idx = _contig(blk_idx, torch.int32)
    yv = _contig(y, torch.float32)
    z0 = _contig(z, torch.float32)
    x0 = _contig(x, torch.float32)
    f32 = dict(dtype=torch.float32, device=dev)
    n_xc = -(-d_pad // _XCHUNK)
    z_out = torch.empty((S, n), **f32)       # every output filled by the
    x_out = torch.empty((S, d_pad), **f32)   # kernel
    r = torch.empty((S, n), **f32)
    w = torch.empty((S, n) if ls.newton else (1,), **f32)
    dlt = torch.empty((S, K, BLOCK), **f32)
    lpart = torch.empty((S, 2, -(-n // _THREADS)), **f32)
    xl1 = torch.empty((S, n_xc), **f32)
    xnz = torch.empty((S, n_xc), dtype=torch.int32, device=dev)
    f = torch.empty((S, R), **f32)
    nnz = torch.empty((S, R), dtype=torch.int32, device=dev)
    health = torch.empty(S, **f32)
    _check_stamps(stamps, R, dev)
    with torch.cuda.device(dev):
        rc = lib.sp_batched_fused_shotgun_rounds(
            _ptr(rows), _ptr(vals), int(vals.dtype == torch.bfloat16),
            _loss_code(ls), 0 if shared_design else nblk * tile * BLOCK,
            _ptr(od.order), _ptr(rs), _ptr(od.zmask), _ptr(yv), _ptr(idx),
            sp, sv, _ptr(z0), _ptr(z_out), _ptr(x0), _ptr(x_out), _ptr(r),
            _ptr(w), _ptr(dlt), _ptr(lpart), _ptr(xl1), _ptr(xnz), _ptr(f),
            _ptr(nnz), _ptr(health),
            None if stamps is None else _ptr(stamps), n, d_pad, S, R, K, tile,
            _stream(dev))
    _check_rc(rc, "batched_fused_sparse_shotgun_rounds")
    LAUNCHES["batched_fused_sparse_shotgun_rounds"] += 1
    del keep
    return x_out, z_out, f, nnz, health


# ---------------------------------------------------------------------------
# Per-slot block draws
# ---------------------------------------------------------------------------

def batched_draw_blocks(generators, R: int, K: int, nblk: int,
                        device="cuda") -> torch.Tensor:
    """(S, R, K) int32 per-slot, per-round block draws on ``device``: K
    distinct blocks a round from each slot's ``torch.Generator`` (or a seed,
    for a generator made here), exactly ``ops.draw_blocks`` per slot."""
    dev = resolve_device(device)
    if K > nblk:
        raise ValueError(f"K={K} blocks per round > {nblk} blocks in d")
    gens = [g if isinstance(g, torch.Generator)
            else torch.Generator(device=dev).manual_seed(int(g))
            for g in generators]
    return torch.stack([draw_blocks(g, R, K, nblk, dev) for g in gens])
