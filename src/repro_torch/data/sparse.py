"""Blocked-CSC sparse design matrices (port of ``repro.data.sparse``).

``BlockedCSC`` stores A by aligned column blocks of 128 — the blocks the
kernels update — as fixed-shape padded CSC tiles:

    rows  (nblk, tile, block) int32    row index of each stored entry
    vals  (nblk, tile, block) f32/bf16 value of each stored entry

Column j lives at (b, :, c) with b = j // block, c = j % block; its nnz
entries occupy the leading slots of the ``tile`` axis and the rest are
padding (row 0, value 0).  ``tile`` is the max per-column nnz rounded up to
a multiple of 8.  ``from_dense`` packs in numpy exactly as the JAX package
does, so the same dense input gives bit-identical ``rows``/``vals``.

Three derived layouts are built on the container's device at first use and
cached on it (they depend on which slots are padding, so a container made
by ``scale_cols``/``astype`` builds its own):

  ``scatter_order()``  per block, the slot indices sorted stably by row
                       with the padding slots left out — what the
                       deterministic scatter kernels sum runs of equal rows
                       over — plus a per-column flag "has a padding slot".
  ``range_starts()``   per block, where each range of ``RANGE_ROWS`` rows
                       starts in that order — the segment a row-range CTA
                       of the two-kernel scatter reads.
  ``row_table()``      the stored slots regrouped by row, (n, width), so
                       that ``matvec`` is a gather and a fixed-order
                       ``torch.sum`` (``index_add_`` on CUDA adds with float
                       atomics, in an order that changes from run to run).

A padding slot contributes 0·v to row 0: nothing for a finite v, NaN for a
non-finite one.  Both layouts keep that: the flag carries it.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device

BLOCK = 128      # aligned column-block width, matches kernels.shotgun_block
TILE_PAD = 8     # tile axis padded to a multiple of 8
RANGE_ROWS = 128  # rows per range of the row-range scatter (csrc RANGE_ROWS)


class ScatterOrder(NamedTuple):
    """Per-block row-sorted slot order of a BlockedCSC (the scatter layout).

    order  (nblk, tile·block) int32: slot indices s = t·block + c of block b
           sorted stably by row; the first ``count[b]`` are the block's
           stored slots, the padding slots (row 0, value 0) follow.
    count  (nblk,) int32: stored (non-padding) slots per block.
    zmask  (nblk, block) uint8: 1 where column c of block b has a padding
           slot (its 0·δ_c lands on row 0).
    """
    order: torch.Tensor
    count: torch.Tensor
    zmask: torch.Tensor


def _padding_slots(rows: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    return (rows == 0) & (vals == 0)


def scatter_order(rows: torch.Tensor, vals: torch.Tensor) -> ScatterOrder:
    """Build the ``ScatterOrder`` of (rows, vals) on their device (one
    stable sort per block; no host round trip)."""
    nblk, tile, block = rows.shape
    pad = _padding_slots(rows, vals)
    key = torch.where(pad, torch.iinfo(torch.int32).max,
                      rows.to(torch.int32)).reshape(nblk, tile * block)
    _, order = torch.sort(key, dim=1, stable=True)
    count = (~pad).reshape(nblk, -1).sum(dim=1).to(torch.int32)
    zmask = pad.any(dim=1).to(torch.uint8)
    return ScatterOrder(order.to(torch.int32).contiguous(), count,
                        zmask.contiguous())


def range_starts(rows: torch.Tensor, od: ScatterOrder, n: int) -> torch.Tensor:
    """(nblk, ceil(n / RANGE_ROWS) + 1) int32: ``[b, q]`` is the first
    position in block b's row-sorted order (``od.order``) whose row is
    >= q·RANGE_ROWS, so range q's slots of block b are positions
    ``[b, q] .. [b, q + 1]`` and the last column is ``od.count``.  Built
    on the device (a gather and a batched ``searchsorted``; no host round
    trip)."""
    nblk, tile, block = rows.shape
    slots = tile * block
    key = torch.gather(rows.reshape(nblk, slots), 1, od.order.long())
    pos = torch.arange(slots, dtype=torch.int32, device=rows.device)
    key = torch.where(pos < od.count[:, None], key,
                      torch.iinfo(torch.int32).max)
    nq = -(-n // RANGE_ROWS)
    bounds = torch.arange(0, (nq + 1) * RANGE_ROWS, RANGE_ROWS,
                          dtype=torch.int32, device=rows.device)
    return torch.searchsorted(key, bounds.expand(nblk, nq + 1).contiguous(),
                              out_int32=True)


def row_table(rows: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    """(n, width) int64 flat slot indices of each row's stored slots, in
    slot order, padded with the sentinel ``rows.numel()`` (one past the
    last slot).  Reads one scalar back to the host (the width)."""
    flat_rows = rows.reshape(-1).to(torch.int64)
    pad = _padding_slots(rows, vals).reshape(-1)
    key = torch.where(pad, n, flat_rows)
    sorted_key, perm = torch.sort(key, stable=True)
    m = int((~pad).sum())
    perm, sk = perm[:m], sorted_key[:m]
    counts = torch.bincount(sk, minlength=n)
    width = max(1, int(counts.max())) if m else 1
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(m, device=rows.device) - starts[sk]
    table = torch.full((n, width), rows.numel(), dtype=torch.int64,
                       device=rows.device)
    table[sk, pos] = perm
    return table


@dataclasses.dataclass(frozen=True)
class BlockedCSC:
    """Blocked-CSC design matrix.  ``n``/``d`` are the true (unpadded)
    shape; the stored width is ``d_pad = nblk · block ≥ d`` with the padded
    tail columns all-zero."""

    rows: torch.Tensor      # (nblk, tile, block) int32
    vals: torch.Tensor      # (nblk, tile, block) float32 or bfloat16
    n: int
    d: int
    block: int = BLOCK
    _cache: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.d)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def nblk(self) -> int:
        return self.rows.shape[0]

    @property
    def tile(self) -> int:
        return self.rows.shape[1]

    @property
    def d_pad(self) -> int:
        return self.nblk * self.block

    @property
    def nnz(self) -> torch.Tensor:
        return torch.sum(self.vals != 0)

    # ---- dense interop ---------------------------------------------------

    @staticmethod
    def from_dense(A, block: int = BLOCK, tile: int | None = None, *,
                   device="cuda") -> "BlockedCSC":
        """Pack a dense (n, d) array on the host (numpy, as the JAX package
        packs it) and place the tiles on ``device``; exact (no
        thresholding), so ``to_dense(from_dense(A)) == A``."""
        if isinstance(A, torch.Tensor):
            # numpy has no bf16: widen first (exact), as the reference's
            # np.asarray(A, np.float32) does
            A = A.detach().cpu().float().numpy()
        A = np.asarray(A, np.float32)
        n, d = A.shape
        d_pad = -(-d // block) * block
        nblk = d_pad // block
        counts = (A != 0).sum(axis=0)
        if tile is None:
            tile = max(TILE_PAD, -(-int(counts.max(initial=0)) // TILE_PAD)
                       * TILE_PAD)
        elif counts.max(initial=0) > tile:
            raise ValueError(
                f"tile={tile} < max column nnz {int(counts.max())}")
        rows = np.zeros((nblk, tile, block), np.int32)
        vals = np.zeros((nblk, tile, block), np.float32)
        # nonzeros of A.T come out sorted by (col, row): each entry's tile
        # slot is its rank within its column's run
        cols_nz, rows_nz = np.nonzero(A.T)
        starts = np.concatenate(
            [[0], np.cumsum(np.bincount(cols_nz, minlength=d)[:-1])])
        slot = np.arange(cols_nz.size) - starts[cols_nz]
        rows[cols_nz // block, slot, cols_nz % block] = rows_nz
        vals[cols_nz // block, slot, cols_nz % block] = A[rows_nz, cols_nz]
        dev = resolve_device(device)
        return BlockedCSC(rows=torch.from_numpy(rows).to(dev),
                          vals=torch.from_numpy(vals).to(dev), n=n, d=d,
                          block=block)

    def to_dense(self) -> torch.Tensor:
        """Densify (tests / small problems only): (n, d) float32."""
        out = torch.zeros((self.n, self.d_pad), dtype=torch.float32,
                          device=self.device)
        cols = torch.arange(self.d_pad, device=self.device).reshape(
            self.nblk, 1, self.block).expand(self.rows.shape)
        out.index_put_((self.rows.reshape(-1).long(), cols.reshape(-1)),
                       self.vals.reshape(-1).float(), accumulate=True)
        return out[:, : self.d]

    def to(self, device) -> "BlockedCSC":
        """The same container on ``device`` (itself if already there)."""
        dev = torch.device(device)
        if self.device == dev or (dev.type == self.device.type
                                  and dev.index is None):
            return self
        return dataclasses.replace(self, rows=self.rows.to(dev),
                                   vals=self.vals.to(dev))

    def col_blocks(self, start: int, stop: int) -> "BlockedCSC":
        """Column blocks [start, stop) as a container of their own — one
        shard's columns in the sharded driver.  The tiles are contiguous
        views; the slice builds and caches its own ``scatter_order()``,
        ``range_starts()`` and ``row_table()``.  ``d`` counts the slice's
        real (unpadded) columns."""
        if not 0 <= start <= stop <= self.nblk:
            raise ValueError(f"column blocks [{start}, {stop}) outside "
                             f"[0, {self.nblk})")
        d = max(0, min(self.d, stop * self.block) - start * self.block)
        return BlockedCSC(rows=self.rows[start:stop],
                          vals=self.vals[start:stop], n=self.n, d=d,
                          block=self.block)

    # ---- derived layouts (cached) ----------------------------------------

    def scatter_order(self) -> ScatterOrder:
        if "scatter" not in self._cache:
            self._cache["scatter"] = scatter_order(self.rows, self.vals)
        return self._cache["scatter"]

    def range_starts(self) -> torch.Tensor:
        if "rstart" not in self._cache:
            self._cache["rstart"] = range_starts(self.rows,
                                                 self.scatter_order(), self.n)
        return self._cache["rstart"]

    def row_table(self) -> torch.Tensor:
        if "rows" not in self._cache:
            self._cache["rows"] = row_table(self.rows, self.vals, self.n)
        return self._cache["rows"]

    # ---- linear ops ------------------------------------------------------

    def matvec(self, x) -> torch.Tensor:
        """A @ x — x of length d or d_pad; returns (n,) f32."""
        x = torch.as_tensor(x, device=self.device)
        if x.shape[0] != self.d_pad:
            x = torch.nn.functional.pad(x, (0, self.d_pad - x.shape[0]))
        return bcsc_matvec(self.rows, self.vals, x, self.n,
                           table=self.row_table(),
                           zmask=self.scatter_order().zmask)

    def rmatvec(self, r) -> torch.Tensor:
        """Aᵀ r — returns (d,) f32 (padding sliced off)."""
        return bcsc_rmatvec(self.rows, self.vals, r)[: self.d]

    def col_norms(self) -> torch.Tensor:
        """Per-column ℓ₂ norms, (d,) f32."""
        v = self.vals.float()
        return torch.sqrt(torch.sum(v * v, dim=1)).reshape(-1)[: self.d]

    def scale_cols(self, scales) -> "BlockedCSC":
        """A · diag(1/scales) — scales (d,); padded tail columns kept."""
        s = torch.nn.functional.pad(
            torch.as_tensor(scales, dtype=torch.float32, device=self.device),
            (0, self.d_pad - self.d), value=1.0)
        return dataclasses.replace(
            self, vals=self.vals / s.reshape(self.nblk, 1, self.block))

    def astype(self, dtype) -> "BlockedCSC":
        """Cast the value tiles (rows stay int32).  bf16 halves the value
        bytes every sparse kernel reads; all of them accumulate in f32.
        Cast after ``normalize_columns`` so the norms are taken in f32."""
        return dataclasses.replace(self, vals=self.vals.to(dtype))

    def gather_cols(self, idx) -> "SparseCols":
        """nnz tiles of columns ``idx`` (P,): rows/vals (P, tile)."""
        idx = idx.long()
        b, c = idx // self.block, idx % self.block
        return SparseCols(rows=self.rows[b, :, c], vals=self.vals[b, :, c])


class SparseCols(NamedTuple):
    """A gathered pack of P sparse columns (the sparse counterpart of the
    dense ``A[:, idx]`` (n, P) gather): ``rows``/``vals`` are (P, tile)."""
    rows: torch.Tensor
    vals: torch.Tensor


# ---------------------------------------------------------------------------
# Functional ops on the raw tiles: shapes come from the arrays
# ---------------------------------------------------------------------------

def bcsc_matvec(rows, vals, x, n: int, *, table=None, zmask=None
                ) -> torch.Tensor:
    """A @ x with A given as (nblk, tile, block) tiles; x (nblk·block,).

    Deterministic on every device: each row sums its stored slots through
    ``row_table`` with one ``torch.sum``; a padding slot's 0·x_c is NaN
    exactly when x_c is not finite, which marks row 0.  ``table``/``zmask``
    are the cached layouts (built here when not given)."""
    nblk, tile, block = rows.shape
    if table is None:
        table = row_table(rows, vals, n)
    if zmask is None:
        zmask = _padding_slots(rows, vals).any(dim=1)
    x = x.to(torch.float32)
    contrib = (vals.float() * x.reshape(nblk, 1, block)).reshape(-1)
    contrib = torch.cat([contrib, contrib.new_zeros(1)])
    z = contrib[table].sum(dim=1)
    bad = torch.any(zmask.reshape(-1).bool() & ~torch.isfinite(x))
    first = torch.arange(n, device=z.device) == 0
    return torch.where(first & bad, torch.nan, z)


def bcsc_rmatvec(rows, vals, r) -> torch.Tensor:
    """Aᵀ r — returns the padded-width (nblk·block,) f32 vector."""
    rv = torch.as_tensor(r, device=rows.device).float()[rows.long()]
    return torch.sum(vals.float() * rv, dim=1).reshape(-1)


def pad_feature_blocks(S: BlockedCSC, num_shards: int) -> BlockedCSC:
    """Right-pad with all-zero column blocks so nblk divides evenly across
    shards; zero columns are fixed points of the update."""
    pad = (-S.nblk) % num_shards
    if not pad:
        return S
    zshape = (pad, S.tile, S.block)
    return dataclasses.replace(
        S,
        rows=torch.cat([S.rows, S.rows.new_zeros(zshape)]),
        vals=torch.cat([S.vals, S.vals.new_zeros(zshape)]))
