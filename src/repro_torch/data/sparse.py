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

``on_canvas(nblk, tile)`` gives the container padded to more blocks or a
deeper tile, with float32 values, as a stream of stacked problems needs
it; a copy it has to make is cached here too, so its layouts are built
once as well.

Heavy-tailed designs (``from_csc``): a column keeps its first ``tile``
entries in the tiles and spills the rest into an ``Overflow`` store — flat
rows and values by (column, row), cut into segments of ``SEG`` entries
(a column's last one shorter), with per-column segment offsets on the
device and per-block ones on the host.  Such a design's ``scatter_order()``
and ``range_starts()`` cover the tile slots and the spilled entries of
each block together (``overflow_layouts``), and its ``matvec`` sums each
row over a cached row order (``row_sorted``).  A design with no spilled
column has no store (``ovf`` None) and takes exactly the paths above.

A padding slot contributes 0·v to row 0: nothing for a finite v, NaN for a
non-finite one.  Both layouts keep that: the flag carries it.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device

BLOCK = 128      # aligned column-block width, matches kernels.shotgun_block
TILE_PAD = 8     # tile axis padded to a multiple of 8
RANGE_ROWS = 128  # rows per range of the row-range scatter (csrc RANGE_ROWS)
SEG = 256        # spilled entries per overflow segment (csrc SEG)

FROM_CSC_SPAN = "repro_torch.design.from_csc"


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


class Overflow(NamedTuple):
    """The entries of the columns deeper than the tile, past their first
    ``tile`` (E of them, G segments).

    rows     (E,) int32 and vals (E,) f32/bf16: by (column, row).
    cols     (E,) uint8: each entry's column within its block.
    ptr      (d_pad + 1,) int64: column j's entries are ptr[j] .. ptr[j + 1].
    seg_ptr  (d_pad + 1,) int32: column j's segments are seg_ptr[j] ..
             seg_ptr[j + 1]; segment g of column j holds entries
             ptr[j] + (g − seg_ptr[j])·SEG onwards, at most SEG of them.
    seg_col  (G,) uint8: each segment's column within its block.
    blk_seg  (nblk + 1,) int64 numpy, on the host: seg_ptr[::128], block
             b's segments are blk_seg[b] .. blk_seg[b + 1].
    depth    the most entries a column spills (host).
    seg_slots  the most segments one block holds (host): a launch's
             segment slots for each drawn block, so the launch is sized
             without a device read.
    """
    rows: torch.Tensor
    vals: torch.Tensor
    cols: torch.Tensor
    ptr: torch.Tensor
    seg_ptr: torch.Tensor
    seg_col: torch.Tensor
    blk_seg: np.ndarray
    depth: int
    seg_slots: int

    @property
    def nbytes(self) -> int:
        return obs.nbytes(self.rows, self.vals, self.cols, self.ptr,
                          self.seg_ptr, self.seg_col)

    def to(self, device) -> "Overflow":
        dev = torch.device(device)
        return self._replace(**{k: getattr(self, k).to(dev) for k in (
            "rows", "vals", "cols", "ptr", "seg_ptr", "seg_col")})

    def entry_cols(self) -> torch.Tensor:
        """(E,) int64: each entry's column of the design."""
        counts = self.ptr[1:] - self.ptr[:-1]
        return torch.repeat_interleave(
            torch.arange(counts.numel(), device=counts.device), counts,
            output_size=self.rows.numel())

    def col_sums(self, terms: torch.Tensor) -> torch.Tensor:
        """(d_pad,) f32: each column's ``terms`` (one an entry) summed in
        entry order (``segment_reduce``: no atomics, the bits repeat)."""
        return torch.segment_reduce(terms.float(), "sum", offsets=self.ptr,
                                    unsafe=True)


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


def overflow_layouts(rows: torch.Tensor, vals: torch.Tensor, ovf: Overflow,
                     n: int, chunk: int = 1 << 26
                     ) -> tuple[ScatterOrder, torch.Tensor]:
    """The scatter layouts of a design with an overflow store, over each
    block's tile slots s < tile·128 and its spilled entries, which take the
    local slots tile·128 + (e − ptr[b·128]) after them.

    order   (nblk·tile·128 + E,) int32, flat: block b's local slots sorted
            stably by row (tile slots before spilled ones on a tie), the
            padding slots last, from position b·tile·128 + ptr[b·128].
    count   (nblk,) int32: stored slots and spilled entries per block.
    zmask   as ``scatter_order``'s (padding lives in the tiles only).
    rstart  (nblk, ceil(n / RANGE_ROWS) + 1) int32, as ``range_starts``:
            positions within block b's run of ``order``.

    Built on the device with one sort; ``chunk`` bounds the search's
    queries in flight."""
    nblk, tile, block = rows.shape
    T = tile * block
    dev = rows.device
    pad = _padding_slots(rows, vals).reshape(nblk, T)
    blk = torch.arange(nblk, device=dev)
    ob = ovf.ptr[::block]                             # (nblk + 1,)
    eb = torch.repeat_interleave(blk, ob[1:] - ob[:-1],
                                 output_size=ovf.rows.numel())
    keys = torch.cat([
        (torch.where(pad, n, rows.reshape(nblk, T).long())
         + blk[:, None] * (n + 1)).reshape(-1),
        eb * (n + 1) + ovf.rows.long()])
    local = torch.cat([
        torch.arange(T, device=dev, dtype=torch.int32).repeat(nblk),
        (T + torch.arange(ovf.rows.numel(), device=dev) - ob[eb]).to(
            torch.int32)])
    del eb
    keys, perm = torch.sort(keys, stable=True)
    order = local[perm].contiguous()
    del perm, local
    count = ((~pad).sum(dim=1) + (ob[1:] - ob[:-1])).to(torch.int32)
    zmask = pad.reshape(nblk, tile, block).any(dim=1).to(torch.uint8)
    base = blk * T + ob[:-1]                          # each block's run
    nq1 = -(-n // RANGE_ROWS) + 1
    bounds = torch.clamp_max(
        torch.arange(nq1, device=dev) * RANGE_ROWS, n)
    per = max(1, chunk // nq1)
    rstart = torch.empty((nblk, nq1), dtype=torch.int32, device=dev)
    for b0 in range(0, nblk, per):
        b1 = min(nblk, b0 + per)
        q = blk[b0:b1, None] * (n + 1) + bounds[None, :]
        rstart[b0:b1] = (torch.searchsorted(keys, q) - base[b0:b1, None]
                         ).to(torch.int32)
    return ScatterOrder(order, count, zmask.contiguous()), rstart


def row_sorted(rows: torch.Tensor, vals: torch.Tensor, ovf: Overflow, n: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(perm, offsets): the stored tile slots and spilled entries, indexed
    in one flat space (the nblk·tile·128 tile slots, then the E entries),
    sorted stably by row with the padding slots left out; row i's are
    perm[offsets[i] : offsets[i + 1]].  ``matvec`` of a design with an
    overflow store sums over it in this fixed order."""
    pad = _padding_slots(rows, vals).reshape(-1)
    key = torch.cat([torch.where(pad, n, rows.reshape(-1).long()),
                     ovf.rows.long()])
    key, perm = torch.sort(key, stable=True)
    offsets = torch.searchsorted(
        key, torch.arange(n + 1, device=key.device))
    return perm, offsets


@dataclasses.dataclass(frozen=True)
class BlockedCSC:
    """Blocked-CSC design matrix.  ``n``/``d`` are the true (unpadded)
    shape; the stored width is ``d_pad = nblk · block ≥ d`` with the padded
    tail columns all-zero.  ``ovf`` holds the entries of columns deeper
    than the tile (``from_csc``), or is None."""

    rows: torch.Tensor      # (nblk, tile, block) int32
    vals: torch.Tensor      # (nblk, tile, block) float32 or bfloat16
    n: int
    d: int
    block: int = BLOCK
    ovf: Overflow | None = None
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
        tiles = torch.sum(self.vals != 0)
        return tiles if self.ovf is None else tiles + torch.sum(
            self.ovf.vals != 0)

    def _tiles_only(self, what: str) -> None:
        """Raise for a design with an overflow store where ``what`` reads
        the tiles alone."""
        if self.ovf is not None:
            raise ValueError(f"{what} takes the tiles only; this design has "
                             f"an overflow store ({self.ovf.rows.numel()} "
                             f"spilled entries past tile {self.tile})")

    # ---- sparse interop ----------------------------------------------------

    @staticmethod
    def from_csc(col_ptr, rows, vals, n: int, d: int, *,
                 tile: int | None = None, block: int = BLOCK,
                 device="cuda") -> "BlockedCSC":
        """Build from CSC arrays on ``device`` with no dense intermediate:
        ``col_ptr`` (d + 1,), ``rows``/``vals`` (nnz,) sorted by (column,
        row).  A column keeps its first ``tile`` entries (default: the
        deepest column's count rounded up to 8, so nothing spills) in the
        tiles; the rest go to the overflow store, which is None when no
        column is deeper than ``tile``.  Exact: ``to_dense`` gives back the
        matrix.  Reads the host for its checks and sizes, and for the
        per-block segment offsets it keeps there."""
        with obs.span(FROM_CSC_SPAN):
            S = _from_csc(col_ptr, rows, vals, n, d, tile, block,
                          resolve_device(device))
            obs.count("design.tile_bytes", obs.nbytes(S.rows, S.vals))
            obs.count("design.overflow_bytes",
                      0 if S.ovf is None else S.ovf.nbytes)
        return S

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
        if self.ovf is not None:
            out.index_put_((self.ovf.rows.long(), self.ovf.entry_cols()),
                           self.ovf.vals.float(), accumulate=True)
        return out[:, : self.d]

    def to(self, device) -> "BlockedCSC":
        """The same container on ``device`` (itself if already there)."""
        dev = torch.device(device)
        if self.device == dev or (dev.type == self.device.type
                                  and dev.index is None):
            return self
        return dataclasses.replace(
            self, rows=self.rows.to(dev), vals=self.vals.to(dev),
            ovf=None if self.ovf is None else self.ovf.to(dev))

    def col_blocks(self, start: int, stop: int) -> "BlockedCSC":
        """Column blocks [start, stop) as a container of their own — one
        shard's columns in the sharded driver.  The tiles are contiguous
        views; the slice builds and caches its own ``scatter_order()``,
        ``range_starts()`` and ``row_table()``.  ``d`` counts the slice's
        real (unpadded) columns."""
        self._tiles_only("col_blocks")
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
            if self.ovf is None:
                self._cache["scatter"] = scatter_order(self.rows, self.vals)
            else:
                self._cache["scatter"], self._cache["rstart"] = \
                    overflow_layouts(self.rows, self.vals, self.ovf, self.n)
        return self._cache["scatter"]

    def range_starts(self) -> torch.Tensor:
        od = self.scatter_order()       # a store's layouts cache both
        if "rstart" not in self._cache:
            self._cache["rstart"] = range_starts(self.rows, od, self.n)
        return self._cache["rstart"]

    def row_sorted(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``row_sorted`` of a design with an overflow store (cached)."""
        if "row_sorted" not in self._cache:
            self._cache["row_sorted"] = row_sorted(self.rows, self.vals,
                                                   self.ovf, self.n)
        return self._cache["row_sorted"]

    def row_table(self) -> torch.Tensor:
        self._tiles_only("row_table")
        if "rows" not in self._cache:
            self._cache["rows"] = row_table(self.rows, self.vals, self.n)
        return self._cache["rows"]

    def on_canvas(self, nblk: int, tile: int) -> "BlockedCSC":
        """This design at ``nblk`` blocks of ``tile`` slots with float32
        values: itself when it has that shape already, else a copy padded
        with all-zero blocks and (row 0, value 0) slots, built at first use
        and cached here by (nblk, tile)."""
        self._tiles_only("on_canvas")
        S = self._canvas(nblk, tile)
        if S is None:
            P = pad_feature_blocks(self, nblk)
            pad = (0, 0, 0, tile - self.tile)
            S = self._cache[("canvas", nblk, tile)] = BlockedCSC(
                rows=torch.nn.functional.pad(P.rows, pad),
                vals=torch.nn.functional.pad(P.vals, pad).to(torch.float32),
                n=self.n, d=self.d, block=self.block)
        return S

    def has_layouts(self, nblk: int, tile: int) -> bool:
        """Whether ``on_canvas(nblk, tile)`` is cached with all three
        derived layouts (a check that builds nothing)."""
        S = self._canvas(nblk, tile)
        return S is not None and {"scatter", "rstart",
                                  "rows"} <= S._cache.keys()

    def _canvas(self, nblk: int, tile: int) -> "BlockedCSC | None":
        if (self.nblk, self.tile, self.vals.dtype) == (nblk, tile,
                                                       torch.float32):
            return self
        return self._cache.get(("canvas", nblk, tile))

    # ---- linear ops ------------------------------------------------------

    def matvec(self, x) -> torch.Tensor:
        """A @ x — x of length d or d_pad; returns (n,) f32."""
        x = torch.as_tensor(x, device=self.device)
        if x.shape[0] != self.d_pad:
            x = torch.nn.functional.pad(x, (0, self.d_pad - x.shape[0]))
        if self.ovf is not None:
            return self._ovf_matvec(x)
        return bcsc_matvec(self.rows, self.vals, x, self.n,
                           table=self.row_table(),
                           zmask=self.scatter_order().zmask)

    def _ovf_matvec(self, x) -> torch.Tensor:
        """A @ x over the tiles and the overflow store: each row's terms
        summed in ``row_sorted`` order (``segment_reduce``); a padding
        slot's 0·x_c marks row 0 as ``bcsc_matvec``'s do."""
        x = x.to(torch.float32)
        perm, offsets = self.row_sorted()
        contrib = torch.cat([
            (self.vals.float() * x.reshape(self.nblk, 1, self.block)
             ).reshape(-1),
            self.ovf.vals.float() * x[self.ovf.entry_cols()]])
        z = torch.segment_reduce(contrib[perm], "sum", offsets=offsets,
                                 unsafe=True)
        zmask = _padding_slots(self.rows, self.vals).any(dim=1)
        bad = torch.any(zmask.reshape(-1) & ~torch.isfinite(x))
        first = torch.arange(self.n, device=z.device) == 0
        return torch.where(first & bad, torch.nan, z)

    def rmatvec(self, r) -> torch.Tensor:
        """Aᵀ r — returns (d,) f32 (padding sliced off); a column's spilled
        terms are added to its tile sum."""
        out = bcsc_rmatvec(self.rows, self.vals, r)
        if self.ovf is not None:
            rv = torch.as_tensor(r, device=self.device).float()
            out = out + self.ovf.col_sums(self.ovf.vals.float()
                                          * rv[self.ovf.rows.long()])
        return out[: self.d]

    def col_norms(self) -> torch.Tensor:
        """Per-column ℓ₂ norms, (d,) f32."""
        v = self.vals.float()
        sq = torch.sum(v * v, dim=1).reshape(-1)
        if self.ovf is not None:
            w = self.ovf.vals.float()
            sq = sq + self.ovf.col_sums(w * w)
        return torch.sqrt(sq)[: self.d]

    def scale_cols(self, scales) -> "BlockedCSC":
        """A · diag(1/scales) — scales (d,); padded tail columns kept."""
        s = torch.nn.functional.pad(
            torch.as_tensor(scales, dtype=torch.float32, device=self.device),
            (0, self.d_pad - self.d), value=1.0)
        ovf = self.ovf
        if ovf is not None:
            ovf = ovf._replace(vals=ovf.vals / s[ovf.entry_cols()])
        return dataclasses.replace(
            self, vals=self.vals / s.reshape(self.nblk, 1, self.block),
            ovf=ovf)

    def astype(self, dtype) -> "BlockedCSC":
        """Cast the value tiles (rows stay int32).  bf16 halves the value
        bytes every sparse kernel reads; all of them accumulate in f32.
        Cast after ``normalize_columns`` so the norms are taken in f32.
        The overflow store's values are cast too."""
        ovf = self.ovf
        if ovf is not None:
            ovf = ovf._replace(vals=ovf.vals.to(dtype))
        return dataclasses.replace(self, vals=self.vals.to(dtype), ovf=ovf)

    def gather_cols(self, idx) -> "SparseCols":
        """nnz tiles of columns ``idx`` (P,): rows/vals (P, tile), or with
        an overflow store (P, tile + ovf.depth), each column's spilled
        entries after its tile and (row 0, value 0) padding after them."""
        idx = idx.long()
        b, c = idx // self.block, idx % self.block
        rows, vals = self.rows[b, :, c], self.vals[b, :, c]
        if self.ovf is None or not self.ovf.depth:
            return SparseCols(rows=rows, vals=vals)
        o = self.ovf
        lo, hi = o.ptr[idx], o.ptr[idx + 1]
        e = lo[:, None] + torch.arange(o.depth, device=idx.device)
        live = e < hi[:, None]
        e = torch.where(live, e, 0)
        return SparseCols(
            rows=torch.cat([rows, torch.where(live, o.rows[e], 0)], dim=1),
            vals=torch.cat([vals, torch.where(live, o.vals[e], 0)], dim=1))


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
    S._tiles_only("pad_feature_blocks")
    pad = (-S.nblk) % num_shards
    if not pad:
        return S
    zshape = (pad, S.tile, S.block)
    return dataclasses.replace(
        S,
        rows=torch.cat([S.rows, S.rows.new_zeros(zshape)]),
        vals=torch.cat([S.vals, S.vals.new_zeros(zshape)]))


def _from_csc(col_ptr, rows, vals, n: int, d: int, tile: int | None,
              block: int, dev: torch.device) -> BlockedCSC:
    """``BlockedCSC.from_csc`` on ``dev``."""
    col_ptr = torch.as_tensor(col_ptr, device=dev).long()
    rows = torch.as_tensor(rows, device=dev).to(torch.int32)
    vals = torch.as_tensor(vals, device=dev).to(torch.float32)
    nnz = rows.numel()
    if tuple(col_ptr.shape) != (d + 1,) or vals.shape != rows.shape:
        raise ValueError(f"col_ptr {tuple(col_ptr.shape)} must be ({d + 1},) "
                         f"and rows {tuple(rows.shape)}, vals "
                         f"{tuple(vals.shape)} one (nnz,) shape")
    counts = col_ptr[1:] - col_ptr[:-1]
    bad, deepest = torch.stack([
        ((col_ptr[0] != 0) | (col_ptr[-1] != nnz) | (counts < 0).any()
         | ((rows < 0) | (rows >= n)).any()).long(),
        counts.max() if d else col_ptr.new_zeros(())]).tolist()
    if bad:
        raise ValueError(f"col_ptr must rise from 0 to nnz={nnz} and rows "
                         f"lie in [0, {n})")
    if tile is None:
        tile = max(TILE_PAD, -(-int(deepest) // TILE_PAD) * TILE_PAD)
    if tile < 1:
        raise ValueError(f"tile={tile} must be >= 1")
    nblk = -(-d // block)
    d_pad = nblk * block
    col = torch.repeat_interleave(torch.arange(d, device=dev), counts,
                                  output_size=nnz)
    rank = torch.arange(nnz, device=dev) - col_ptr[col]
    keep = rank < tile
    slot = ((col // block) * tile + rank) * block + col % block
    t_rows = torch.zeros(nblk * tile * block, dtype=torch.int32, device=dev)
    t_vals = torch.zeros(nblk * tile * block, dtype=torch.float32,
                         device=dev)
    t_rows[slot[keep]] = rows[keep]
    t_vals[slot[keep]] = vals[keep]
    del slot, rank
    shape = (nblk, tile, block)
    if int(deepest) <= tile:
        return BlockedCSC(rows=t_rows.reshape(shape),
                          vals=t_vals.reshape(shape), n=n, d=d, block=block)
    spill = ~keep
    depth = torch.nn.functional.pad(torch.clamp_min(counts - tile, 0),
                                    (0, d_pad - d))
    nseg = -(-depth // SEG)
    zero = depth.new_zeros(1)
    seg_ptr = torch.cat([zero, torch.cumsum(nseg, 0)])
    local = torch.arange(d_pad, device=dev) % block
    blk_seg = seg_ptr[::block].cpu().numpy()
    ovf = Overflow(
        rows=rows[spill], vals=vals[spill],
        cols=(col[spill] % block).to(torch.uint8),
        ptr=torch.cat([zero, torch.cumsum(depth, 0)]),
        seg_ptr=seg_ptr.to(torch.int32),
        seg_col=torch.repeat_interleave(local, nseg).to(torch.uint8),
        blk_seg=blk_seg, depth=int(deepest) - tile,
        seg_slots=int(np.max(np.diff(blk_seg))))
    return BlockedCSC(rows=t_rows.reshape(shape), vals=t_vals.reshape(shape),
                      n=n, d=d, block=block, ovf=ovf)
