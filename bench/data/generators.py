"""The benchmark's inputs, drawn on the device from a seed.

Frozen copies of ``_sparse_signal_on_device``, ``_bcsc_on_device``,
``large_sparse_bcsc_on_device``, ``logistic_data_on_device`` and
``logistic_bcsc_on_device`` from
``src/repro_torch/data/synthetic.py`` at commit 58376ee, rewritten to
return raw arrays (never a port object) and to keep every seed's shapes
the same: a column's draw count is capped at the configured ``tile``, so
the tile depth, and with it the work of a round, does not move with the
seed.  Products that feed the labels are summed in a fixed order, so one
seed gives the same bits in every run.

This module imports nothing of the port; the drivers hand these arrays
to the port's public constructors and to the reference alike.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

BLOCK = 128


class SparseRaw(NamedTuple):
    """A design in blocked column tiles, before any normalisation: column
    ``b·128 + c`` holds its nonzeros in ``rows[b, :, c]``/``vals[b, :, c]``,
    rows ascending; unused slots are (row 0, value 0).  ``nnz_blk`` counts
    the stored nonzeros of each block."""
    rows: torch.Tensor      # (nblk, tile, 128) int32
    vals: torch.Tensor      # (nblk, tile, 128) float32
    nnz_blk: torch.Tensor   # (nblk,) int64
    n: int
    d: int


class Data(NamedTuple):
    """One problem's raw inputs: ``A`` is a dense (n, d) float32 tensor or
    a ``SparseRaw``; ``y`` the (n,) observations; ``x_true`` the planted
    signal."""
    A: torch.Tensor | SparseRaw
    y: torch.Tensor
    x_true: torch.Tensor


def sparse_signal(g: torch.Generator, d: int, nnz_frac: float,
                  device) -> torch.Tensor:
    """k = max(1, ⌊d·nnz_frac⌋) coordinates at 2·N(0, 1), the rest 0."""
    x = torch.zeros(d, dtype=torch.float32, device=device)
    k = max(1, int(d * nnz_frac))
    idx = torch.randperm(d, generator=g, device=device)[:k]
    x[idx] = torch.randn(k, generator=g, device=device) * 2.0
    return x


def sparse_tiles(g: torch.Generator, n: int, d: int, density: float,
                 tile: int, draw_vals, device) -> SparseRaw:
    """Column j keeps min(c_j, tile) draws of a row, c_j ~ Binomial(n,
    density), rows uniform over [0, n) with replacement; a row drawn twice
    in one column is kept once (the first draw's value).  Values come from
    ``draw_vals(shape)``."""
    nblk = -(-d // BLOCK)
    shape = (nblk, 1, BLOCK)
    counts = torch.binomial(
        torch.full(shape, float(n), device=device),
        torch.full(shape, float(density), device=device), generator=g)
    counts = counts.clamp_max(tile) * (
        torch.arange(nblk * BLOCK, device=device) < d).reshape(shape)
    rows = torch.randint(0, n, (nblk, tile, BLOCK), generator=g,
                         device=device, dtype=torch.int32)
    vals = draw_vals((nblk, tile, BLOCK))
    live = torch.arange(tile, device=device).reshape(1, tile, 1) < counts
    sentinel = torch.iinfo(torch.int32).max
    key, perm = torch.sort(torch.where(live, rows, sentinel), dim=1,
                           stable=True)
    vals = torch.gather(vals, 1, perm)
    repeat = torch.zeros_like(live)
    repeat[:, 1:] = key[:, 1:] == key[:, :-1]
    key = torch.where(repeat, sentinel, key)
    key, perm = torch.sort(key, dim=1, stable=True)
    vals = torch.gather(vals, 1, perm)
    live = key != sentinel
    return SparseRaw(rows=torch.where(live, key, 0).contiguous(),
                     vals=torch.where(live, vals, 0.0).contiguous(),
                     nnz_blk=live.sum(dim=(1, 2)), n=n, d=d)


def sparse_matvec(A: SparseRaw, x: torch.Tensor) -> torch.Tensor:
    """A @ x in float32, each row summed in one fixed order (slots sorted
    stably by row, then ``segment_reduce``), so the bits repeat."""
    nblk, tile, block = A.rows.shape
    xp = torch.nn.functional.pad(x, (0, nblk * block - x.shape[0]))
    contrib = (A.vals * xp.reshape(nblk, 1, block)).reshape(-1)
    rows, perm = torch.sort(A.rows.reshape(-1), stable=True)
    bounds = torch.searchsorted(
        rows, torch.arange(A.n + 1, dtype=torch.int32, device=rows.device))
    return torch.segment_reduce(contrib[perm], "sum", offsets=bounds,
                                unsafe=True)


def large_sparse(seed: int, *, n: int, d: int, density: float, tile: int,
                 nnz_frac: float = 0.005, noise: float = 0.01,
                 device="cuda") -> Data:
    """Bag-of-words flavour: Exponential(1) values at ``density``, y = A x
    + noise·N(0, 1) from a planted sparse x."""
    g = torch.Generator(device=device).manual_seed(seed)
    A = sparse_tiles(g, n, d, density, tile,
                     lambda shape: torch.empty(shape, device=device)
                     .exponential_(1.0, generator=g), device)
    x = sparse_signal(g, d, nnz_frac, device)
    y = sparse_matvec(A, x) + noise * torch.randn(n, generator=g,
                                                  device=device)
    return Data(A, y, x)


def logistic_dense(seed: int, *, n: int, d: int, nnz_frac: float = 0.05,
                   flip: float = 0.02, device="cuda") -> Data:
    """Gaussian features, labels ±1 from σ(A x) of a planted sparse x,
    each flipped with probability ``flip``."""
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        g = torch.Generator(device=device).manual_seed(seed)
        A = torch.randn(n, d, generator=g, device=device)
        x = sparse_signal(g, d, nnz_frac, device)
        p = torch.sigmoid(A @ x)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    y = torch.where(torch.rand(n, generator=g, device=device) < p, 1.0, -1.0)
    flips = torch.rand(n, generator=g, device=device) < flip
    return Data(A, torch.where(flips, -y, y), x)


def logistic_sparse(seed: int, *, n: int, d: int, density: float, tile: int,
                    nnz_frac: float = 0.05, flip: float = 0.02,
                    device="cuda") -> Data:
    """Bag-of-words rows for logistic regression (rcv1's regime): N(0, 1)
    values at ``density``, labels ±1 from σ(A x) of a planted sparse x,
    each flipped with probability ``flip``."""
    g = torch.Generator(device=device).manual_seed(seed)
    A = sparse_tiles(g, n, d, density, tile,
                     lambda shape: torch.randn(shape, generator=g,
                                               device=device), device)
    x = sparse_signal(g, d, nnz_frac, device)
    p = torch.sigmoid(sparse_matvec(A, x))
    y = torch.where(torch.rand(n, generator=g, device=device) < p, 1.0, -1.0)
    flips = torch.rand(n, generator=g, device=device) < flip
    return Data(A, torch.where(flips, -y, y), x)


GENERATORS = {"large_sparse": large_sparse, "logistic_dense": logistic_dense,
              "logistic_sparse": logistic_sparse}


def make(cfg: dict, seed: int, device) -> Data:
    """The configuration's problem for ``seed``: ``cfg["generator"]``
    called with ``cfg["shape"]`` as its keyword arguments."""
    return GENERATORS[cfg["generator"]](seed, device=device, **cfg["shape"])
