"""Designs in compressed sparse columns, drawn on the device from a seed.

``url_skewed`` draws a design of LIBSVM url_combined's published shape
(Ma, Saul, Savage & Voelker, ICML 2009): heavy-tailed column degrees, so a
few features lie in nearly every row and most in a handful.  Row j is
present in column c with probability p_c = min(1, a / rank(c)), rank a
seeded permutation of 1..d and ``a`` fitted on the host so that n·Σ p_c is
the configured nonzero count.  Columns with p_c ≥ 1/64 draw a Bernoulli
mask over all rows; the others draw a Binomial(n, p_c) count of rows
uniform with replacement, a row drawn twice kept once (so such a column
falls short of its count by under p_c / 2 in expectation).  Values are 1.0
in columns with p_c below ``binary_below`` and N(0, 1) above; labels ±1
from σ(A x) of a planted x, each flipped with probability ``flip``.

Every product that feeds the labels is summed in a fixed order, so one
seed gives the same bits in every run.  This module imports nothing of the
port: the drivers hand its arrays to ``BlockedCSC.from_csc`` and to the
reference alike.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bench.data.generators import BLOCK, Data, sparse_signal

DENSE_P = 1.0 / 64      # columns at or above draw a mask over every row
DENSE_CHUNK = 1 << 27   # mask entries drawn at a time


class CscRaw(NamedTuple):
    """A design in CSC: column c's rows are ``rows[col_ptr[c] :
    col_ptr[c + 1]]``, ascending, with their ``vals``."""
    col_ptr: torch.Tensor   # (d + 1,) int64
    rows: torch.Tensor      # (nnz,) int32
    vals: torch.Tensor      # (nnz,) float32
    n: int
    d: int

    @property
    def nnz_blk(self) -> torch.Tensor:
        """(nblk,) int64: the nonzeros of each block of 128 columns."""
        cut = self.col_ptr[::BLOCK]
        if self.d % BLOCK:
            cut = torch.cat([cut, self.col_ptr[-1:]])
        return cut[1:] - cut[:-1]


def fit_scale(n: int, d: int, nnz: float) -> float:
    """The ``a`` of p_c = min(1, a / rank) with n·Σ_{r ≤ d} p_r = nnz (the
    expected count), by bisection on the host."""
    def total(a: float) -> float:
        m = min(d, int(math.floor(a)))
        # Σ_{r > m} a / r through the digamma-free harmonic difference
        tail = a * (_harmonic(d) - _harmonic(m))
        return n * (m + tail)
    lo, hi = 1e-9, float(d)
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if total(mid) < nnz:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _harmonic(m: int) -> float:
    if m < 1000:
        return sum(1.0 / r for r in range(1, m + 1))
    return (math.log(m) + 0.5772156649015329 + 1.0 / (2 * m)
            - 1.0 / (12 * m * m))


def csc_matvec(A: CscRaw, x: torch.Tensor) -> torch.Tensor:
    """A @ x in float32 over the columns where x is nonzero, each row summed
    in one fixed order (terms sorted stably by row, ``segment_reduce``)."""
    counts = A.col_ptr[1:] - A.col_ptr[:-1]
    cols = torch.nonzero(x).reshape(-1)
    lo, cnt = A.col_ptr[cols], counts[cols]
    total = int(cnt.sum())
    start = torch.repeat_interleave(lo - (torch.cumsum(cnt, 0) - cnt), cnt,
                                    output_size=total)
    e = start + torch.arange(total, device=x.device)
    col = torch.repeat_interleave(cols, cnt, output_size=total)
    rows, perm = torch.sort(A.rows[e], stable=True)
    contrib = (A.vals[e] * x[col])[perm]
    bounds = torch.searchsorted(
        rows, torch.arange(A.n + 1, dtype=torch.int32, device=x.device))
    return torch.segment_reduce(contrib, "sum", offsets=bounds, unsafe=True)


def skewed_csc(g: torch.Generator, n: int, d: int, nnz: float,
               binary_below: float, device) -> CscRaw:
    """The columns of ``url_skewed``'s law (module docstring)."""
    a = fit_scale(n, d, nnz)
    rank = torch.randperm(d, generator=g, device=device) + 1
    p = torch.clamp_max(a / rank.double(), 1.0)
    dense = torch.nonzero(p >= DENSE_P).reshape(-1)
    sparse = torch.nonzero(p < DENSE_P).reshape(-1)
    parts_col, parts_row = [], []
    per = max(1, DENSE_CHUNK // n)
    for c0 in range(0, dense.numel(), per):
        cs = dense[c0:c0 + per]
        hit = torch.rand(cs.numel(), n, generator=g, device=device) \
            < p[cs, None].float()
        nz = torch.nonzero(hit)
        parts_col.append(cs[nz[:, 0]])
        parts_row.append(nz[:, 1].to(torch.int32))
        del hit, nz
    count = torch.binomial(torch.full((sparse.numel(),), float(n),
                                      device=device),
                           p[sparse].float(), generator=g).long()
    total = int(count.sum())
    col = torch.repeat_interleave(sparse, count, output_size=total)
    row = torch.randint(0, n, (total,), generator=g, device=device,
                        dtype=torch.int32)
    key, _ = torch.sort(col * n + row.long())
    keep = torch.ones_like(key, dtype=torch.bool)
    keep[1:] = key[1:] != key[:-1]
    key = key[keep]
    del keep, col, row
    key = torch.cat([key] + [c * n + r.long() for c, r in
                             zip(parts_col, parts_row)])
    key, _ = torch.sort(key)
    col, row = key // n, (key % n).to(torch.int32)
    del key
    counts = torch.bincount(col, minlength=d)
    col_ptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    gauss = p[col] >= binary_below
    vals = torch.where(gauss, torch.randn(row.numel(), generator=g,
                                          device=device), 1.0)
    return CscRaw(col_ptr=col_ptr, rows=row.contiguous(),
                  vals=vals.contiguous(), n=n, d=d)


def url_skewed(seed: int, *, n: int, d: int, nnz: float,
               binary_below: float = 0.1, nnz_frac: float = 0.005,
               flip: float = 0.02, device="cuda") -> Data:
    """url_combined's shape under the assumed degree law: y ∈ {−1, +1}
    from σ(A x) of a planted x (``nnz_frac`` of the coordinates at
    2·N(0, 1)), each flipped with probability ``flip``."""
    g = torch.Generator(device=device).manual_seed(seed)
    A = skewed_csc(g, n, d, nnz, binary_below, device)
    x = sparse_signal(g, d, nnz_frac, device)
    p = torch.sigmoid(csc_matvec(A, x))
    y = torch.where(torch.rand(n, generator=g, device=device) < p, 1.0, -1.0)
    flips = torch.rand(n, generator=g, device=device) < flip
    return Data(A, torch.where(flips, -y, y), x)


GENERATORS = {"url_skewed": url_skewed}


def make(cfg: dict, seed: int, device) -> Data:
    """The configuration's problem for ``seed``: ``cfg["generator"]``
    (one of ``GENERATORS``) called with ``cfg["shape"]``."""
    return GENERATORS[cfg["generator"]](seed, device=device, **cfg["shape"])
