"""The plain reference over a design in CSC (``bench.data.csc.CscRaw``):
``shotgun.Design``'s products for a design whose columns have any depth,
so that ``shotgun.solve`` and ``shotgun.rounds`` run it unchanged.

Columns are scaled to unit norm in the reference's own arithmetic (float64
by default; ``precision="bf16"``, the control, rounds the normalised
values to bfloat16 and computes in float32).  A drawn block's columns are
its entries ``col_ptr[b·128] .. col_ptr[(b + 1)·128]``; each column's sum
over them is an ``index_add`` (the float64 sums' order moves by far less
than the limits the port is held to).  Nothing of the port is imported.
"""
from __future__ import annotations

import torch

from bench.reference.shotgun import BLOCK, Design as _Design, _dtypes


class Design(_Design):
    """A column-normalised CSC design with ``shotgun.Design``'s methods."""

    def __init__(self, A, y: torch.Tensor, loss: str, precision: str = "f64"):
        self.dt, store = _dtypes(precision)
        self.loss = loss
        self.y = y.to(self.dt)
        self.sparse = True
        self.n, self.d = A.n, A.d
        self.nblk = -(-self.d // BLOCK)
        dev = A.rows.device
        counts = A.col_ptr[1:] - A.col_ptr[:-1]
        nnz = A.rows.numel()
        self.col_ptr = torch.nn.functional.pad(
            A.col_ptr, (0, self.d_pad - self.d), value=nnz)
        self.col = torch.repeat_interleave(
            torch.arange(self.d, device=dev), counts, output_size=nnz)
        self.rows = A.rows.long()
        v = A.vals.to(self.dt)
        sq = torch.segment_reduce(v * v, "sum", offsets=A.col_ptr,
                                  unsafe=True)
        scale = torch.sqrt(sq)
        scale = torch.where(scale < 1e-12, 1.0, scale)
        self.vals = (v / scale[self.col]).to(store).to(self.dt)

    def _take(self, idx):
        """The entries of the drawn blocks: (rows, vals, slot of each in the
        (K, 128) output)."""
        lo = self.col_ptr[idx * BLOCK]
        cnt = self.col_ptr[(idx + 1) * BLOCK] - lo
        total = int(cnt.sum())
        e = torch.repeat_interleave(lo - (torch.cumsum(cnt, 0) - cnt), cnt,
                                    output_size=total)
        e = e + torch.arange(total, device=idx.device)
        k = torch.repeat_interleave(torch.arange(idx.numel(),
                                                 device=idx.device), cnt,
                                    output_size=total)
        slot = k * BLOCK + (self.col[e] - idx[k] * BLOCK)
        return self.rows[e], self.vals[e], slot, idx.numel()

    def _per_col(self, cols, terms) -> torch.Tensor:
        _, _, slot, K = cols
        return torch.zeros(K * BLOCK, dtype=self.dt,
                           device=terms.device).index_add_(
            0, slot, terms).reshape(K, BLOCK)

    def gather(self, cols, v) -> torch.Tensor:
        rows, vals, _, _ = cols
        return self._per_col(cols, vals * v[rows])

    def gather_sq(self, cols, v) -> torch.Tensor:
        rows, vals, _, _ = cols
        return self._per_col(cols, vals * vals * v[rows])

    def add(self, cols, delta, z) -> torch.Tensor:
        rows, vals, slot, _ = cols
        return z.index_add(0, rows, vals * delta.reshape(-1)[slot])

    def matvec(self, x) -> torch.Tensor:
        return torch.zeros(self.n, dtype=self.dt, device=x.device).index_add(
            0, self.rows, self.vals * x[self.col])

    def rmatvec(self, v) -> torch.Tensor:
        out = torch.segment_reduce(self.vals * v[self.rows], "sum",
                                   offsets=self.col_ptr[: self.d + 1],
                                   unsafe=True)
        return torch.nn.functional.pad(out, (0, self.d_pad - self.d))
