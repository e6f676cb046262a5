"""The bytes a solve's inputs need, whatever implements them.

Each round reads every distinct (design, block) pair that some live slot
draws once, however many slots draw it:

* dense: the block's true rows × true columns × the bytes of an element;
* blocked column tiles: the block's true nonzeros × (4 B row index + the
  bytes of a value); tile padding is not counted.

Each solve adds, once, y read, the margin z read and written, and x
written, at their true lengths.  The count names no kernel and counts no
padding, so no implementation can read above its roofline.
"""
from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12     # one H100 SXM's device memory (NVIDIA data sheet)
BLOCK = 128


def block_bytes_dense(n: int, d: int, elem_bytes: int) -> torch.Tensor:
    """(nblk,) bytes of each dense block: n rows × its true columns."""
    nblk = -(-d // BLOCK)
    cols = torch.full((nblk,), BLOCK, dtype=torch.int64)
    cols[-1] = d - BLOCK * (nblk - 1)
    return n * cols * elem_bytes


def block_bytes_sparse(nnz_blk: torch.Tensor, value_bytes: int
                       ) -> torch.Tensor:
    """(nblk,) bytes of each tiled block: its nonzeros × (4 + value)."""
    return nnz_blk.to(torch.int64).cpu() * (4 + value_bytes)


def rounds_bytes(draws: torch.Tensor, block_bytes: list[torch.Tensor]
                 ) -> int:
    """Bytes the rounds of ``draws`` read, each distinct pair once a round.

    ``draws``: (rounds, m, 2) int64 of (design, block) pairs, the m live
    draws of every slot of a round; ``block_bytes[p]`` the (nblk,) bytes
    of design p's blocks."""
    if draws.numel() == 0:
        return 0
    draws = draws.cpu().long()
    nblk = max(b.numel() for b in block_bytes)
    key = draws[..., 0] * nblk + draws[..., 1]            # (rounds, m)
    key, _ = torch.sort(key, dim=1)
    first = torch.ones_like(key, dtype=torch.bool)
    first[:, 1:] = key[:, 1:] != key[:, :-1]
    table = torch.cat([torch.nn.functional.pad(b.cpu(), (0, nblk - b.numel()))
                       for b in block_bytes])
    return int(table[key[first]].sum())


def solve_bytes(n: int, d: int) -> int:
    """y read, z read and written, x written: float32 at true lengths."""
    return 4 * n + 2 * 4 * n + 4 * d


def roofline_percent(nbytes: float, busy_s: float) -> float | None:
    """The share of the device's memory bound that ``nbytes`` in
    ``busy_s`` device-busy seconds reaches, in percent."""
    if busy_s <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / busy_s
