"""Per-shard round engines of the sharded Shotgun driver (port of
``repro.core.engines``, DESIGN §3).

The driver (``core/sharded.py``) is a loop over merges around one of five
**round engines**: "run R rounds of coordinate updates against a margin
snapshot z, emit the margin contribution Δz = A_shard δx".

  ``engine.run(A_blk, y, mask, lam, beta, z, x_l, idx, p_eff)
      -> (x_l, dz, health)``
      run ``idx.shape[0]`` rounds.  ``z`` is the last *merged* global
      margin; the engine sees its own updates at once (its live view is
      ``z + dz``) and other shards' only at the next merge.  ``idx`` is the
      explicit draw stream of this shard: (R, K) int32 block indices, or
      (R, P_local) coordinate indices for the scalar engine — the
      counterpart of the JAX engines' per-round keys.  ``p_eff`` is the
      adaptive-P backoff knob (DESIGN §9), a 0-dim int32 tensor on the
      device, in the engine's own units (coordinates for the scalar engine,
      128-blocks for the rest): each round keeps its full draw but masks
      updates at or past ``p_eff`` — a bit-exact no-op at full width.
      ``health`` is 0-dim f32, 1.0 once Δz (or, for the fused engines, the
      kernel's live view) holds a non-finite value.

  ``engine.run_segment(..., z, w_pend, x_l, idx, p_eff)``
      the pipelined-mode entry (DESIGN §3.4): ``run`` on ``z + w_pend``.

  ``engine.p_full``
      the engine's full parallelism in the same units.

Engines run no collective; the driver owns the merge.  ``A_blk`` is the
shard's dense (n, d_local) columns, contiguous, or its ``BlockedCSC``
column-block slice (``BlockedCSC.col_blocks``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import health
from repro_torch.core import objectives as obj
from repro_torch.data.sparse import BLOCK
from repro_torch.kernels import shotgun_block as sb
from repro_torch.kernels import shotgun_sparse as ss

ENGINE_NAMES = ("scalar", "block", "fused", "sparse_block", "sparse_fused")


def _run_segment(self, A_blk, y, mask, lam, beta, z, w_pend, x_l, idx,
                 p_eff):
    """Shared ``run_segment``: fold the pending wire into the margin base
    and run the window (exact for every engine, which reads the margin only
    through that additive base)."""
    return self.run(A_blk, y, mask, lam, beta, z + w_pend, x_l, idx, p_eff)


class ScalarEngine(NamedTuple):
    """Per-coordinate engine in plain torch (no kernel in the reference
    either): each round updates ``P_local`` coordinates of the shard,
    drawn with replacement, by the Shooting step against the live view."""

    P_local: int
    loss: str

    run_segment = _run_segment

    @property
    def p_full(self):
        return self.P_local

    def run(self, A_blk, y, mask, lam, beta, z, x_l, idx, p_eff):
        live = health.live_mask(self.P_local, p_eff)
        dz = torch.zeros_like(z)
        for idx_t in idx.long():
            r = obj.residual_like(z + dz, y, self.loss) * mask
            Ap = A_blk[:, idx_t]
            g = obj.rmatvec(Ap, r)
            delta = obj.shooting_delta(x_l[idx_t], g, lam, beta) * live
            x_l = x_l.index_add(0, idx_t, delta)
            dz = dz + obj.matvec(Ap, delta)
        return x_l, dz, health.nonfinite_flag(dz)


def _block_round(x_l, dz, idx_t, live, lam, beta, gather, scatter):
    """One two-kernel round on (x_l, dz): δ from the pre-round x, Δz by the
    scatter kernel, x[blk] += δ in k order."""
    xb = x_l.reshape(-1, BLOCK)
    i = idx_t.long()
    delta = ss.block_delta(xb[i], gather(idx_t), lam, beta) * live
    dz = scatter(dz, idx_t, delta)
    xb = xb.clone()
    for k in range(i.shape[0]):
        xb.index_add_(0, i[k:k + 1], delta[k:k + 1])
    return xb.reshape(-1), dz


class BlockEngine(NamedTuple):
    """Two-kernel engine: K aligned 128-blocks per round through
    ``gather_block_matvec`` + ``scatter_block_update`` (Queue 2 #3/#4),
    the scatter accumulating into the Δz buffer instead of the margin."""

    K: int
    loss: str

    run_segment = _run_segment

    @property
    def p_full(self):
        return self.K

    def run(self, A_blk, y, mask, lam, beta, z, x_l, idx, p_eff):
        live = health.live_mask(self.K, p_eff)[:, None]
        dz = torch.zeros_like(z)
        for idx_t in idx:
            r = obj.residual_like(z + dz, y, self.loss) * mask
            x_l, dz = _block_round(
                x_l, dz, idx_t, live, lam, beta,
                lambda i: sb.gather_block_matvec(A_blk, r, i),
                lambda d, i, dl: sb.scatter_block_update(A_blk, d, i, dl))
        return x_l, dz, health.nonfinite_flag(dz)


class FusedEngine(NamedTuple):
    """Fused engine: all R rounds of a merge window in ONE launch of
    ``fused_shotgun_delta_rounds`` (Queue 2 #7), the live view and the Δz
    accumulator kept by the kernel."""

    K: int
    loss: sb.Loss

    run_segment = _run_segment

    @property
    def p_full(self):
        return self.K

    def run(self, A_blk, y, mask, lam, beta, z, x_l, idx, p_eff):
        return sb.fused_shotgun_delta_rounds(A_blk, z, x_l, idx, lam, beta,
                                             y, mask, loss=self.loss,
                                             k_eff=p_eff)


class SparseBlockEngine(NamedTuple):
    """Two-kernel engine over a BlockedCSC column-block slice
    (``sparse_gather_block_matvec`` + ``sparse_scatter_block_update``,
    Queue 2 #5/#6), scattering into the Δz buffer."""

    K: int
    loss: str

    run_segment = _run_segment

    @property
    def p_full(self):
        return self.K

    def run(self, A_blk, y, mask, lam, beta, z, x_l, idx, p_eff):
        rows, vals = A_blk.rows, A_blk.vals
        order, rstart = A_blk.scatter_order(), A_blk.range_starts()
        live = health.live_mask(self.K, p_eff)[:, None]
        dz = torch.zeros_like(z)
        for idx_t in idx:
            r = obj.residual_like(z + dz, y, self.loss)
            x_l, dz = _block_round(
                x_l, dz, idx_t, live, lam, beta,
                lambda i: ss.sparse_gather_block_matvec(rows, vals, r, i),
                lambda d, i, dl: ss.sparse_scatter_block_update(
                    rows, vals, d, i, dl, order=order, rstart=rstart))
        return x_l, dz, health.nonfinite_flag(dz)


class SparseFusedEngine(NamedTuple):
    """Fused engine over a BlockedCSC column-block slice: all R rounds in
    ONE launch of ``fused_sparse_shotgun_delta_rounds`` (Queue 2 #8).  The
    sample mask is ignored (the sparse path never pads samples)."""

    K: int
    loss: sb.Loss

    run_segment = _run_segment

    @property
    def p_full(self):
        return self.K

    def run(self, A_blk, y, mask, lam, beta, z, x_l, idx, p_eff):
        return ss.fused_sparse_shotgun_delta_rounds(
            A_blk.rows, A_blk.vals, z, x_l, idx, lam, beta, y,
            loss=self.loss, k_eff=p_eff, order=A_blk.scatter_order(),
            rstart=A_blk.range_starts())


def make_engine(name: str, *, loss, P_local: int = 8, K: int = 2,
                newton: bool = False):
    """Build a round engine by name (``ENGINE_NAMES``).

    ``loss`` is a registry string or a ``shotgun_block.Loss``.
    ``newton=True`` upgrades a fused engine to the per-block Newton step
    (DESIGN §12); the two-kernel and scalar engines have no curvature
    tile, so it is fused-only."""
    if newton:
        if name not in ("fused", "sparse_fused"):
            raise ValueError(
                f"newton=True requires a fused engine, got {name!r}")
        loss = sb.resolve_loss(loss)._replace(newton=True)
    lname = loss if isinstance(loss, str) else loss.name
    if name == "scalar":
        return ScalarEngine(P_local=P_local, loss=lname)
    if name == "block":
        return BlockEngine(K=K, loss=lname)
    if name == "fused":
        return FusedEngine(K=K, loss=sb.resolve_loss(loss))
    if name == "sparse_block":
        return SparseBlockEngine(K=K, loss=lname)
    if name == "sparse_fused":
        return SparseFusedEngine(K=K, loss=sb.resolve_loss(loss))
    raise ValueError(f"unknown engine {name!r}; choose from {ENGINE_NAMES}")
