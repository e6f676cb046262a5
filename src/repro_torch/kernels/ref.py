"""Plain-torch oracles for the Block-Shotgun kernels, dense and BlockedCSC
(port of ``repro.kernels.ref``).  They are written against
``core.objectives``, not against the kernels' ``Loss`` seam, so they stay an
independent formulation of what the kernels and their plain versions
compute."""
from __future__ import annotations

import torch

from repro_torch.core import objectives as obj
from repro_torch.device import exact_f32_matmul
from repro_torch.kernels.shotgun_block import resolve_loss


def _curvature_weights_ref(z, y, mask, name: str):
    """Per-sample diagonal-Hessian weights written the CDN way (p = σ(z),
    w = p(1−p)) — equal to the kernel's σ(−yz)(1−σ(−yz)) for y ∈ {−1, +1}."""
    if name == "lasso":
        return mask
    p = torch.sigmoid(z)
    return p * (1.0 - p) * mask


def _blocks(A, blk_idx, block):
    n, d = A.shape
    return A.reshape(n, d // block, block)[:, blk_idx.long(), :].float()


def gather_block_matvec_ref(A, r, blk_idx, block: int):
    """g[k] = A[:, blk_k*B:(blk_k+1)*B]ᵀ r for each selected block k;
    (K, block) float32."""
    if A.is_cuda:
        exact_f32_matmul()
    return torch.einsum("nkb,n->kb", _blocks(A, blk_idx, block), r.float())


def scatter_block_update_ref(A, z, blk_idx, delta, block: int):
    """z_new = z + Σ_k A[:, blk_k] @ delta[k]; z's dtype, f32 accumulation."""
    if A.is_cuda:
        exact_f32_matmul()
    dz = torch.einsum("nkb,kb->n", _blocks(A, blk_idx, block), delta.float())
    return (z.float() + dz).to(z.dtype)


def fused_shotgun_rounds_ref(A, z, x, blk_idx, lam, beta, y, mask, loss,
                             block: int):
    """Multi-round oracle for ``fused_shotgun_rounds``: blk_idx (R, K), with
    duplicates in a row following Alg. 2's multiset semantics (all deltas
    from the pre-round iterate, then accumulated).  A Newton spec divides by
    the per-block curvature h_B = A_B²ᵀ w (floored 1e-8) from the
    round-start margin.  Returns (x (d,), z (n,), f (R,), nnz (R,) int32)."""
    ls = resolve_loss(loss)
    x = x.float()
    z = z.float()
    A32 = A.float()
    A2 = A32 * A32 if ls.newton else None
    fs, nnzs = [], []
    for idx_t in blk_idx:
        r = obj.residual_like(z, y, ls.name) * mask
        g = gather_block_matvec_ref(A32, r, idx_t, block)
        if ls.newton:
            w = _curvature_weights_ref(z, y, mask, ls.name)
            h = torch.clamp_min(gather_block_matvec_ref(A2, w, idx_t, block),
                                1e-8)
        else:
            h = beta
        xb = x.reshape(-1, block)
        x_sel = xb[idx_t.long()]
        x_new = obj.soft_threshold(x_sel - g / h, lam / h)
        delta = x_new - x_sel
        z = scatter_block_update_ref(A32, z, idx_t, delta, block)
        x = xb.index_put((idx_t.long(),), delta, accumulate=True).reshape(-1)
        fs.append(obj.masked_data_loss(z, y, mask, ls.name)
                  + lam * torch.sum(torch.abs(x)))
        nnzs.append(torch.sum(x != 0))
    return x, z, torch.stack(fs), torch.stack(nnzs).to(torch.int32)


def fused_sparse_shotgun_rounds_ref(rows, vals, z, x, blk_idx, lam, beta, y,
                                    loss):
    """Multi-round oracle for ``fused_sparse_shotgun_rounds`` — the same
    trajectory computed from the nnz tiles: g_B = Σ_tile vals·r[rows], the
    margin by one scatter-add of vals·δ at rows per round, x by an
    accumulating index_put (duplicates add).  rows/vals (nblk, tile,
    block); x (nblk·block,); blk_idx (R, K).  Newton specs divide by
    max(Σ vals²·w[rows], 1e-8).  Returns (x (nblk·block,) f32, z (n,) f32,
    f (R,) f32, nnz (R,) int32)."""
    ls = resolve_loss(loss)
    nblk, tile, block = rows.shape
    x = x.float()
    z = z.float()
    y = y.float()
    ones = torch.ones_like(y)
    fs, nnzs = [], []
    for idx_t in blk_idx:
        idx_t = idx_t.long()
        r = obj.residual_like(z, y, ls.name)
        rows_k = rows[idx_t].long()                      # (K, tile, B)
        vals_k = vals[idx_t].float()
        g = torch.sum(vals_k * r[rows_k], dim=1)         # (K, B)
        if ls.newton:
            w = _curvature_weights_ref(z, y, ones, ls.name)
            h = torch.clamp_min(torch.sum(vals_k * vals_k * w[rows_k], dim=1),
                                1e-8)
        else:
            h = beta
        xb = x.reshape(nblk, block)
        x_sel = xb[idx_t]
        delta = obj.soft_threshold(x_sel - g / h, lam / h) - x_sel
        z = z.index_put((rows_k.reshape(-1),),
                        (vals_k * delta[:, None, :]).reshape(-1),
                        accumulate=True)
        x = xb.index_put((idx_t,), delta, accumulate=True).reshape(-1)
        fs.append(obj.masked_data_loss(z, y, ones, ls.name)
                  + lam * torch.sum(torch.abs(x)))
        nnzs.append(torch.sum(x != 0))
    return x, z, torch.stack(fs), torch.stack(nnzs).to(torch.int32)


def fused_shotgun_delta_rounds_ref(A, z, x, blk_idx, lam, beta, y, mask,
                                   loss, block: int):
    """Oracle for ``fused_shotgun_delta_rounds``: the same multi-round
    trajectory, reported as (x_new, dz) with dz = z_new − z₀ (what the
    shard contributes to the Δz all-reduce)."""
    x_new, z_new, _, _ = fused_shotgun_rounds_ref(A, z, x, blk_idx, lam,
                                                  beta, y, mask, loss, block)
    return x_new, z_new - z.float()


def fused_sparse_shotgun_delta_rounds_ref(rows, vals, z, x, blk_idx, lam,
                                          beta, y, loss):
    """Oracle for ``fused_sparse_shotgun_delta_rounds``: the same
    multi-round trajectory, reported as (x_new, dz) with dz = z_new − z₀."""
    x_new, z_new, _, _ = fused_sparse_shotgun_rounds_ref(
        rows, vals, z, x, blk_idx, lam, beta, y, loss)
    return x_new, z_new - z.float()


def block_shotgun_round_ref(A, z, x, blk_idx, lam, beta, y, loss, block: int):
    """One full Block-Shotgun round (oracle for ops.block_shotgun_round)."""
    r = obj.residual_like(z, y, loss)
    g = gather_block_matvec_ref(A, r, blk_idx, block)
    d = x.shape[0]
    xb = x.reshape(d // block, block)
    x_sel = xb[blk_idx.long()]
    x_new = obj.soft_threshold(x_sel - g / beta, lam / beta)
    delta = x_new - x_sel
    z_new = scatter_block_update_ref(A, z, blk_idx, delta, block)
    xb = xb.index_put((blk_idx.long(),), delta, accumulate=True)
    return xb.reshape(d), z_new, delta
