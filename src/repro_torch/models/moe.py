"""Mixture-of-Experts block (port of ``repro.models.moe``): top-k router +
GShard-style *grouped* capacity dispatch.

Tokens are split into groups of ``GROUP_SIZE``; within a group each
(token, slot) pick takes the next free row of its expert's buffer of
``cap`` rows, in token-major, slot-minor order, and a pick past ``cap``
is dropped.  Where the reference builds (G, T_g, E, C) one-hot dispatch
and combine tensors and contracts them, the port moves rows by index:
each kept pick's token is copied into its (expert, row), and its expert
output is gathered back and weighted.  Each buffer row receives at most
one token, so the dispatch is exact, and the combine keeps the
reference's rounding points — the expert output rounded to the compute
dtype, the gate rounded to it, the weighted sum over the picks in
float32.  ``sharding.shard_as`` does nothing without a mesh and is left
out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

GROUP_SIZE = 512


def moe_init(cfg, *, generator=None, device=None, dtype=torch.float32):
    """The router stays float32 (the reference routes in float32); the
    expert weights are drawn in float32 and cast to ``dtype``."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {
        "router": L.dense_init((d, e), scale=0.02, generator=generator,
                               device=device),
        "wi": L.dense_init((e, d, f), **kw),
        "wg": L.dense_init((e, d, f), **kw),
        "wo": L.dense_init((e, f, d), **kw),
    }


def _route(p, xt, cfg):
    """xt: (..., D) -> (gate_vals, gate_idx) (..., k), renormalized; the
    logits in float32 from the float32 router."""
    logits = torch.matmul(xt.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.moe_top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return gate_vals, gate_idx


def _experts(xe, p, dtype):
    """(E, N, D) rows through each expert's gated MLP: both input products
    and silu(g)·h in ``dtype``; returns the float32-accumulated output
    products, (E, N, D) float32, unrounded."""
    h = torch.matmul(xe, p["wi"].to(dtype))
    g = torch.matmul(xe, p["wg"].to(dtype))
    return L.matmul_f32(L.silu(g) * h, p["wo"].to(dtype))


def moe_dense_apply(p, x, cfg, dtype):
    """Dropless path: every expert for every token, combined by gate, the
    expert outputs and the gates in float32.  Used for decode-sized token
    counts."""
    b, s, d = x.shape
    e = cfg.num_experts
    xt = x.reshape(b * s, d)
    gate_vals, gate_idx = _route(p, xt, cfg)
    gates = torch.zeros(b * s, e, dtype=torch.float32, device=x.device)
    gates.scatter_(1, gate_idx, gate_vals)
    ye = _experts(xt.to(dtype).expand(e, b * s, d), p, dtype)   # (E, T, D)
    yt = torch.einsum("etd,te->td", ye, gates).to(dtype)
    return yt.reshape(b, s, d)


def moe_apply(p, x, cfg, dtype):
    """x: (B, S, D) -> (B, S, D) via grouped capacity dispatch (the dense
    path for t ≤ 4E or t < 2·GROUP_SIZE tokens)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.moe_top_k
    t = b * s
    if t <= 4 * e or t < 2 * GROUP_SIZE:     # decode / tiny batches
        return moe_dense_apply(p, x, cfg, dtype)

    g = max(1, t // GROUP_SIZE)
    tg = t // g
    if g * tg != t:
        raise ValueError(
            f"token count t={t} does not split into g={g} groups of "
            f"tg={tg} (b={b}, s={s}, GROUP_SIZE={GROUP_SIZE})")
    xt = x.reshape(g, tg, d)
    gate_vals, gate_idx = _route(p, xt, cfg)            # (g, tg, k)
    cap = min(max(8, int(tg * k * cfg.moe_capacity_factor / e)), tg)
    pos, keep = capacity_slots(gate_idx, e, cap)
    # each kept pick's (group, expert, row) in a flat buffer of g·E·cap
    # rows; a dropped pick goes to one spare row past the end, which is
    # zero when gathered from and thrown away when written to
    spare = g * e * cap
    group = torch.arange(g, device=x.device)[:, None, None]
    row = torch.where(keep, (group * e + gate_idx) * cap + pos, spare)
    row = row.reshape(-1)
    buf = torch.zeros(spare + 1, d, dtype=dtype, device=x.device)
    buf[row] = xt.to(dtype)[:, :, None, :].expand(g, tg, k, d).reshape(-1, d)
    xe = buf[:spare].view(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)
    ye = _experts(xe, p, dtype).to(dtype)                # rounded, as ref.
    ye = ye.view(e, g, cap, d).transpose(0, 1).reshape(spare, d)
    ye = torch.cat([ye, ye.new_zeros(1, d)])
    comb = (gate_vals.to(dtype) * keep).float()          # (g, tg, k)
    yt = (ye[row].view(g, tg, k, d).float() * comb[..., None]).sum(2)
    return yt.to(dtype).reshape(b, s, d)


def capacity_slots(gate_idx, e, cap):
    """(pos, keep) of each pick of ``gate_idx`` (g, tg, k): its row in its
    expert's buffer (the picks of that expert before it, token-major and
    slot-minor, within its group) and whether that row is below ``cap``."""
    g, tg, k = gate_idx.shape
    onehot = F.one_hot(gate_idx.long(), e).reshape(g, tg * k, e)
    pos = torch.cumsum(onehot, dim=1) - onehot
    pos = (pos * onehot).sum(-1).reshape(g, tg, k)
    return pos, pos < cap


def aux_load_balance_loss(logits, gate_idx, e):
    """Switch-style auxiliary loss (mean fraction * mean prob per
    expert)."""
    probs = torch.softmax(logits.float(), dim=-1)
    frac = F.one_hot(gate_idx[:, 0].long(), e).float().mean(0)
    return e * torch.sum(frac * probs.mean(0))
