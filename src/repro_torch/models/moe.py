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
float32.

Sharded (``models.sharding``), both paths run on each rank's groups
(batch axes) with the expert weights where the rules place them (the
comment above ``_products``); the expert buffers are laid out as the
reference pins its dispatched tensors, groups on batch, and the combined
rows, partial sums over the tensor axis, are reduced to groups on batch —
one all-reduce, as the reference's combine.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import sharding as SH

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
    logits = torch.matmul(xt.float(), SH.gather_fsdp(p["router"]).float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.moe_top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return gate_vals, gate_idx


def _experts(xe, p, dtype):
    """(E, N, D) rows through each expert's gated MLP: both input products
    and silu(g)·h in ``dtype``; returns the float32-accumulated output
    products, (E, N, D) float32, unrounded."""
    h, g = _products(xe, p["wi"], p["wg"], dtype)
    return L.matmul_f32(L.silu(g) * h, p["wo"].to(dtype))


def moe_dense_apply(p, x, cfg, dtype):
    """Dropless path: every expert for every token, combined by gate, the
    expert outputs and the gates in float32.  Used for decode-sized token
    counts."""
    b, s, d = x.shape
    e = cfg.num_experts
    if SH.is_sharded(x):
        return _dense_sharded(p, x, cfg, dtype)
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
    if SH.is_sharded(x):
        yt = _capacity_sharded(p, xt, gate_idx, gate_vals, pos, keep, cap,
                               dtype)
        return yt.to(dtype).reshape(b, s, d)
    row = _rows(gate_idx, pos, keep, e, cap)
    ye = _experts(_dispatch(xt, row, e, cap, dtype), p, dtype).to(dtype)
    yt = _combine(ye, row, gate_vals, keep, cap, dtype)  # ye rounded, as ref.
    return yt.to(dtype).reshape(b, s, d)


def _rows(gate_idx, pos, keep, e, cap):
    """Each kept pick's (group, expert, row) in a flat buffer of g·E·cap
    rows, (g·tg·k,); a dropped pick goes to one spare row past the end,
    which is zero when gathered from and thrown away when written to."""
    g = gate_idx.shape[0]
    group = torch.arange(g, device=gate_idx.device)[:, None, None]
    row = torch.where(keep, (group * e + gate_idx) * cap + pos, g * e * cap)
    return row.reshape(-1)


def _dispatch(xt, row, e, cap, dtype):
    """xt (g, tg, D) -> the expert buffers (E, g·cap, D) in ``dtype``,
    each pick's token at its ``row``."""
    g, tg, d = xt.shape
    k = row.numel() // (g * tg)
    buf = torch.zeros(g * e * cap + 1, d, dtype=dtype, device=xt.device)
    buf[row] = xt.to(dtype)[:, :, None, :].expand(g, tg, k, d).reshape(-1, d)
    return buf[:-1].view(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)


def _combine(ye, row, gate_vals, keep, cap, dtype):
    """The expert outputs ``ye`` (E, g·cap, D) gathered back to the picks
    at ``row`` and weighted by their gates: (g, tg, D) float32."""
    e, _, d = ye.shape
    g, tg, k = gate_vals.shape
    ye = ye.view(e, g, cap, d).transpose(0, 1).reshape(g * e * cap, d)
    ye = torch.cat([ye, ye.new_zeros(1, d)])
    comb = (gate_vals.to(dtype) * keep).float()          # (g, tg, k)
    return (ye[row].view(g, tg, k, d).float() * comb[..., None]).sum(2)


# Sharded (``models.sharding``), the experts run in the layouts the rules
# give their weights.  The reference's rules name ``wi``/``wg`` and ``wo``
# of the MLP and the attention before the MoE's own, so the first match
# puts ``wi``/``wg`` (E, D, F) on (fsdp, tensor) and ``wo`` (E, F, D) on
# (tensor, fsdp).  Each rank therefore takes its rows' slice of D to every
# expert's ``wi`` and ``wg`` products, partial sums over the tensor axis
# in the compute dtype that one all-reduce each completes (on one rank,
# the plain products bit for bit); the gated hidden goes on to its own
# experts' ``wo`` (E on the tensor axis), and the combined rows, partial
# sums over that axis, are reduced as the reference's combine.  The fsdp
# axes are gathered at the use, as ZeRO-3 gathers a layer's weights.  No
# expert weight moves across the tensor axis.

def _products(xe, wi, wg, dtype):
    """Each expert's two input products of ``xe`` (E, N, D') in ``dtype``
    (sharded, partial sums over a slice of D)."""
    return torch.matmul(xe, wi.to(dtype)), torch.matmul(xe, wg.to(dtype))


def _gated(h, g):
    """silu(g)·h from the reduced products."""
    return L.silu(SH.reduce_partials(g)) * SH.reduce_partials(h)


def _dense_sharded(p, x, cfg, dtype):
    b, s, d = x.shape
    e = cfg.num_experts
    rows, dcol = SH.axis("batch", b), SH.axis("tensor", d)
    ex = SH.axis("tensor", e)
    h, g = SH.local_call(
        lambda x, wi, wg: _products(
            x.reshape(-1, x.shape[-1]).to(dtype).expand(e, -1, -1), wi, wg,
            dtype),
        (x, p["wi"], p["wg"]),
        ((rows, None, dcol), (None, dcol, None), (None, dcol, None)),
        ((None, rows, None),) * 2, partial=dcol)

    def out(a, wo, x, router):
        bl = x.shape[0]
        xt = x.reshape(bl * s, d)
        gate_vals, gate_idx = _route({"router": router}, xt, cfg)
        gates = torch.zeros(bl * s, e, dtype=torch.float32, device=x.device)
        gates.scatter_(1, gate_idx, gate_vals)
        e0 = SH.first_index(ex, e)
        ye = L.matmul_f32(a, wo.to(dtype))               # (E', T', D)
        yt = torch.einsum("etd,te->td", ye, gates[:, e0:e0 + ye.shape[0]])
        return yt.reshape(bl, s, d)

    yt = SH.local_call(
        out, (_gated(h, g), p["wo"], x, p["router"]),
        ((ex, rows, None), (ex, None, None), (rows, None, None),
         (None, None)), (rows, None, None), partial=ex)
    return SH.shard_as(yt, "batch", None, None).to(dtype)


def _capacity_sharded(p, xt, gate_idx, gate_vals, pos, keep, cap, dtype):
    """The capacity path's (g, tg, D) float32 on the ranks' groups."""
    g, tg, d = xt.shape
    e = p["wi"].shape[0]
    rows, dcol = SH.axis("batch", g), SH.axis("tensor", d)
    ex = SH.axis("tensor", e)
    picks = (rows, None, None)
    h, hg = SH.local_call(
        lambda x, i, ps, kp, wi, wg: _products(
            _dispatch(x, _rows(i, ps, kp, e, cap), e, cap, dtype), wi, wg,
            dtype),
        (xt, gate_idx, pos, keep, p["wi"], p["wg"]),
        ((rows, None, dcol),) + (picks,) * 3 + ((None, dcol, None),) * 2,
        ((None, rows, None),) * 2, partial=dcol)

    def out(a, wo, i, v, ps, kp):
        e0, el = SH.first_index(ex, e), a.shape[0]
        ye = L.matmul_f32(a, wo.to(dtype)).to(dtype)     # rounded, as ref.
        mine = kp & (i >= e0) & (i < e0 + el)
        return _combine(ye, _rows(i - e0, ps, mine, el, cap), v, mine, cap,
                        dtype)

    yt = SH.local_call(
        out, (_gated(h, hg), p["wo"], gate_idx, gate_vals, pos, keep),
        ((ex, rows, None), (ex, None, None)) + (picks,) * 4, picks,
        partial=ex)
    return SH.shard_as(yt, "batch", None, None)


def capacity_slots(gate_idx, e, cap):
    """(pos, keep) of each pick of ``gate_idx`` (g, tg, k): its row in its
    expert's buffer (the picks of that expert before it, token-major and
    slot-minor, within its group) and whether that row is below ``cap``."""
    g, tg, k = gate_idx.shape
    # one-hot by comparison: F.one_hot reads its indices' largest value
    onehot = (gate_idx.long()[..., None] == torch.arange(
        e, device=gate_idx.device)).long().reshape(g, tg * k, e)
    pos = torch.cumsum(onehot, dim=1) - onehot
    pos = (pos * onehot).sum(-1).reshape(g, tg, k)
    return pos, pos < cap


def aux_load_balance_loss(logits, gate_idx, e):
    """Switch-style auxiliary loss (mean fraction * mean prob per
    expert)."""
    probs = torch.softmax(logits.float(), dim=-1)
    frac = F.one_hot(gate_idx[:, 0].long(), e).float().mean(0)
    return e * torch.sum(frac * probs.mean(0))
