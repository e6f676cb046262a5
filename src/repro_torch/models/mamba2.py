"""Mamba-2 layer (port of ``repro.models.mamba2``; Dao & Gu 2024,
arXiv:2405.21060) — the chunked SSD (state-space duality) algorithm for
prefill, the O(1)-state recurrence for decode.

Layer: separate input projections [z | x | B, C | dt] -> causal depthwise
conv (width 4) on x and on (B, C) -> SSD(x·dt, A·dt, B, C) -> gated
RMSNorm(y, z) -> out_proj.

Rounding points, as the reference's: the SSD's big operands (x·dt, the
intra-chunk decay matrix, C·Bᵀ, the chunk-state decays, the carried
states) are rounded to the compute dtype, every contraction accumulates
in float32 (products of compute-dtype operands are exact in float32, so
the port upcasts and multiplies in float32), and the inter-chunk
recurrence and the decode step run in float32.  Decode state: ``ssm``
(B, heads, head_dim, state) and the conv windows ``conv_x`` / ``conv_bc``
(B, 3, channels), all float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import sharding as SH

CONV_W = 4


def mamba_dims(cfg):
    d_inner = cfg.mamba_expand * cfg.d_model
    heads = d_inner // cfg.mamba_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_state   # x, B, C share the conv
    return d_inner, heads, conv_dim


def mamba_init(cfg, *, generator=None, device=None, dtype=torch.float32):
    """Separate projection weights per stream (z, x, BC, dt), as the
    reference's.  ``A_log``, ``D`` and ``dt_bias`` stay float32 (read in
    float32); conv biases are float32 zeros."""
    d = cfg.d_model
    d_inner, heads, _ = mamba_dims(cfg)
    n2 = 2 * cfg.ssm_state
    kw = dict(generator=generator, device=device, dtype=dtype)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "wz": L.dense_init((d, d_inner), **kw),
        "wx": L.dense_init((d, d_inner), **kw),
        "wbc": L.dense_init((d, n2), **kw),
        "wdt": L.dense_init((d, heads), **kw),
        "conv_w_x": L.dense_init((CONV_W, d_inner), scale=0.5, **kw),
        "conv_b_x": torch.zeros(d_inner, **f32),
        "conv_w_bc": L.dense_init((CONV_W, n2), scale=0.5, **kw),
        "conv_b_bc": torch.zeros(n2, **f32),
        "A_log": torch.log(torch.arange(1, heads + 1, **f32)),
        "D": torch.ones(heads, **f32),
        "dt_bias": torch.zeros(heads, **f32),
        "norm": L.rmsnorm_init(d_inner, device=device),
        "out_proj": L.dense_init((d_inner, d), **kw),
    }


def _causal_conv(x, w, bias, dtype):
    """Depthwise causal conv over (B, S, C): the CONV_W products of each
    output summed in float32 and rounded to ``dtype``, then the bias in
    ``dtype``."""
    s = x.shape[1]
    xp = F.pad(x.to(dtype), (0, 0, CONV_W - 1, 0))
    wd = w.to(dtype).float()
    acc = xp[:, 0:s].float() * wd[0]
    for i in range(1, CONV_W):
        acc = acc + xp[:, i:i + s].float() * wd[i]
    return acc.to(dtype) + bias.to(dtype)


def _conv(x, w, bias, dtype):
    """``_causal_conv``; on DTensors, on each rank's rows and channels
    (PyTorch 2.11's DTensor cannot plan the padding's redistribution)."""
    if not SH.is_sharded(x):
        return _causal_conv(x, w, bias, dtype)
    rows = SH.axis("batch", x.shape[0])
    ch = SH.axis("tensor", x.shape[-1])
    return SH.local_call(lambda x, w, b: _causal_conv(x, w, b, dtype),
                         (x, w, bias), ((rows, None, ch), (None, ch), (ch,)),
                         (rows, None, ch))


def _cumsum(x, dim):
    """``torch.cumsum`` along ``dim``; on the card, a product with a
    triangular matrix of ones, as CUDA's floating-point cumsum has no
    deterministic kernel (``torch.use_deterministic_algorithms`` refuses
    it, and ``launch.train`` runs with it on)."""
    if not x.is_cuda:
        return torch.cumsum(x, dim=dim)
    n = x.shape[dim]
    upper = torch.ones(n, n, dtype=x.dtype, device=x.device).triu()
    return torch.matmul(x.movedim(dim, -1), upper).movedim(-1, dim)


def _segsum(x):
    """Stable segment-sum: out[..., i, j] = sum_{j < k <= i} x[..., k]
    (-inf above the diagonal)."""
    T = x.shape[-1]
    xx = x[..., None].expand(*x.shape, T)                # X[..., i, j] = x_i
    below = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device),
                       diagonal=-1)
    xs = _cumsum(torch.where(below, xx, 0.0), dim=-2)
    on = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
    return torch.where(on, xs, float("-inf"))


def ssd_chunked(x, dt, A, Bm, Cm, chunk, edt=torch.bfloat16):
    """SSD algorithm (minimal-mamba2 style), chunked over the sequence.

    x: (b, s, h, p), dt: (b, s, h) float32, A: (h,) negative, Bm/Cm:
    (b, s, n).  Returns (y (b, s, h, p) in x's dtype, final state
    (b, h, p, n) float32)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if s % chunk:
        raise ValueError(f"seq_len={s} is not a multiple of chunk={chunk}")
    c = s // chunk
    xdt = (x.float() * dt[..., None]).to(edt)            # (b, s, h, p)
    Adt = A[None, None, :] * dt                          # (b, s, h) f32
    xc = xdt.reshape(b, c, chunk, h, p)
    Ac = Adt.reshape(b, c, chunk, h).permute(0, 3, 1, 2)  # (b, h, c, l)
    Bc = Bm.to(edt).reshape(b, c, chunk, n)
    Cc = Cm.to(edt).reshape(b, c, chunk, n)
    A_cum = _cumsum(Ac, dim=-1)                          # (b, h, c, l) f32
    # 1. intra-chunk (diagonal block) output; the decay matrix, C·Bᵀ and
    # their product in edt, the contraction over s in float32
    Lmat = torch.exp(_segsum(Ac)).to(edt)                # (b, h, c, l, l)
    CB = L.matmul_f32(Cc.reshape(b * c, chunk, n),
                      Bc.reshape(b * c, chunk, n).transpose(1, 2))
    CB = CB.to(edt).view(b, 1, c, chunk, chunk)
    M = Lmat * CB                                        # (b, h, c, l, s)
    xh = xc.permute(0, 3, 1, 2, 4)                       # (b, h, c, s, p)
    Y_diag = L.matmul_f32(M.reshape(-1, chunk, chunk),
                          xh.reshape(-1, chunk, p)).view(b, h, c, chunk, p)
    # 2. chunk-final states: Σ_l B[l, n]·(decay[l]·x[l, p])
    decay_states = torch.exp(A_cum[..., -1:] - A_cum).to(edt)   # (b,h,c,l)
    wx = xh.float() * decay_states.float()[..., None]    # (b, h, c, l, p)
    states = torch.matmul(wx.transpose(-1, -2),
                          Bc.float()[:, None])           # (b, h, c, p, n)
    # 3. inter-chunk recurrence on chunk states (float32)
    chunk_decay = torch.exp(A_cum[..., -1])              # (b, h, c)
    state = torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device)
    prev = []
    for i in range(c):
        prev.append(state.to(edt))
        state = state * chunk_decay[..., i, None, None] + states[:, :, i]
    prev_states = torch.stack(prev, dim=2)               # (b, h, c, p, n)
    # 4. state -> output contribution: Σ_n (C[l, n]·decay[l])·state[p, n],
    # paired as the reference's einsum pairs them
    state_decay = torch.exp(A_cum).to(edt)               # (b, h, c, l)
    Cd = Cc.float()[:, None] * state_decay.float()[..., None]  # (b,h,c,l,n)
    Y_off = torch.matmul(Cd, prev_states.float().transpose(-1, -2))
    y = (Y_diag + Y_off).permute(0, 2, 3, 1, 4).reshape(b, s, h, p)
    return y.to(x.dtype), state


def mamba_apply(p, hidden, cfg, dtype, chunk=128):
    """Full-sequence (prefill) forward.  Returns (out, (final ssm state,
    (conv_x tail, conv_bc tail))), the tails the last CONV_W - 1 rows of
    the conv inputs."""
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    d_inner, heads, _ = mamba_dims(cfg)
    z = L.matmul(hidden, p["wz"], dtype)                 # (b, s, d_inner)
    x_pre = L.matmul(hidden, p["wx"], dtype)             # (b, s, d_inner)
    bc_pre = L.matmul(hidden, p["wbc"], dtype)           # (b, s, 2n)
    dt = L.matmul(hidden, p["wdt"], dtype)               # (b, s, heads)
    conv_tail = (x_pre[:, -(CONV_W - 1):], bc_pre[:, -(CONV_W - 1):])
    x = L.silu(_conv(x_pre, p["conv_w_x"], p["conv_b_x"], dtype))
    bc = L.silu(_conv(bc_pre, p["conv_w_bc"], p["conv_b_bc"], dtype))
    Bm, Cm = bc[..., :cfg.ssm_state], bc[..., cfg.ssm_state:]
    dt = L.softplus(dt.float() + p["dt_bias"])           # (b, s, h)
    A = -torch.exp(p["A_log"])                           # (h,) negative
    xh = x.reshape(b, s, heads, cfg.mamba_head_dim)
    args = (xh.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype))
    ssd = lambda *a: ssd_chunked(*a, chunk, edt=dtype)  # noqa: E731
    if SH.is_sharded(xh):
        rows, hs = SH.axis("batch", b), SH.axis("tensor", heads)
        y, final_state = SH.local_call(
            ssd, args, ((rows, None, hs, None), (rows, None, hs), (hs,),
                        (rows, None, None), (rows, None, None)),
            ((rows, None, hs, None), (rows, hs, None, None)))
    else:
        y, final_state = ssd(*args)
    y = y.float() + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(b, s, d_inner).to(dtype)
    y = L.rmsnorm(p["norm"], y * L.silu(z))              # gated norm
    return L.matmul(y, p["out_proj"], dtype), (final_state, conv_tail)


def mamba_state_init(cfg, batch, dtype=torch.float32, *, device=None):
    d_inner, heads, _ = mamba_dims(cfg)
    kw = dict(dtype=dtype, device=device)
    return {
        "ssm": torch.zeros(batch, heads, cfg.mamba_head_dim, cfg.ssm_state,
                           **kw),
        "conv_x": torch.zeros(batch, CONV_W - 1, d_inner, **kw),
        "conv_bc": torch.zeros(batch, CONV_W - 1, 2 * cfg.ssm_state, **kw),
    }


def _conv_step(window_prev, new, w, bias, dtype):
    """Ring-buffer depthwise conv step.  window_prev: (b, W-1, C) float32,
    new: (b, C).  Returns (out (b, C) in ``dtype``, next window)."""
    window = torch.cat([window_prev, new[:, None].to(window_prev.dtype)],
                       dim=1)                            # (b, W, C)
    out = (window.to(dtype).float() * w.to(dtype).float()).sum(1)
    return out.to(dtype) + bias.to(dtype), window[:, 1:]


def _ssm_step(xh, dt, Bm, Cm, A, D, ssm):
    """The recurrence of one token, float32: h <- decay·h + dt·x Bᵀ,
    y = C h + D x (x·(dt·B), as the reference's einsum pairs them).
    Returns (y (b, h, p), the next state)."""
    decay = torch.exp(A[None] * dt)                      # (b, h)
    dBx = xh[..., None] * (dt[..., None] * Bm[:, None, :])[:, :, None, :]
    ssm = ssm * decay[..., None, None] + dBx
    y = torch.matmul(ssm, Cm[:, None, :, None])[..., 0]  # (b, h, p)
    return y + xh * D[None, :, None], ssm


def mamba_decode_step(p, hidden, state, cfg, dtype):
    """One-token recurrent step.  hidden: (b, 1, d).  Returns (out
    (b, 1, d), the next state as a new dict)."""
    b = hidden.shape[0]
    d_inner, heads, _ = mamba_dims(cfg)
    h0 = hidden[:, 0]
    z = L.matmul(h0, p["wz"], dtype)
    x_pre = L.matmul(h0, p["wx"], dtype)
    bc_pre = L.matmul(h0, p["wbc"], dtype)
    dt = L.matmul(h0, p["wdt"], dtype)
    x, conv_x = _conv_step(state["conv_x"], x_pre, p["conv_w_x"],
                           p["conv_b_x"], dtype)
    bc, conv_bc = _conv_step(state["conv_bc"], bc_pre, p["conv_w_bc"],
                             p["conv_b_bc"], dtype)
    x = L.silu(x)
    bc = L.silu(bc)
    Bm, Cm = bc[..., :cfg.ssm_state].float(), bc[..., cfg.ssm_state:].float()
    dt = L.softplus(dt.float() + p["dt_bias"])           # (b, h)
    A = -torch.exp(p["A_log"])
    xh = x.reshape(b, heads, cfg.mamba_head_dim).float()
    args = (xh, dt, Bm, Cm, A, p["D"], state["ssm"])
    if SH.is_sharded(xh):
        rows, hs = SH.axis("batch", b), SH.axis("tensor", heads)
        y, ssm = SH.local_call(
            _ssm_step, args, ((rows, hs, None), (rows, hs), (rows, None),
                              (rows, None), (hs,), (hs,),
                              (rows, hs, None, None)),
            ((rows, hs, None), (rows, hs, None, None)))
    else:
        y, ssm = _ssm_step(*args)
    y = y.reshape(b, d_inner).to(dtype)
    y = L.rmsnorm(p["norm"], y * L.silu(z))
    out = L.matmul(y, p["out_proj"], dtype)[:, None]     # (b, 1, d)
    return out, {"ssm": ssm, "conv_x": conv_x, "conv_bc": conv_bc}
