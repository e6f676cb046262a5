"""Shared neural-net layers of the LM substrate (port of
``repro.models.layers``): plain functions on tensors over explicit
parameter dicts.

Weights are drawn in float32 and cast to ``compute_dtype`` at use; a caller
may hold a matmul weight as its compute-dtype copy instead (the cast bits
are the same).  ``matmul`` casts both operands, accumulates in float32 and
rounds the result to the compute dtype once, as ``jax.lax.dot_general``
with ``preferred_element_type=float32`` followed by a cast does; on the
card that needs TF32 and cuBLAS's reduced-precision bf16 reduction off
(``device.exact_lm_matmul``).  Norms and RoPE compute in float32 and return
the input dtype.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.models import sharding as SH


def dense_init(shape, scale=None, *, generator=None, device=None,
               dtype=torch.float32):
    """Normal(0, 1)·scale in float32 (scale 1/√fan_in by default), then
    cast to ``dtype``: the draw is always float32, so a weight built as its
    bf16 copy has the bits of the float32 weight cast at use."""
    scale = 1.0 / math.sqrt(shape[0]) if scale is None else scale
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32).mul_(scale)
    return w if dtype == torch.float32 else w.to(dtype)


def matmul(x, w, compute_dtype):
    """``x @ w`` over x's last axis in ``compute_dtype``, accumulated in
    float32, the result rounded to ``compute_dtype``; a sharded weight is
    gathered over the fsdp axes first (``sharding.gather_fsdp``)."""
    return torch.matmul(x.to(compute_dtype),
                        SH.gather_fsdp(w).to(compute_dtype))


def matmul_f32(a, b):
    """``a @ b`` (batched) with float32 accumulation and a float32 result,
    for operands in any float dtype: JAX's ``preferred_element_type``
    without the final cast.  bf16/f16 products are exact in float32, so
    upcasting first gives the same sums; on the card a cuBLAS call with a
    float32 output does it without the copies where PyTorch has one, for
    inference only: that ``bmm`` has no backward, so a product that
    autograd records takes the float32 copies."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    recorded = torch.is_grad_enabled() and (a.requires_grad
                                            or b.requires_grad)
    # a DTensor takes the copies too: bmm(out_dtype=) has no sharding
    # strategy
    if a.is_cuda and a.dim() == 3 and b.dim() == 3 and not recorded \
            and type(a) is torch.Tensor and _bmm_out_dtype():
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


_BMM_OUT_DTYPE: list[bool] = []


def _bmm_out_dtype() -> bool:
    """Whether this PyTorch's ``bmm`` takes ``out_dtype`` on the card."""
    if not _BMM_OUT_DTYPE:
        try:
            a = torch.ones(1, 1, 1, dtype=torch.bfloat16, device="cuda")
            ok = torch.bmm(a, a, out_dtype=torch.float32).dtype == torch.float32
        except (TypeError, RuntimeError, NotImplementedError):
            ok = False
        _BMM_OUT_DTYPE.append(ok)
    return _BMM_OUT_DTYPE[0]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d, *, device=None):
    return {"scale": torch.ones(d, dtype=torch.float32, device=device)}


def rmsnorm(params, x, eps=1e-6):
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * params["scale"]).to(dt)


def layernorm_init(d, *, device=None):
    return {"scale": torch.ones(d, dtype=torch.float32, device=device),
            "bias": torch.zeros(d, dtype=torch.float32, device=device)}


def layernorm(params, x, eps=1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    return y.to(dt)


def norm_init(kind, d, *, device=None):
    return (layernorm_init(d, device=device) if kind == "layernorm"
            else rmsnorm_init(d, device=device))


def norm_apply(kind, params, x):
    return layernorm(params, x) if kind == "layernorm" else rmsnorm(params, x)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _const(v, dtype):
    """The Python float ``v`` rounded to ``dtype``, as JAX rounds a weak
    constant to its operand's dtype (computed once per pair)."""
    return float(torch.tensor(v, dtype=torch.float32).to(dtype))


def silu(x):
    """``jax.nn.silu`` as the reference computes it: x·(1 / (1 + exp(−x))),
    every op in x's dtype — for bf16 each op's result rounded, as JAX's
    lowering of ``logistic`` does — not the fused ``F.silu``, which rounds
    once."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu_tanh(x):
    """``jax.nn.gelu``'s default (the tanh form), op by op in x's dtype as
    the reference computes it: 0.5·(1 + tanh(√(2/π)·(x + 0.044715·x³)))
    times x, the constants rounded to x's dtype."""
    cube = x * (x * x)
    inner = _const(math.sqrt(2 / math.pi), x.dtype) * (
        x + _const(0.044715, x.dtype) * cube)
    return x * (0.5 * (1 + torch.tanh(inner)))


def softplus(x):
    """``jax.nn.softplus`` as the reference computes it, ``logaddexp(x,
    0)``: max(x, 0) + log1p(exp(−|x|))."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def activation(name, x):
    if name == "silu":
        return silu(x)
    if name == "gelu":                # jax.nn.gelu's default: the tanh form
        return gelu_tanh(x)
    if name == "relu2":               # squared ReLU (nemotron-4)
        r = F.relu(x)
        return r * r
    raise ValueError(name)


# ---------------------------------------------------------------------------
# RoPE (standard + M-RoPE): the two halves rotated (not interleaved)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim, theta=10000.0, *, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_cos_sin(positions, head_dim, theta=10000.0):
    """cos and sin of the rotary angles of ``positions`` (B, S), each
    (B, S, 1, Dh/2) float32 — shared by every head and, in a model, by q,
    k and every layer."""
    freqs = rope_freqs(head_dim, theta, device=positions.device)
    ang = positions[..., None].float() * freqs          # (B, S, Dh/2)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def rotate(x, cos, sin):
    """x (B, S, H, Dh) rotated by ``rope_cos_sin``'s angles, in float32,
    returned in x's dtype."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta=10000.0):
    """x: (B, S, H, Dh), positions: (B, S) integer."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], theta))


def mrope_sections(sections, half: int) -> list[int]:
    """Section id (0 temporal, 1 height, 2 width) of each of the ``half``
    rotary frequencies: ``jnp.repeat(arange(3), sections,
    total_repeat_length=half)`` — cut at ``half``, or padded with the last
    id when the sections sum to less."""
    ids = [i for i, n in enumerate(sections) for _ in range(n)][:half]
    return ids + [ids[-1]] * (half - len(ids))


def mrope_cos_sin(positions3, head_dim, sections, theta=10000.0):
    """``rope_cos_sin`` for M-RoPE: positions3 (B, 3, S), each rotary
    frequency rotated by its section's position stream."""
    freqs = rope_freqs(head_dim, theta, device=positions3.device)
    sec_id = torch.tensor(mrope_sections(sections, head_dim // 2),
                          device=positions3.device)
    pos = positions3.float()[:, sec_id, :]              # (B, Dh/2, S)
    ang = pos.transpose(1, 2) * freqs                   # (B, S, Dh/2)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_mrope(x, positions3, sections, theta=10000.0):
    """Multimodal RoPE (Qwen2-VL): the rotary frequencies are split into 3
    sections (temporal, height, width), each rotated by its own position
    stream.

    x: (B, S, H, Dh); positions3: (B, 3, S); sections: (t, h, w) halves
    summing to Dh/2.
    """
    return rotate(x, *mrope_cos_sin(positions3, x.shape[-1], sections,
                                    theta))


def sinusoidal_positions(seq, d, *, device=None):
    """Whisper-style fixed sinusoidal embeddings (S, D)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    inv = torch.exp(-math.log(10000.0) * dim / (d // 2 - 1))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLP (gated or plain)
# ---------------------------------------------------------------------------

def mlp_init(d_model, d_ff, gated=True, *, generator=None, device=None,
             dtype=torch.float32):
    kw = dict(generator=generator, device=device, dtype=dtype)
    p = {"wi": dense_init((d_model, d_ff), **kw),
         "wo": dense_init((d_ff, d_model), **kw)}
    if gated:
        p["wg"] = dense_init((d_model, d_ff), **kw)
    return p


def mlp_apply(params, x, act, compute_dtype):
    h = matmul(x, params["wi"], compute_dtype)
    if "wg" in params:
        g = matmul(x, params["wg"], compute_dtype)
        h = activation(act, g) * h
    else:
        h = activation(act, h)
    return matmul(h, params["wo"], compute_dtype)
