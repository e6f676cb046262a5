"""Δz wire compression with error feedback (port of
``repro.dist.compression``, DESIGN §7).

Schemes
-------
``none``   identity (f32 on the wire).
``bf16``   round-to-nearest bfloat16; 2 B/element, no scale.
``int8``   per-leaf symmetric int8: q = round(x / s), s = max|x| / 127;
           stochastic rounding from a ``torch.Generator`` when one is given
           (unbiased: E[dequant(q)] = x).
``topk``   magnitude top-k sparsification; (index, value) pairs on the wire.

``compress_grads`` composes any scheme with error feedback: the residual of
what compression dropped is added back into the next step's input, so the
running sum of transmitted values tracks the running sum of true values.
All helpers take dicts of tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

SCHEMES = ("none", "bf16", "int8", "topk")


class QuantInt8(NamedTuple):
    q: torch.Tensor        # int8 payload, same shape as the input
    scale: torch.Tensor    # 0-dim f32


class TopK(NamedTuple):
    idx: torch.Tensor      # (k,) int64 flat indices
    val: torch.Tensor      # (k,) f32 kept values
    size: int              # original (flattened) length


def quantize_int8(x: torch.Tensor,
                  generator: torch.Generator | None = None) -> QuantInt8:
    """Symmetric int8 quantization; stochastic rounding with a generator."""
    x = x.float()
    scale = torch.clamp_min(torch.max(torch.abs(x)), 1e-12) / 127.0
    scaled = x / scale
    if generator is None:
        q = torch.round(scaled)          # half to even, as jnp.round
    else:
        lo = torch.floor(scaled)
        u = torch.rand(x.shape, generator=generator, device=x.device)
        q = lo + (u < scaled - lo).float()
    return QuantInt8(q=torch.clamp(q, -127, 127).to(torch.int8), scale=scale)


def dequantize_int8(qt: QuantInt8) -> torch.Tensor:
    return qt.q.float() * qt.scale


def topk_compress(x: torch.Tensor, k: int) -> TopK:
    """Keep the k largest-magnitude entries of the flattened input."""
    flat = x.float().reshape(-1)
    k = max(1, min(int(k), flat.shape[0]))
    _, idx = torch.topk(torch.abs(flat), k)
    return TopK(idx=idx, val=flat[idx], size=flat.shape[0])


def topk_decompress(tk: TopK) -> torch.Tensor:
    out = torch.zeros(tk.size, dtype=torch.float32, device=tk.val.device)
    return out.index_put((tk.idx,), tk.val)


def ef_init(grads: dict) -> dict:
    """Zero error-feedback residuals matching ``grads``."""
    return {k: torch.zeros_like(v, dtype=torch.float32)
            for k, v in grads.items()}


def _compress_leaf(g, scheme: str, topk_frac: float, generator):
    """The receiver-side dense reconstruction of one leaf."""
    if scheme == "none":
        return g
    if scheme == "bf16":
        return g.to(torch.bfloat16).float()
    if scheme == "int8":
        return dequantize_int8(quantize_int8(g, generator)).reshape(g.shape)
    if scheme == "topk":
        k = max(1, int(round(g.numel() * topk_frac)))
        return topk_decompress(topk_compress(g, k)).reshape(g.shape)
    raise ValueError(f"unknown compression scheme: {scheme!r}")


def compress_grads(grads: dict, ef: dict, scheme: str = "none",
                   topk_frac: float = 0.01,
                   generator: torch.Generator | None = None):
    """(wire, ef_new): wire is the receiver-side dense reconstruction of
    ``grads + ef`` under ``scheme``; ef_new is what compression dropped."""
    wire, ef_new = {}, {}
    for name, g in grads.items():
        tot = g.float() + ef[name]
        w = _compress_leaf(tot, scheme, topk_frac, generator)
        wire[name] = w
        ef_new[name] = tot - w
    return wire, ef_new


def wire_bytes(grads: dict, scheme: str = "none",
               topk_frac: float = 0.01) -> int:
    """Bytes on the wire per all-reduce under ``scheme`` (accounting)."""
    sizes = [g.numel() for g in grads.values()]
    if scheme == "none":
        return sum(4 * s for s in sizes)
    if scheme == "bf16":
        return sum(2 * s for s in sizes)             # no scale scalar
    if scheme == "int8":
        return sum(s + 4 for s in sizes)             # payload + f32 scale
    if scheme == "topk":
        return sum(8 * max(1, int(round(s * topk_frac))) for s in sizes)
    raise ValueError(f"unknown compression scheme: {scheme!r}")
