"""Shared helpers for the assigned-architecture configs (port of
``repro.configs.common``; dtypes as ``torch.dtype``).

Every config module exposes:
    CONFIG          the exact published configuration (full scale)
    smoke_config()  a reduced same-family config for CPU smoke tests
    SUPPORTS        which of the 4 input shapes apply (with skip reasons)
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.model import ModelConfig

# (seq_len, global_batch, step kind)
SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}

SKIP_LONG = ("SKIP: pure full-attention arch — 500k dense KV decode is "
             "quadratic-cost; per brief only SSM/hybrid run long_500k")


def shrink(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family config for smoke tests (small layers/width/experts,
    tiny vocab) — structure (pattern, attention kind, MoE, frontend) intact."""
    kv = min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4
    kw = dict(
        num_layers=2 * len(cfg.pattern),
        d_model=128,
        num_heads=4,
        num_kv_heads=kv,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        compute_dtype=torch.float32,
        param_dtype=torch.float32,
        cache_dtype=torch.float32,
        remat=False,
    )
    if cfg.attn_kind == "mla":
        kw.update(q_lora_rank=48, kv_lora_rank=32, qk_nope_dim=16,
                  qk_rope_dim=16, v_head_dim=32)
    if cfg.num_experts:
        kw.update(num_experts=min(cfg.num_experts, 4),
                  moe_top_k=min(cfg.moe_top_k, 2), moe_d_ff=128,
                  moe_capacity_factor=8.0)   # no drops -> decode parity
    if cfg.encoder_layers:
        kw.update(encoder_layers=2, encoder_seq=16)
    if any(s.mixer == "mamba" for s in cfg.pattern):
        kw.update(ssm_state=16, mamba_head_dim=32, mamba_expand=2)
    kw.update(overrides)
    return dataclasses.replace(cfg, **kw)


def all_shapes():
    return dict(SHAPES)


def lm_shapes_no_long(reason=SKIP_LONG):
    s = dict(SHAPES)
    s["long_500k"] = reason
    return s
