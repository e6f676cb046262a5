"""Jamba-1.5-Large (398B) [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576, Mamba:attn 1:7 interleave (attn at i%8==4), MoE 16e top-2 every
2nd layer, vocab=65536.  [arXiv:2403.19887; hf]"""
import torch
from repro_torch.models.model import ModelConfig, jamba_pattern
from repro_torch.configs.common import shrink, all_shapes

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", num_layers=72, d_model=8192, num_heads=64,
    num_kv_heads=8, head_dim=128, d_ff=24576, vocab_size=65536,
    pattern=jamba_pattern(),
    num_experts=16, moe_top_k=2, moe_d_ff=24576,
    mamba_expand=2, mamba_head_dim=64, ssm_state=16,
    optimizer="adafactor", param_dtype=torch.bfloat16)

SUPPORTS = all_shapes()   # hybrid: mamba-dominant -> long_500k runs

def smoke_config():
    return shrink(CONFIG)
