"""Qwen1.5-110B [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064, QKV bias.  [hf:Qwen/Qwen1.5-110B family; hf]"""
import torch
from repro_torch.models.model import ModelConfig
from repro_torch.configs.common import shrink, lm_shapes_no_long

CONFIG = ModelConfig(
    name="qwen1.5-110b", num_layers=80, d_model=8192, num_heads=64,
    num_kv_heads=8, head_dim=128, d_ff=49152, vocab_size=152064,
    qkv_bias=True, rope_theta=1e6,
    optimizer="adafactor", param_dtype=torch.bfloat16)

SUPPORTS = lm_shapes_no_long()

def smoke_config():
    return shrink(CONFIG)
