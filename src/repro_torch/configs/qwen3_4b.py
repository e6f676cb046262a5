"""Qwen3-4B [dense] — 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936, qk-norm.  [hf:Qwen/Qwen3-4B family; hf]"""
from repro_torch.models.model import ModelConfig
from repro_torch.configs.common import shrink, lm_shapes_no_long

CONFIG = ModelConfig(
    name="qwen3-4b", num_layers=36, d_model=2560, num_heads=32,
    num_kv_heads=8, head_dim=128, d_ff=9728, vocab_size=151936,
    qk_norm=True, rope_theta=1e6)

SUPPORTS = lm_shapes_no_long()

def smoke_config():
    return shrink(CONFIG)
