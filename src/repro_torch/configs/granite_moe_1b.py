"""Granite-3.0-1B-A400M [moe] — 24L d_model=1024 16H (GQA kv=8) expert
d_ff=512, 32 experts top-8, vocab=49155.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.models.model import ModelConfig, LayerSpec
from repro_torch.configs.common import shrink, lm_shapes_no_long

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", num_layers=24, d_model=1024, num_heads=16,
    num_kv_heads=8, head_dim=64, d_ff=512, vocab_size=49155,
    pattern=(LayerSpec(mixer="attn", ffn="moe"),),
    num_experts=32, moe_top_k=8, moe_d_ff=512)

SUPPORTS = lm_shapes_no_long()

def smoke_config():
    return shrink(CONFIG)
