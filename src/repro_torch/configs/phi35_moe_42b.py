"""Phi-3.5-MoE (42B total / 6.6B active) [moe] — 32L d_model=4096 32H
(GQA kv=8) expert d_ff=6400, 16 experts top-2, vocab=32064.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from repro_torch.models.model import ModelConfig, LayerSpec
from repro_torch.configs.common import shrink, lm_shapes_no_long

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", num_layers=32, d_model=4096, num_heads=32,
    num_kv_heads=8, head_dim=128, d_ff=6400, vocab_size=32064,
    pattern=(LayerSpec(mixer="attn", ffn="moe"),),
    num_experts=16, moe_top_k=2, moe_d_ff=6400)

SUPPORTS = lm_shapes_no_long()

def smoke_config():
    return shrink(CONFIG)
