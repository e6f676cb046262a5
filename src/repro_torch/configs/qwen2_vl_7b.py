"""Qwen2-VL-7B [vlm] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064, M-RoPE (3-D positions); vision frontend is a STUB per brief
(input_specs provides patch embeddings / 3-D position ids).
[arXiv:2409.12191; hf]"""
from repro_torch.models.model import ModelConfig
from repro_torch.configs.common import shrink, lm_shapes_no_long

CONFIG = ModelConfig(
    name="qwen2-vl-7b", num_layers=28, d_model=3584, num_heads=28,
    num_kv_heads=4, head_dim=128, d_ff=18944, vocab_size=152064,
    qkv_bias=True, mrope=True, mrope_sections=(16, 24, 24),
    rope_theta=1e6, frontend="vision_stub")

SUPPORTS = lm_shapes_no_long()

def smoke_config():
    return shrink(CONFIG)
