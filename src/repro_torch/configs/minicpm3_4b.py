"""MiniCPM3-4B [dense] — 62L d_model=2560 40H d_ff=6400 vocab=73448, MLA
(multi-head latent attention: q_lora=768, kv_lora=256, nope/rope=64/32).
[hf:openbmb/MiniCPM3-4B; hf]"""
from repro_torch.models.model import ModelConfig
from repro_torch.configs.common import shrink, lm_shapes_no_long

CONFIG = ModelConfig(
    name="minicpm3-4b", num_layers=62, d_model=2560, num_heads=40,
    num_kv_heads=40, head_dim=64, d_ff=6400, vocab_size=73448,
    attn_kind="mla", q_lora_rank=768, kv_lora_rank=256,
    qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64)

SUPPORTS = lm_shapes_no_long()

def smoke_config():
    return shrink(CONFIG)
