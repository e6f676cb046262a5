"""Whisper-large-v3 [audio] — 32L enc + 32L dec, d_model=1280 20H d_ff=5120
vocab=51866; encoder-decoder; conv audio frontend is a STUB per brief
(input_specs provides precomputed 1500-frame embeddings).
[arXiv:2212.04356; unverified]"""
from repro_torch.models.model import ModelConfig
from repro_torch.configs.common import shrink, lm_shapes_no_long

CONFIG = ModelConfig(
    name="whisper-large-v3", num_layers=32, d_model=1280, num_heads=20,
    num_kv_heads=20, head_dim=64, d_ff=5120, vocab_size=51866,
    norm="layernorm", activation="gelu", gated=False,
    encoder_layers=32, encoder_seq=1500, frontend="audio_stub")

# Whisper HAS a decoder -> decode shapes run (max positions raised to cover
# the 32k spec'd shape; the real model caps at 448 — noted in DESIGN.md).
SUPPORTS = lm_shapes_no_long()

def smoke_config():
    return shrink(CONFIG)
