"""Mamba2-2.7B [ssm] — 64L d_model=2560, attention-free SSD blocks,
ssm_state=128, vocab=50280.  [arXiv:2405.21060; unverified]"""
from repro_torch.models.model import ModelConfig, LayerSpec
from repro_torch.configs.common import shrink, all_shapes

CONFIG = ModelConfig(
    name="mamba2-2.7b", num_layers=64, d_model=2560, num_heads=1,
    num_kv_heads=1, head_dim=64, d_ff=0, vocab_size=50280,
    pattern=(LayerSpec(mixer="mamba", ffn="none"),),
    mamba_expand=2, mamba_head_dim=64, ssm_state=128)

SUPPORTS = all_shapes()   # SSM: O(1) decode state -> long_500k runs

def smoke_config():
    return shrink(CONFIG)
