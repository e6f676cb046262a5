"""Nemotron-4-340B [dense] — 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000, squared-ReLU MLP (ungated).  [arXiv:2402.16819; unverified]"""
import torch
from repro_torch.models.model import ModelConfig
from repro_torch.configs.common import shrink, lm_shapes_no_long

CONFIG = ModelConfig(
    name="nemotron-4-340b", num_layers=96, d_model=18432, num_heads=96,
    num_kv_heads=8, head_dim=192, d_ff=73728, vocab_size=256000,
    activation="relu2", gated=False,
    optimizer="adafactor", param_dtype=torch.bfloat16)

SUPPORTS = lm_shapes_no_long()

def smoke_config():
    return shrink(CONFIG)
