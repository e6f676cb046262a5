"""Assigned-architecture registry (port of ``repro.configs``): --arch <id>
resolves here."""
from repro_torch.configs import (qwen15_110b, minicpm3_4b, qwen3_4b,
                                 nemotron4_340b, whisper_large_v3, mamba2_27b,
                                 qwen2_vl_7b, phi35_moe_42b, granite_moe_1b,
                                 jamba_15_large)
from repro_torch.configs.common import SHAPES  # noqa: F401

ARCHS = {
    "qwen1.5-110b": qwen15_110b,
    "minicpm3-4b": minicpm3_4b,
    "qwen3-4b": qwen3_4b,
    "nemotron-4-340b": nemotron4_340b,
    "whisper-large-v3": whisper_large_v3,
    "mamba2-2.7b": mamba2_27b,
    "qwen2-vl-7b": qwen2_vl_7b,
    "phi3.5-moe-42b-a6.6b": phi35_moe_42b,
    "granite-moe-1b-a400m": granite_moe_1b,
    "jamba-1.5-large-398b": jamba_15_large,
}


def get(arch_id: str):
    return ARCHS[arch_id]
