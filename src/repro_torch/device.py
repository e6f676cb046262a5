"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    there is no card (the port never carries on quietly on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions")
    return dev


def exact_f32_matmul() -> None:
    """Keep float32 products on the card in full float32: TF32 keeps about
    three decimal digits, far looser than the tolerances the port is held
    to.  Called by every function that runs ``torch.matmul``/``einsum`` on
    a CUDA tensor."""
    torch.backends.cuda.matmul.allow_tf32 = False
