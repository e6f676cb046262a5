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


def exact_lm_matmul() -> None:
    """The LM path's products on the card as the reference computes them:
    float32 in full float32 (``exact_f32_matmul``) and bf16 products
    reduced in float32 — PyTorch lets cuBLAS reduce bf16 split-K partial
    sums in bf16 unless told otherwise.  Called by the LM entry points
    (``models.model.forward``/``decode_step``) on CUDA tensors; the solver
    paths leave the bf16 flag as it is."""
    exact_f32_matmul()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
