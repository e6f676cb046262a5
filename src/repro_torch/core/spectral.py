"""Spectral-radius estimation and the P* plug-in (Sec. 3.1; port of
``repro.core.spectral``).

rho = spectral radius of AᵀA (its largest eigenvalue; AᵀA is PSD).
P*  = ceil(d / rho) — the paper's predicted maximal useful parallelism.

Power iteration touches A only through the ``objectives.matvec``/``rmatvec``
seam (O(nd) per step dense, O(nnz) for a BlockedCSC) and never forms AᵀA.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import objectives as obj


def spectral_radius(A, generator: torch.Generator | None = None,
                    iters: int = 100, v0=None) -> torch.Tensor:
    """Largest eigenvalue of AᵀA by power iteration with a Rayleigh
    quotient; 0-dim f32 on A's device.  The start vector is ``v0`` when
    given, else standard normal from ``generator`` (default: seed 0 on A's
    device)."""
    d = A.shape[1]
    dev = A.device
    if v0 is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        v0 = torch.randn(d, generator=generator, device=dev)
    v = torch.as_tensor(v0, dtype=torch.float32, device=dev)
    v = v / torch.linalg.vector_norm(v)
    for _ in range(iters):
        w = obj.rmatvec(A, obj.matvec(A, v))
        v = w / torch.clamp_min(torch.linalg.vector_norm(w), 1e-30)
    Av = obj.matvec(A, v)
    return torch.dot(Av, Av) / torch.clamp_min(torch.dot(v, v), 1e-30)


def p_star(A, generator: torch.Generator | None = None, iters: int = 100,
           v0=None) -> int:
    """P* = ceil(d / rho): the plug-in estimate of the ideal parallelism.

    Power iteration approaches rho from below; the 1% slack keeps d/rho
    from landing epsilon above an integer."""
    rho = float(spectral_radius(A, generator, iters, v0))
    return int(math.ceil(A.shape[1] / max(rho, 1.0) - 0.01))


def p_star_dup(A, generator: torch.Generator | None = None, iters: int = 100,
               v0=None) -> int:
    """Duplicated-feature bound of Thm 3.2: P < 2d/rho + 1."""
    rho = float(spectral_radius(A, generator, iters, v0))
    return int(math.ceil(2 * A.shape[1] / max(rho, 1.0)))


def p_star_blocks(A, block: int = 128,
                  generator: torch.Generator | None = None, iters: int = 100,
                  v0=None) -> int:
    """P* in ``block``-sized coordinate blocks (>= 1): the backoff floor for
    the block solvers, whose unit is K blocks of 128 coordinates."""
    return max(1, -(-p_star(A, generator, iters, v0) // block))
