"""Shared plumbing for the baseline solvers the paper compares against
(port of ``repro.core.baselines.common``).

Every baseline runs its iterations as torch code on the problem's device
with no host sync inside: the reference's data-dependent ``while_loop``s
become one batch of every trial with the loop's exit picked on the device,
and conjugate gradients (``cg``) runs a fixed number of iterations with a
device-side mask that freezes the state once the reference's stopping test
holds.  x (and u, v, θ) is kept in f32 whatever A's dtype.  Dense designs
only, as the reference's (a ``BlockedCSC`` raises through
``objectives.require_dense``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import objectives as obj
from repro_torch.core.objectives import Problem

# The profiler range around a baseline's iterations (``torch.profiler``
# shows it by this name): the window in which no host sync may occur.
ITERS_RANGE = "repro_torch.baseline_iters"


class BaselineResult(NamedTuple):
    x: torch.Tensor
    objective: torch.Tensor          # (iters,) trace of F
    # The reference's data-dependent inner loops, as device tensors: CG
    # iterations (FPC_AS, L1_LS) and L1_LS's line-search halvings.  None
    # for the other solvers.
    inner: dict[str, torch.Tensor] | None = None


def require_lasso(prob: Problem, what: str) -> None:
    """The Lasso-only baselines raise ``ValueError`` for another loss,
    where the reference asserts."""
    if prob.loss != obj.LASSO:
        raise ValueError(f"{what} solves the Lasso only; the problem "
                         f"carries loss {prob.loss!r}")


def zeros_x(prob: Problem) -> torch.Tensor:
    """The f32 cold start on the problem's device."""
    return torch.zeros(prob.d, dtype=torch.float32, device=prob.A.device)


def sign(v: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: NaN stays NaN (``torch.sign`` maps it to 0)."""
    return torch.where(torch.isnan(v), v, torch.sign(v))


def grad_data(x, prob: Problem) -> torch.Tensor:
    """Full gradient of the data term: Aᵀ r(Ax)."""
    z = obj.matvec(prob.A, x)
    r = obj.residual_like(z, prob.y, prob.loss)
    return obj.rmatvec(prob.A, r)


def lipschitz(prob: Problem, iters: int = 60,
              generator: torch.Generator | None = None,
              v0=None) -> torch.Tensor:
    """Gradient Lipschitz constant of the data term (0-dim f32 on the
    device).  Lasso: ρ(AᵀA).  Logistic: ρ(AᵀA) / 4.  Power iteration from
    ``v0``, else a normal vector from ``generator`` (default seed 0)."""
    from repro_torch.core.spectral import spectral_radius
    rho = spectral_radius(prob.A, generator, iters=iters, v0=v0)
    return rho * (0.25 if prob.loss == obj.LOGISTIC else 1.0)


def cg(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
       x0: torch.Tensor | None = None, *, maxiter: int, tol: float = 1e-5,
       M: Callable[[torch.Tensor], torch.Tensor] | None = None
       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Conjugate gradients as ``jax.scipy.sparse.linalg.cg`` runs them;
    returns (x, iterations as a 0-dim int32 device tensor).

    The reference loops while rs > max(tol²·‖b‖², 0) and k < maxiter, rs
    being r·r with a preconditioner ``M`` and γ = r·M(r) without one.  Here
    every one of the ``maxiter`` iterations is computed and a device-side
    mask keeps x, r, γ and p where they were once that test fails, so the
    result is the loop's after as many iterations as it ran.  A frozen
    iteration may divide 0 by 0 (b = 0 gives γ = 0), so the mask selects
    with ``torch.where`` and never multiplies."""
    precond = M is not None
    M = M if precond else (lambda v: v)
    x = torch.zeros_like(b) if x0 is None else x0
    tol = torch.full((), tol, dtype=torch.float32, device=b.device)
    atol2 = torch.clamp_min(tol * tol * torch.dot(b, b), 0.0)
    r = b - matvec(x)
    p = M(r)
    gamma = torch.dot(r, p)
    k = torch.zeros((), dtype=torch.int32, device=b.device)
    done = torch.zeros((), dtype=torch.bool, device=b.device)
    for _ in range(maxiter):
        rs = torch.dot(r, r) if precond else gamma
        done = done | ~(rs > atol2)
        Ap = matvec(p)
        alpha = gamma / torch.dot(p, Ap)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z = M(r_new)
        gamma_new = torch.dot(r_new, z)
        p_new = z + (gamma_new / gamma) * p
        x = torch.where(done, x, x_new)
        r = torch.where(done, r, r_new)
        gamma = torch.where(done, gamma, gamma_new)
        p = torch.where(done, p, p_new)
        k = k + (~done).to(torch.int32)
    return x, k

