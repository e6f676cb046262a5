"""GPSR-BB (Figueiredo, Nowak, Wright 2008): gradient projection for sparse
reconstruction on the bound-constrained QP split x = u − v, u, v >= 0
(port of ``repro.core.baselines.gpsr``):

    min_{u,v>=0}  1/2 ||A(u−v) − y||^2 + lam 1ᵀ(u + v)

with a Barzilai-Borwein step and projection onto the nonnegative orthant.
Lasso only (the paper uses it only for the Lasso comparisons).

The reference's gradient recomputes A(u − v), the product it took for F
at the end of the previous iteration on the same x; the port carries that
margin, so an iteration makes three passes over A (Aᵀ r, A(du − dv),
A x) with the same values.
"""
from __future__ import annotations

import torch

from repro_torch.core import objectives as obj
from repro_torch.core.baselines.common import (ITERS_RANGE, BaselineResult,
                                               require_lasso, zeros_x)
from repro_torch.core.objectives import Problem


def gpsr_bb_solve(prob: Problem, iters: int = 500) -> BaselineResult:
    """``iters`` GPSR-BB iterations from u = v = 0."""
    require_lasso(prob, "GPSR-BB")
    A, y, lam = obj.require_dense(prob.A, "GPSR-BB"), prob.y, prob.lam
    u = v = zeros_x(prob)
    z = obj.matvec(A, u - v)
    alpha = torch.ones((), dtype=torch.float32, device=u.device)
    fs = []
    with torch.profiler.record_function(ITERS_RANGE):
        for _ in range(iters):
            gu = obj.rmatvec(A, z - y) + lam
            gv = -gu + 2.0 * lam                 # −Aᵀ r + lam
            u_new = torch.clamp_min(u - gu / alpha, 0.0)
            v_new = torch.clamp_min(v - gv / alpha, 0.0)
            du = u_new - u
            dv = v_new - v
            # BB update: alpha = ||A(du − dv)||² / (||du||² + ||dv||²)
            Ad = obj.matvec(A, du - dv)
            denom = torch.dot(du, du) + torch.dot(dv, dv)
            alpha = torch.clamp(torch.where(
                denom > 1e-30, torch.dot(Ad, Ad) / denom, alpha), 1e-3, 1e10)
            u, v = u_new, v_new
            x = u - v
            z = obj.matvec(A, x)
            fs.append(obj.objective_from_margin(z, x, prob))
    return BaselineResult(x=u - v, objective=torch.stack(fs))
