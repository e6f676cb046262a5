"""FPC_AS (Wen, Yin, Goldfarb, Zhang 2010), two-phase structure (port of
``repro.core.baselines.fpc_as``):

Phase 1 (fixed-point continuation / iterative shrinkage): estimate the
support and signs of x via IST sweeps
    x <- S(x − tau g, tau lam)

Phase 2 (active-set subspace optimization): freeze the support and signs;
the objective restricted to {x : sign(x) = sigma fixed} is smooth and
quadratic (Lasso), minimized with CG; fall back to phase 1 if signs break.

The reference's IST gradient recomputes A x, the product it took for F at
the end of the previous sweep on the same x; the port carries that margin
(two passes over A a sweep, the same values).  CG is ``common.cg``: the
reference's early stop as a device-side mask over ``sub_iters``
iterations.
"""
from __future__ import annotations

import torch

from repro_torch.core import objectives as obj
from repro_torch.core.baselines.common import (ITERS_RANGE, BaselineResult,
                                               cg, lipschitz, require_lasso,
                                               sign, zeros_x)
from repro_torch.core.objectives import Problem


def _fpc_as(prob: Problem, tau, ist_iters: int, sub_iters: int,
            cycles: int) -> BaselineResult:
    A, y, lam = obj.require_dense(prob.A, "FPC_AS"), prob.y, prob.lam
    x = zeros_x(prob)
    z = obj.matvec(A, x)
    Aty = obj.rmatvec(A, y)
    fs, cg_iters = [], []
    with torch.profiler.record_function(ITERS_RANGE):
        for _ in range(cycles):
            for _ in range(ist_iters):
                g = obj.rmatvec(A, obj.residual_like(z, y, prob.loss))
                x = obj.soft_threshold(x - tau * g, tau * lam)
                z = obj.matvec(A, x)
                fs.append(obj.objective_from_margin(z, x, prob))
            # CG on the smooth problem restricted to the current signed
            # support: min_w 1/2||A(m*w)−y||² + lam sigmaᵀ(m*w), m = |sign|
            sigma = sign(x)
            m = (sigma != 0).to(x.dtype)
            b = m * Aty - lam * sigma
            w, k = cg(lambda p: m * obj.rmatvec(A, obj.matvec(A, m * p)), b,
                      x0=x, maxiter=sub_iters)
            x_new = m * w
            z_new = obj.matvec(A, x_new)
            # keep only if signs held and objective improved
            ok = torch.all(sign(x_new) * sigma >= 0)
            better = (obj.objective_from_margin(z_new, x_new, prob)
                      < obj.objective_from_margin(z, x, prob))
            keep = ok & better
            x = torch.where(keep, x_new, x)
            z = torch.where(keep, z_new, z)
            fs.append(obj.objective_from_margin(z, x, prob))
            cg_iters.append(k)
    return BaselineResult(x=x, objective=torch.stack(fs),
                          inner={"cg": torch.stack(cg_iters)})


def fpc_as_solve(prob: Problem, ist_iters: int = 50, sub_iters: int = 20,
                 cycles: int = 8, *, v0=None, L=None) -> BaselineResult:
    """``cycles`` of ``ist_iters`` IST sweeps (step 1 / (1.01·L)) and one
    subspace CG of at most ``sub_iters`` iterations, from x = 0; the trace
    holds F after every sweep and after every subspace phase.  L is
    ``lipschitz(prob)`` (from ``v0``) unless given.
    ``inner["cg"]`` holds each cycle's CG iteration count."""
    require_lasso(prob, "FPC_AS")
    if L is None:
        L = lipschitz(prob, v0=v0)
    L = torch.as_tensor(L, dtype=torch.float32, device=prob.A.device)
    tau = 1.0 / (L * 1.01)
    return _fpc_as(prob, tau, ist_iters, sub_iters, cycles)
