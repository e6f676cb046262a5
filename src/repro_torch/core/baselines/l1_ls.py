"""L1_LS (Kim, Koh, Lustig, Boyd, Gorinevsky 2007): log-barrier interior
point method for the Lasso, with Newton steps solved by (preconditioned) CG —
"the expensive step (PCG)" of the paper's Sec. 4.1.2 (port of
``repro.core.baselines.l1_ls``).

Formulation:  min_x,u  1/2||Ax − y||² + lam 1ᵀu   s.t.  −u <= x <= u
Barrier:      phi_t(x,u) = t(1/2||Ax−y||² + lam 1ᵀu) − Σ log(u+x) − Σ log(u−x)

Newton direction via CG on the (2d × 2d) KKT system using Hessian-vector
products (A touched only through matvecs), backtracking line search keeping
the iterate strictly feasible, and a geometric t-schedule.

The reference halves the step in a ``while_loop`` of up to MAX_LS
halvings, one pass over A a trial.  Here the MAX_LS + 1 trials s = 2⁻ʲ are
evaluated at once — their residuals A(x + s·dx) − y as one (n, d) ×
(d, MAX_LS + 1) product, one pass over A — and ``backtrack_step`` picks,
on the device, the trial the loop stops at.  The Newton step's CG is
``common.cg`` (the reference's early stop as a device-side mask over
``cg_iters`` iterations); the residual A x − y of the Newton step serves
the line search's phi(x, u) as well (the same product on the same x).
"""
from __future__ import annotations

import torch

from repro_torch.core import objectives as obj
from repro_torch.core.baselines.common import (ITERS_RANGE, BaselineResult,
                                               cg, require_lasso, zeros_x)
from repro_torch.core.objectives import Problem

ALPHA = 0.01
BETA_LS = 0.5
MAX_LS = 30


def _barrier_from_residual(r, x, u, t, lam) -> torch.Tensor:
    """phi_t at (x, u) from its residual r = A x − y, inf when infeasible;
    batched over trailing columns: r (n, J), x and u (d, J) give (J,)."""
    f = 0.5 * torch.sum(r * r, dim=0) + lam * torch.sum(u, dim=0)
    s1 = u + x
    s2 = u - x
    bad = torch.any(s1 <= 0, dim=0) | torch.any(s2 <= 0, dim=0)
    val = (t * f - torch.sum(torch.log(torch.clamp_min(s1, 1e-30)), dim=0)
           - torch.sum(torch.log(torch.clamp_min(s2, 1e-30)), dim=0))
    return torch.where(bad, torch.inf, val)


def _barrier_value(x, u, t, prob: Problem) -> torch.Tensor:
    """phi_t(x, u) (inf when infeasible)."""
    r = obj.matvec(prob.A, x) - prob.y
    return _barrier_from_residual(r[:, None], x[:, None], u[:, None], t,
                                  prob.lam)[0]


def backtrack_step(phi0, gdot, phi_t) -> torch.Tensor:
    """The trial the reference's backtracking loop stops at, from all of
    them: ``phi_t`` (MAX_LS + 1,) holds phi at s = BETA_LS^j.  The loop
    halves while phi exceeds phi0 + ALPHA·s·gdot and fewer than MAX_LS
    halvings were made; a NaN trial stops it.  Returns j (0-dim)."""
    s = BETA_LS ** torch.arange(phi_t.shape[0], dtype=torch.float32,
                                device=phi_t.device)
    return obj.first_stop(phi_t > phi0 + ALPHA * s * gdot)


def l1_ls_solve(prob: Problem, outer: int = 12, newton_per_t: int = 2,
                cg_iters: int = 40, t0: float = 0.1,
                mu: float = 4.0) -> BaselineResult:
    """``outer`` barrier weights t = t0·muᵏ with ``newton_per_t`` Newton
    steps each, from x = 0, u = 1; the trace holds F after each weight.
    ``inner["cg"]`` and ``inner["halvings"]`` hold each Newton step's CG
    iterations and line-search halvings."""
    require_lasso(prob, "L1_LS")
    A, y, lam = obj.require_dense(prob.A, "L1_LS"), prob.y, prob.lam
    d = A.shape[1]
    dev = A.device
    x = zeros_x(prob)
    u = torch.ones(d, dtype=torch.float32, device=dev)
    t = torch.full((), t0, dtype=torch.float32, device=dev)
    mu = torch.full((), mu, dtype=torch.float32, device=dev)
    steps = BETA_LS ** torch.arange(MAX_LS + 1, dtype=torch.float32,
                                    device=dev)

    def newton_step(x, u, t):
        r = obj.matvec(A, x) - y
        s1 = u + x            # > 0
        s2 = u - x            # > 0
        i1, i2 = 1.0 / s1, 1.0 / s2
        # gradients
        gx = t * obj.rmatvec(A, r) - i1 + i2
        gu = t * lam - i1 - i2
        # Hessian blocks: Hxx = 2t AᵀA + D1+D2 ; Hxu=Hux = D1−D2 ; Huu = D1+D2
        D1, D2 = i1 * i1, i2 * i2
        dpl, dmi = D1 + D2, D1 - D2

        def hvp(p):
            px, pu = p[:d], p[d:]
            hx = t * obj.rmatvec(A, obj.matvec(A, px)) + dpl * px + dmi * pu
            hu = dmi * px + dpl * pu
            return torch.cat([hx, hu])

        g = torch.cat([gx, gu])
        # Jacobi preconditioner from the diagonal of H
        diagH = torch.cat([t + dpl, dpl])
        dxu, k = cg(hvp, -g, M=lambda p: p / diagH, maxiter=cg_iters)
        dx, du = dxu[:d], dxu[d:]

        # backtracking line search, keeping strict feasibility: every
        # trial at once, the loop's stop picked on the device
        phi0 = _barrier_from_residual(r[:, None], x[:, None], u[:, None], t,
                                      lam)[0]
        gdot = torch.dot(g, dxu)
        xt = x[:, None] + steps * dx[:, None]                  # (d, J)
        ut = u[:, None] + steps * du[:, None]
        phi_t = _barrier_from_residual(obj.matvec(A, xt) - y[:, None], xt,
                                       ut, t, lam)
        j = backtrack_step(phi0, gdot, phi_t)
        s = obj.take(steps, j)
        return x + s * dx, u + s * du, k, j

    fs, cgs, halvings = [], [], []
    with torch.profiler.record_function(ITERS_RANGE):
        for _ in range(outer):
            for _ in range(newton_per_t):
                x, u, k, j = newton_step(x, u, t)
                cgs.append(k)
                halvings.append(j)
            t = t * mu
            fs.append(obj.objective(x, prob))
    return BaselineResult(x=x, objective=torch.stack(fs), inner={
        "cg": torch.stack(cgs), "halvings": torch.stack(halvings)})
