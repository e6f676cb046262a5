"""FISTA (accelerated proximal gradient) — the reference oracle (port of
``repro.core.baselines.fista``).

Not one of the paper's five competitors, but the cleanest way to compute a
certified F* for the convergence experiments and the tests (O(1/T²) with a
known Lipschitz step; monotone restart variant).

The reference evaluates F at both the new and the previous iterate every
iteration.  The F it keeps, min(F(x_new), F(x)), is exactly F of the
iterate it keeps, so the port carries it: three passes over A an
iteration (A v, Aᵀ r, A x_new) where the reference makes four, with the
same values.
"""
from __future__ import annotations

import torch

from repro_torch.core import objectives as obj
from repro_torch.core.baselines.common import (ITERS_RANGE, BaselineResult,
                                               lipschitz, zeros_x)
from repro_torch.core.objectives import Problem


def _fista(prob: Problem, L: torch.Tensor, iters: int) -> BaselineResult:
    A, y, lam = obj.require_dense(prob.A, "FISTA"), prob.y, prob.lam
    x = v = zeros_x(prob)
    f = obj.objective_from_margin(torch.zeros_like(y), x, prob)   # F(0)
    t = torch.ones((), dtype=torch.float32, device=x.device)
    fs = []
    with torch.profiler.record_function(ITERS_RANGE):
        for _ in range(iters):
            r = obj.residual_like(obj.matvec(A, v), y, prob.loss)
            g = obj.rmatvec(A, r)
            x_new = obj.soft_threshold(v - g / L, lam / L)
            t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
            v_new = x_new + ((t - 1.0) / t_new) * (x_new - x)
            f_new = obj.objective(x_new, prob)
            # monotone safeguard: restart momentum if F increased
            worse = f_new > f
            x_out = torch.where(worse, x, x_new)
            v = torch.where(worse, x, v_new)
            t = torch.where(worse, 1.0, t_new)
            f = torch.minimum(f_new, f)
            x = x_out
            fs.append(f)
    return BaselineResult(x=x, objective=torch.stack(fs))


def fista_solve(prob: Problem, iters: int = 2000, *, v0=None,
                L=None) -> BaselineResult:
    """``iters`` FISTA iterations from x = 0 with step 1 / (1.01·L).  L is
    ``lipschitz(prob)`` (power iteration from ``v0``, else from a seed-0
    normal vector) unless given."""
    if L is None:
        L = lipschitz(prob, v0=v0)
    L = torch.as_tensor(L, dtype=torch.float32, device=prob.A.device)
    return _fista(prob, L * 1.01, iters)


def f_star(prob: Problem, iters: int = 4000, **kw) -> float:
    """Certified-enough optimum for tolerance experiments: the last F of
    ``fista_solve`` (the one read back to the host)."""
    return float(fista_solve(prob, iters, **kw).objective[-1])
