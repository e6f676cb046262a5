"""Hard_l0 (Blumensath & Davies 2009): iterative hard thresholding (port of
``repro.core.baselines.iht``).

    x <- H_s(x + mu Aᵀ(y − A x))

keeps the s largest-magnitude entries.  Following the paper's protocol, s is
set to the sparsity found by Shooting.  Normalized IHT step: mu chosen as
||g_S||²/||A g_S||² on the current support (stability fix from the NIHT
follow-up; plain mu=1 diverges when ρ(AᵀA) > 1).

The reference's residual recomputes A x, the product it took for F at the
end of the previous iteration on the same x; the port carries that margin
(three passes over A an iteration, the same values).
"""
from __future__ import annotations

import torch

from repro_torch.core import objectives as obj
from repro_torch.core.baselines.common import (ITERS_RANGE, BaselineResult,
                                               require_lasso, zeros_x)
from repro_torch.core.objectives import Problem


def _hard_threshold(x: torch.Tensor, s: int) -> torch.Tensor:
    """x where |x| is at least the s-th largest |x|, else 0: every tie at
    the threshold is kept, and with fewer than s nonzeros the threshold is
    0 and all of x is kept."""
    thresh = torch.topk(torch.abs(x), s).values[-1]
    return torch.where(torch.abs(x) >= thresh, x, 0.0)


def iht_solve(prob: Problem, s: int, iters: int = 500) -> BaselineResult:
    """``iters`` normalized IHT iterations at sparsity ``s`` from x = 0."""
    require_lasso(prob, "IHT")
    A, y = obj.require_dense(prob.A, "IHT"), prob.y
    x = zeros_x(prob)
    z = obj.matvec(A, x)
    fs = []
    with torch.profiler.record_function(ITERS_RANGE):
        for _ in range(iters):
            g = obj.rmatvec(A, y - z)
            # normalized step on the (proxy) support of the gradient update
            gs = _hard_threshold(g, s)
            Ag = obj.matvec(A, gs)
            mu = torch.dot(gs, gs) / torch.clamp_min(torch.dot(Ag, Ag), 1e-30)
            x = _hard_threshold(x + mu * g, s)
            z = obj.matvec(A, x)
            # report the L1 objective for comparability
            fs.append(obj.objective_from_margin(z, x, prob))
    return BaselineResult(x=x, objective=torch.stack(fs))
