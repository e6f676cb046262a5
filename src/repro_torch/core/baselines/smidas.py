"""SMIDAS (Shalev-Shwartz & Tewari 2009): stochastic mirror descent with
truncation, using the p-norm link with p = 2 ln d (port of
``repro.core.baselines.smidas``).

State is the dual vector theta; primal x = f^{-1}(theta) with
    f^{-1}(theta)_j = sign(theta_j) |theta_j|^{q−1} / ||theta||_q^{q−2},
q = p/(p−1).  Update: theta <- trunc(theta − eta g, eta lam).

The paper's observation (Sec. 4.2.3): iteration cost is much higher than
SGD's because every update touches the full dual vector.  Draws as in
``sgd``: an explicit ``idx`` stream or a ``torch.Generator``, all drawn
before the first step.
"""
from __future__ import annotations

import torch

from repro_torch.core import objectives as obj
from repro_torch.core.baselines.common import (ITERS_RANGE, BaselineResult,
                                               zeros_x)
from repro_torch.core.baselines.sgd import (_loss_deriv, chunk_rows,
                                            draw_stream)
from repro_torch.core.objectives import Problem


def _link_inv(theta: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """f^{-1}(theta); the sign is the copysign form, so a NaN stays NaN."""
    nq = torch.sum(torch.abs(theta) ** q) ** (1.0 / q)
    nq = torch.clamp_min(nq, 1e-30)
    return torch.copysign(torch.abs(theta) ** (q - 1.0) / nq ** (q - 2.0),
                          theta)


def link_q(d: int, device) -> torch.Tensor:
    """q = p / (p − 1) with p = 2 ln max(d, 3), in f32 as the reference
    computes it (a float64 p gives another q)."""
    p = 2.0 * torch.log(torch.full((), float(max(d, 3)), dtype=torch.float32,
                                   device=device))
    return p / (p - 1.0)


def smidas_solve(prob: Problem, generator: torch.Generator | None = None,
                 eta: float = 0.05, steps: int = 1000,
                 record_every: int = 100, *, idx=None) -> BaselineResult:
    """``steps // record_every`` chunks of ``record_every`` SMIDAS steps
    from theta = 0; the trace holds F of f^{-1}(theta) after each chunk.
    ``idx`` (chunks·record_every,) fixes the rows drawn; otherwise they
    come from ``generator``."""
    A, y, lam = obj.require_dense(prob.A, "SMIDAS"), prob.y, prob.lam
    n, d = A.shape
    q = link_q(d, A.device)
    lam_eff = lam / n
    num_chunks = steps // record_every
    rows = draw_stream(idx, generator, (num_chunks * record_every,), n,
                       A.device)
    theta = zeros_x(prob)
    shrink = eta * lam_eff
    fs = []
    with torch.profiler.record_function(ITERS_RANGE):
        for c in range(num_chunks):
            a_c, y_c = chunk_rows(A, y, rows[c * record_every:
                                             (c + 1) * record_every])
            for a, y_i in zip(a_c, y_c):
                x = _link_inv(theta, q)
                gscale = _loss_deriv(torch.dot(a, x), y_i, prob.loss)
                theta = theta - eta * a * gscale
                theta = obj.soft_threshold(theta, shrink)   # truncation
            fs.append(obj.objective(_link_inv(theta, q), prob))
    return BaselineResult(x=_link_inv(theta, q), objective=torch.stack(fs))
