"""SpaRSA (Wright, Nowak, Figueiredo 2009): iterative shrinkage/thresholding
with a Barzilai-Borwein spectral step and a nonmonotone acceptance test
(port of ``repro.core.baselines.sparsa``).

    alpha_k  from BB:  alpha = (Δg · Δx) / (Δx · Δx)   (curvature estimate)
    x_{k+1}  = S(x_k − g_k / alpha, lam / alpha)
    accept if F decreases vs the max of the last M objectives (safeguarded by
    doubling alpha up to MAX_TRIES times).

The reference doubles alpha in a ``while_loop``, one pass over A a trial.
Here the MAX_TRIES + 1 trials alpha·2ʲ are formed at once and their F
come from one (n, d) × (d, MAX_TRIES + 1) product — one pass over A — and
``accept_trial`` picks, on the device, the trial the loop stops at.
"""
from __future__ import annotations

import torch

from repro_torch.core import objectives as obj
from repro_torch.core.baselines.common import (ITERS_RANGE, BaselineResult,
                                               grad_data, zeros_x)
from repro_torch.core.objectives import Problem

M_HISTORY = 5
MAX_TRIES = 10


def accept_trial(f_ref, alphas, f_t, sq_step) -> torch.Tensor:
    """The trial the reference's acceptance loop stops at, from all of
    them: ``alphas``, ``f_t`` and ``sq_step`` (MAX_TRIES + 1,) hold each
    trial's step, F and ‖x_t − x‖².  The loop doubles while F exceeds
    f_ref − 1e-5·alpha·½‖x_t − x‖² and fewer than MAX_TRIES doublings
    were made; a NaN trial stops it."""
    return obj.first_stop(f_t > f_ref - 1e-5 * alphas * 0.5 * sq_step)


def sparsa_solve(prob: Problem, iters: int = 500) -> BaselineResult:
    """``iters`` SpaRSA iterations from x = 0."""
    A, lam = obj.require_dense(prob.A, "SpaRSA"), prob.lam
    x = zeros_x(prob)
    g = grad_data(x, prob)
    hist = obj.objective(x, prob).expand(M_HISTORY).clone()
    alpha = torch.ones((), dtype=torch.float32, device=x.device)
    doubling = 2.0 ** torch.arange(MAX_TRIES + 1, dtype=torch.float32,
                                   device=x.device)
    fs = []
    with torch.profiler.record_function(ITERS_RANGE):
        for _ in range(iters):
            f_ref = torch.max(hist)
            a = alpha * doubling                               # (J,)
            xt = obj.soft_threshold(x[:, None] - g[:, None] / a,
                                    lam / a)                    # (d, J)
            f_t = (obj.data_loss_cols(obj.matvec(A, xt), prob.y, prob.loss)
                   + lam * torch.sum(torch.abs(xt), dim=0))
            dxt = xt - x[:, None]
            j = accept_trial(f_ref, a, f_t, torch.sum(dxt * dxt, dim=0))
            alpha_f = obj.take(a, j)
            x_new = obj.take(xt, j, dim=1)
            f_new = obj.take(f_t, j)

            g_new = grad_data(x_new, prob)
            dx = x_new - x
            dg = g_new - g
            denom = torch.dot(dx, dx)
            bb = torch.where(denom > 1e-30, torch.dot(dx, dg) / denom,
                             alpha_f)
            alpha = torch.clamp(bb, 1e-3, 1e10)
            hist = torch.cat([hist[1:], f_new[None]])
            x, g = x_new, g_new
            fs.append(f_new)
    return BaselineResult(x=x, objective=torch.stack(fs))
