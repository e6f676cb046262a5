"""Shooting CDN / Shotgun CDN (Sec. 4.2.1; port of ``repro.core.cdn``).

Coordinate Descent Newton (Yuan et al., 2010) replaces the fixed 1/β step
of Shooting with a per-coordinate Newton step on a quadratic model, then a
backtracking (Armijo) line search.  P coordinates take their Newton
directions from the same iterate; one step size is backtracked on the
collective update (cheap: with the maintained margin z, F costs O(n) a
trial).

The reference backtracks in a ``while_loop`` of up to ``MAX_BACKTRACK``
halvings.  Here all ``MAX_BACKTRACK + 1`` trials α = 2⁻ʲ are evaluated in
one batch and the loop's exit is found on the device — the first j whose
trial does not exceed the Armijo level (a NaN trial exits too), else the
last — so the round needs no host sync and selects the loop's α.

The active-set heuristic down-weights coordinates at zero with
|grad| < λ − ε in the draw (they cannot move), which "speeds up
optimization, though it can limit parallelism by shrinking d".  Those draws
depend on the iterate, so they come from a ``torch.Generator`` (Gumbel-max
over the logits, as ``jax.random.categorical`` draws); with
``active_set=False`` the draws are uniform with replacement, from the
generator or an explicit (rounds, P) ``idx`` stream.  Dense designs only.
"""
from __future__ import annotations

import torch

from repro_torch.core import objectives as obj
from repro_torch.core.objectives import Problem
from repro_torch.core.shotgun import (ROUNDS_RANGE, Result, _start,
                                      _trace_result, add_draws,
                                      coord_stream)

ARMIJO_SIGMA = 0.01
MAX_BACKTRACK = 12
SHRINK_EVERY = 10


def _newton_quantities(A_p, z, y, loss):
    """Per-coordinate gradient and curvature at the margin z.

    Logistic: w_i = p_i (1 − p_i), h_j = A_jᵀ (w ∘ A_j).
    Lasso:    h_j = ‖A_j‖² (1 under column normalization).
    Both floored at 1e-8."""
    r = obj.residual_like(z, y, loss)
    g = obj.cols_rmatvec(A_p, r)
    A_p = A_p.float()
    if loss == obj.LOGISTIC:
        p = torch.sigmoid(z)
        w = p * (1.0 - p)
        h = torch.sum(A_p * w[:, None] * A_p, dim=0)
    else:
        h = torch.sum(A_p * A_p, dim=0)
    return g, torch.clamp_min(h, 1e-8)


def armijo_step(f0, decrease, f_t):
    """The step of the reference's backtracking loop from all its trials:
    ``f_t`` (MAX_BACKTRACK + 1,) holds F at α = 2⁻ʲ.  The loop halves
    while F exceeds f0 + σ·α·decrease and stops at the first trial that
    does not (a NaN stops it too) or at the last; the step is taken only
    if that trial meets the level.  Returns (α, F after the step), α = 0
    and F = f0 when the step is refused."""
    alphas = 0.5 ** torch.arange(f_t.shape[0], dtype=torch.float32,
                                 device=f_t.device)
    level = f0 + ARMIJO_SIGMA * alphas * decrease
    stop = ~(f_t > level)
    stop[-1] = True
    j = torch.argmax(stop.to(torch.int32))
    accept = f_t[j] <= level[j]
    return (torch.where(accept, alphas[j], 0.0),
            torch.where(accept, f_t[j], f0))


def _categorical(generator, logits, P: int) -> torch.Tensor:
    """(P,) draws from softmax(logits) by Gumbel-max on ``generator``."""
    u = torch.rand((P, logits.shape[0]), generator=generator,
                   device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits + gumbel, dim=1)


def shotgun_cdn_solve(prob: Problem, generator: torch.Generator | None = None,
                      *, P: int, rounds: int, idx=None, x0=None,
                      active_set: bool = True) -> Result:
    """Shotgun-CDN: P Newton coordinate updates a round, one shared
    backtracked step.  ``active_set=True`` draws from ``generator`` with
    the shrinking logits refreshed every ``SHRINK_EVERY`` rounds;
    ``active_set=False`` takes ``idx`` (rounds, P) or draws uniformly from
    ``generator``."""
    A, y, lam = obj.require_dense(prob.A, "CDN"), prob.y, prob.lam
    d = A.shape[1]
    dev = A.device
    if active_set:
        if idx is not None:
            raise ValueError("the active set draws from the iterate: pass "
                             "a generator, or idx with active_set=False")
        if generator is None:
            raise ValueError("pass a torch.Generator for the active-set "
                             "draws")
        stream = None
    else:
        stream = coord_stream(idx, generator, rounds, P, d, dev)
    x, z = _start(A, x0, d)
    logits = torch.zeros(d, dtype=torch.float32, device=dev)
    alphas = 0.5 ** torch.arange(MAX_BACKTRACK + 1, dtype=torch.float32,
                                 device=dev)
    fs, nnzs = [], []
    with torch.profiler.record_function(ROUNDS_RANGE):
        for t in range(rounds):
            ii = (_categorical(generator, logits, P) if stream is None
                  else stream[t])
            Ap = A[:, ii]
            g, h = _newton_quantities(Ap, z, y, prob.loss)
            # Newton direction with L1: d_j = S(x_j − g_j/h_j, λ/h_j) − x_j
            x_idx = x[ii]
            delta = obj.soft_threshold(x_idx - g / h, lam / h) - x_idx
            dz = obj.matvec(Ap, delta)
            f0 = obj.objective_from_margin(z, x, prob)
            # Armijo decrease: g·d + λ(|x + d|₁ − |x|₁) over the draws
            decrease = torch.dot(g, delta) + lam * (
                torch.sum(torch.abs(x_idx + delta))
                - torch.sum(torch.abs(x_idx)))
            # every trial of the backtracking loop at once: (J, n), (J, d)
            step = add_draws(torch.zeros_like(x), ii, delta)
            zs = z[None, :] + alphas[:, None] * dz[None, :]
            if prob.loss == obj.LASSO:
                e = zs - y[None, :]
                loss_t = 0.5 * torch.sum(e * e, dim=1)
            else:
                m = -y[None, :] * zs
                loss_t = torch.sum(torch.logaddexp(torch.zeros_like(m), m),
                                   dim=1)
            f_t = loss_t + lam * torch.sum(
                torch.abs(x[None, :] + alphas[:, None] * step[None, :]),
                dim=1)
            alpha, f = armijo_step(f0, decrease, f_t)
            x = add_draws(x, ii, alpha * delta)
            z = z + alpha * dz
            fs.append(f)
            if active_set and t % SHRINK_EVERY == 0:
                # refresh the shrinkage logits (one O(nd) pass a period)
                g_full = obj.rmatvec(A, obj.residual_like(z, y, prob.loss))
                stuck = (x == 0) & (torch.abs(g_full) < lam * (1.0 - 1e-3))
                logits = torch.where(stuck, -10.0, 0.0)
            nnzs.append(torch.sum(x != 0))
    return _trace_result(x, z, fs, nnzs)


def shooting_cdn_solve(prob: Problem,
                       generator: torch.Generator | None = None, *,
                       rounds: int, x0=None) -> Result:
    """Shooting-CDN: Shotgun-CDN with P = 1 and the active set."""
    return shotgun_cdn_solve(prob, generator, P=1, rounds=rounds, x0=x0)
