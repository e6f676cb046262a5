"""SGD and Parallel SGD baselines (Sec. 4.2.2; port of
``repro.core.baselines.sgd``).

SGD: per step, sample one example, take a gradient step on the data term and
apply lazy L1 shrinkage (truncated gradient, Langford et al. 2009a):
    x <- S(x − eta * a_i L'(a_iᵀx, y_i), eta * lam_eff)
with lam_eff = lam / n (the per-sample share of the regularizer).  Constant
learning rate, per the paper's finding that constant rates beat 1/sqrt(T)
decay; the benchmark harness replicates their grid of 14 exponential rates.

Parallel SGD (Zinkevich et al. 2010): K independent SGD instances on disjoint
shards of the data; final x is the average.  (The paper notes this method's
analysis does not cover L1; it behaved like plain SGD in their Fig. 4.)
Here the K instances are one (K, d) state that advances K rows a step.

Draws: JAX's threefry stream cannot be reproduced in torch, so each solver
takes an explicit ``idx`` stream — the parity tests feed it the
reference's own draws — or draws it on the problem's device from a
``torch.Generator``, all of it before the first step, so no step reads a
device value on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import objectives as obj
from repro_torch.core.baselines.common import (ITERS_RANGE, BaselineResult,
                                               zeros_x)
from repro_torch.core.objectives import Problem


def _loss_deriv(z, y, loss):
    if loss == obj.LASSO:
        return z - y
    return -y * torch.sigmoid(-y * z)


def draw_stream(idx, generator, shape: tuple[int, ...], high: int,
                device) -> torch.Tensor:
    """int64 row draws of ``shape`` in [0, high) on ``device``: the caller's
    ``idx`` (array or tensor), checked once before the steps, or drawn from
    ``generator``."""
    if idx is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or an explicit idx")
        return torch.randint(0, high, shape, generator=generator,
                             device=generator.device).to(device)
    idx = (idx if isinstance(idx, torch.Tensor)
           else torch.tensor(np.asarray(idx))).to(torch.int64)
    if tuple(idx.shape) != shape:
        raise ValueError(f"idx shape {tuple(idx.shape)} != {shape}")
    if bool(((idx < 0) | (idx >= high)).any()):
        raise ValueError(f"idx entries must lie in [0, {high})")
    return idx.to(device)


def chunk_rows(A, y, ii) -> tuple[torch.Tensor, torch.Tensor]:
    """The drawn rows of A (in f32) and of y for a chunk of steps, gathered
    on the device before the chunk starts."""
    return A.index_select(0, ii).float(), y.index_select(0, ii)


def sgd_solve(prob: Problem, generator: torch.Generator | None = None,
              eta: float = 0.1, steps: int = 1000, record_every: int = 100,
              *, idx=None) -> BaselineResult:
    """``steps // record_every`` chunks of ``record_every`` SGD steps from
    x = 0 (the remainder is dropped, as the reference drops it); the trace
    holds F after each chunk.  ``idx`` (chunks·record_every,) fixes the
    rows drawn; otherwise they come from ``generator``."""
    A, y, lam = obj.require_dense(prob.A, "SGD"), prob.y, prob.lam
    n = A.shape[0]
    lam_eff = lam / n
    num_chunks = steps // record_every
    rows = draw_stream(idx, generator, (num_chunks * record_every,), n,
                       A.device)
    x = zeros_x(prob)
    shrink = eta * lam_eff
    fs = []
    with torch.profiler.record_function(ITERS_RANGE):
        for c in range(num_chunks):
            a_c, y_c = chunk_rows(A, y, rows[c * record_every:
                                             (c + 1) * record_every])
            for a, y_i in zip(a_c, y_c):
                g = a * _loss_deriv(torch.dot(a, x), y_i, prob.loss)
                x = obj.soft_threshold(x - eta * g, shrink)
            fs.append(obj.objective(x, prob))
    return BaselineResult(x=x, objective=torch.stack(fs))


def sgd_rate_search(prob: Problem, generator: torch.Generator | None = None,
                    steps: int = 1000, rates=None, *, idx=None,
                    record_every: int = 100
                    ) -> tuple[BaselineResult, float]:
    """The paper's protocol: try 14 exponential rates, keep the best
    training objective.  Every rate runs on the same draws (``idx``, or
    one stream drawn from ``generator``); the last F of each is read back
    between solves."""
    if rates is None:
        rates = np.geomspace(1e-4, 1.0, 14)
    num = (steps // record_every) * record_every
    idx = draw_stream(idx, generator, (num,), prob.n, prob.A.device)
    best, best_f, best_rate = None, None, None
    for r in rates:
        res = sgd_solve(prob, None, float(r), steps, record_every, idx=idx)
        f = float(res.objective[-1])
        if np.isfinite(f) and (best is None or f < best_f):
            best, best_f, best_rate = res, f, float(r)
    return best, best_rate


def parallel_sgd_solve(prob: Problem, generator: torch.Generator | None = None,
                       eta: float = 0.1, steps: int = 1000, K: int = 8,
                       record_every: int = 100, *,
                       idx=None) -> BaselineResult:
    """Zinkevich averaging over K shards of n // K rows: K SGD instances as
    one (K, d) state, each step advancing all K.  ``idx`` (K, steps) holds
    each instance's draws in [0, shard) (the shard's offset k·shard is
    added here); otherwise they come from ``generator``.  The trace holds
    F of the average only; the rows are gathered ``record_every`` steps at
    a time (the reference takes and ignores it)."""
    A, y, lam = obj.require_dense(prob.A, "parallel SGD"), prob.y, prob.lam
    n = A.shape[0]
    shard = n // K
    lam_eff = lam / shard
    dev = A.device
    draws = draw_stream(idx, generator, (K, steps), shard, dev)
    rows = (draws + shard * torch.arange(K, device=dev)[:, None]).t()
    X = zeros_x(prob).expand(K, -1)
    shrink = eta * lam_eff
    with torch.profiler.record_function(ITERS_RANGE):
        for c in range(0, steps, record_every):
            ii = rows[c:c + record_every]                       # (s, K)
            a_c, y_c = chunk_rows(A, y, ii.reshape(-1))
            for a, y_k in zip(a_c.view(len(ii), K, -1), y_c.view(len(ii), K)):
                z = torch.sum(a * X, dim=1)                     # (K,)
                g = a * _loss_deriv(z, y_k, prob.loss)[:, None]
                X = obj.soft_threshold(X - eta * g, shrink)
    x = torch.mean(X, dim=0)
    return BaselineResult(x=x, objective=obj.objective(x, prob)[None])
