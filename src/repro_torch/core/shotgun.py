"""Shotgun (Alg. 2): parallel stochastic coordinate descent for L1 losses
(port of ``repro.core.shotgun``).

Three solvers:

``shooting_solve``     Alg. 1 — sequential SCD (P = 1 special case).
``shotgun_solve``      Alg. 2 — practical signed form.  Each round draws P
                       coordinates (with replacement: the multiset P_t of
                       the paper) and applies the Shooting update to all of
                       them from the same iterate; the collective update is
                       the sum of the per-draw deltas, exactly Δx.
``shotgun_dup_solve``  Alg. 2 verbatim on the duplicated-feature positive
                       orthant form (Eq. 4), δx̂_j = max(−x̂_j, −(∇F)_j / β).

All maintain z = A x (Sec. 4.1.1): a round costs O(n·P) dense, O(tile·P)
on a BlockedCSC, never O(n·d).

Draws: JAX's threefry stream cannot be reproduced in torch, so every solver
takes an explicit ``idx`` stream, (rounds, P) coordinate indices — the
parity tests feed it the JAX solvers' own draws — or draws it on the
problem's device from a ``torch.Generator``.  A round runs on the device
with no host sync: F and nnz of each round stay in device tensors until the
solve returns, as the scan's outputs do.  Duplicate draws and the sparse
margin update add in an order fixed by the data (``add_draws``,
``objectives.index_add_fixed``), so a repeat gives the same bits.
The legacy ``(P, rounds)`` kwargs of ``shotgun_solve`` are not ported:
``spec=`` is required.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import health
from repro_torch.core import objectives as obj
from repro_torch.core.health import GuardConfig
from repro_torch.core.objectives import DupProblem, Problem
from repro_torch.core.spec import SolverSpec

# The profiler range around a scalar solve's rounds (``torch.profiler``
# shows it by this name): the window in which no host sync may occur.
ROUNDS_RANGE = "repro_torch.scalar_rounds"


class Trace(NamedTuple):
    objective: torch.Tensor   # (rounds,) F(x^(t)) after round t
    nnz: torch.Tensor         # (rounds,) number of non-zeros


class Result(NamedTuple):
    x: torch.Tensor
    z: torch.Tensor           # final margin A x
    trace: Trace
    # health.STATUS_OK / STATUS_RECOVERED / STATUS_DIVERGED (0-dim int32).
    status: torch.Tensor | None = None


def draw_coords(generator: torch.Generator, rounds: int, P: int, d: int,
                replace: bool = True) -> torch.Tensor:
    """(rounds, P) int64 coordinates in [0, d), drawn on the generator's
    device: with replacement (the multiset P_t), or P distinct a round."""
    dev = generator.device
    if replace:
        return torch.randint(0, d, (rounds, P), generator=generator,
                             device=dev)
    if P > d:
        raise ValueError(f"P={P} distinct draws > d={d}")
    return torch.stack([torch.randperm(d, generator=generator,
                                       device=dev)[:P]
                        for _ in range(rounds)])


def coord_stream(idx, generator, rounds: int, P: int, d: int, device,
                 replace: bool = True) -> torch.Tensor:
    """(rounds, P) int64 coordinate indices on ``device``: the caller's
    ``idx`` (array or tensor), checked once before the rounds, or drawn
    from ``generator``."""
    if idx is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or an explicit idx")
        return draw_coords(generator, rounds, P, d, replace).to(device)
    idx = (idx if isinstance(idx, torch.Tensor)
           else torch.tensor(np.asarray(idx))).to(torch.int64)
    if tuple(idx.shape) != (rounds, P):
        raise ValueError(f"idx shape {tuple(idx.shape)} != (rounds, P) = "
                         f"{(rounds, P)}")
    if bool(((idx < 0) | (idx >= d)).any()):
        raise ValueError(f"idx entries must lie in [0, {d})")
    return idx.to(device)


def _start(A, x0, d: int):
    """(x0, z0 = A x0) in f32 on A's device; a cold start is exactly zero
    (what A·0 gives), with no product."""
    dev = A.device
    if x0 is None:
        return (torch.zeros(d, dtype=torch.float32, device=dev),
                torch.zeros(A.shape[0], dtype=torch.float32, device=dev))
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=dev)
    return x0, obj.matvec(A, x0).float()


def add_draws(x, ii, delta, live=None) -> torch.Tensor:
    """x with δ_k added at ii[k] for every live draw k: Alg. 2's Δx.  All
    of a round's deltas come from one iterate, so duplicate draws of a
    coordinate carry the same δ, and their sum is δ times the number of
    live draws (``live``: 0/1 per draw, None for all).  The counts are
    integer sums, exact in any order; every duplicate writes the same
    value as long as a column's δ does not depend on where the column sits
    in the round's pack (the per-column reductions of cuBLAS's gemv and of
    ``torch.sum`` along a row do not), so a repeat gives the same bits."""
    w = (torch.ones_like(ii, dtype=torch.int32) if live is None
         else live.to(torch.int32))
    cnt = torch.zeros(x.shape[0], dtype=torch.int32,
                      device=x.device).index_add_(0, ii, w)
    return x.index_put((ii,), x[ii] + cnt[ii].to(x.dtype) * delta)


def _trace_result(x, z, fs, nnzs, backoffs=None) -> Result:
    fs = torch.stack(fs)
    return Result(x=x, z=z, trace=Trace(
        objective=fs, nnz=torch.stack(nnzs).to(torch.int32)),
        status=health.status_from_trace(fs, backoffs))


def shotgun_solve(prob: Problem, generator: torch.Generator | None = None,
                  *, spec: SolverSpec | None = None, idx=None, x0=None,
                  replace: bool = True) -> Result:
    """Run ``spec.rounds`` synchronous Shotgun rounds of ``spec.P``
    parallel coordinate updates each.

    ``prob.A`` may be dense or a ``BlockedCSC``: the round reads A only
    through ``gather_cols`` / ``cols_rmatvec`` / ``cols_matvec_add``.
    ``idx`` (rounds, P) fixes the draws; otherwise they come from
    ``generator`` (on the problem's device), with or without replacement.
    ``x0`` warm-starts the iterate (z0 = A x0).  x is kept in f32 also for
    a bf16 design.

    ``spec.guard`` enables the divergence sentinel + adaptive-P backoff
    (DESIGN §9): every round still draws P coordinates but only the first
    ``p_eff`` apply; a round that trips rolls back to the last-good (x, z)
    and ``p_eff`` halves (clamped to ``guard.p_min``).  Without a guard
    the trajectory is the plain one.
    """
    if spec is None:
        raise TypeError("shotgun_solve needs spec=SolverSpec(...); the "
                        "legacy (P, rounds) kwargs are not ported")
    spec.check_loss(prob.loss)
    return _shotgun_core(prob, generator, spec.P, spec.rounds, idx=idx,
                         x0=x0, replace=replace, guard=spec.guard)


def _shotgun_core(prob: Problem, generator, P: int, rounds: int, *,
                  idx=None, x0=None, replace: bool = True,
                  guard: GuardConfig | None = None) -> Result:
    A, y, lam, beta = prob.A, prob.y, prob.lam, prob.beta
    d = prob.d
    stream = coord_stream(idx, generator, rounds, P, d, A.device, replace)
    x, z = _start(A, x0, d)

    def update(x, z, ii, live):
        r = obj.residual_like(z, y, prob.loss)
        cols = obj.gather_cols(A, ii)        # (n, P) dense or nnz tiles
        g = obj.cols_rmatvec(cols, r)        # (P,) coordinate gradients
        delta = obj.shooting_delta(x[ii], g, lam, beta)
        # Δx sums the deltas of duplicate draws (Alg. 2's multiset); the
        # sentinel's backoff masks the draws past p_eff
        x = add_draws(x, ii, delta, live)
        if live is not None:
            delta = delta * live
        z = obj.cols_matvec_add(cols, delta, z)
        return x, z, obj.objective_from_margin(z, x, prob)

    fs, nnzs = [], []
    if guard is None:
        with torch.profiler.record_function(ROUNDS_RANGE):
            for ii in stream:
                x, z, f = update(x, z, ii, None)
                fs.append(f)
                nnzs.append(torch.sum(x != 0))
        return _trace_result(x, z, fs, nnzs)

    p_floor = max(1, min(guard.p_min, P))
    gs = health.init_guard_state(x, z, obj.objective_from_margin(z, x, prob),
                                 P)
    with torch.profiler.record_function(ROUNDS_RANGE):
        for ii in stream:
            x_new, z_new, f_new = update(x, z, ii,
                                         health.live_mask(P, gs.p_eff))
            x, z, f, gs, _ = health.apply_sentinel(
                gs, x_new, z_new, f_new, factor=guard.factor,
                p_floor=p_floor)
            fs.append(f)
            nnzs.append(torch.sum(x != 0))
    return _trace_result(x, z, fs, nnzs, gs.backoffs)


def shooting_solve(prob: Problem, generator: torch.Generator | None = None,
                   *, rounds: int, idx=None, x0=None) -> Result:
    """Alg. 1: sequential SCD = Shotgun with P = 1 (``idx`` (rounds, 1))."""
    return _shotgun_core(prob, generator, 1, rounds, idx=idx, x0=x0)


# ---------------------------------------------------------------------------
# Theory-faithful duplicated-feature form (Eq. 4 / Alg. 2 verbatim)
# ---------------------------------------------------------------------------

def shotgun_dup_solve(dp: DupProblem,
                      generator: torch.Generator | None = None, *, P: int,
                      rounds: int, idx=None, xhat0=None) -> Result:
    """Alg. 2 on min_{x̂ >= 0} Σ L(â_iᵀ x̂) + λ Σ x̂_j with â = [a; −a].

    ∇F(x̂)_j = â_jᵀ r + λ  and  δx̂_j = max(−x̂_j, −(∇F)_j / β).  ``idx``
    (rounds, P) draws lie in [0, 2d), with replacement."""
    A, y, lam, beta = dp.A, dp.y, dp.lam, dp.beta
    n, d = A.shape
    d2 = 2 * d
    dev = A.device
    stream = coord_stream(idx, generator, rounds, P, d2, dev)
    xhat = (torch.zeros(d2, dtype=torch.float32, device=dev) if xhat0 is None
            else torch.as_tensor(xhat0, dtype=torch.float32, device=dev))
    z = obj.matvec(A, xhat[:d] - xhat[d:]).float()
    ones = torch.ones(P, dtype=torch.int32, device=dev)
    fs, nnzs = [], []
    with torch.profiler.record_function(ROUNDS_RANGE):
        for ii in stream:
            r = obj.residual_like(z, y, dp.loss)
            sign = torch.where(ii < d, 1.0, -1.0)            # column of [A, −A]
            Ap = A[:, ii % d] * sign[None, :]                # (n, P)
            g = obj.cols_rmatvec(Ap, r) + lam                # (∇F)_j
            delta = torch.maximum(-xhat[ii], -g / beta)      # Eq. 5
            counts = torch.zeros(d2, dtype=torch.int32,
                                 device=dev).index_add_(0, ii, ones)[ii]
            xhat_raw = xhat.index_put((ii,), xhat[ii] + counts * delta)
            # Same-coordinate draws may overshoot below 0; the paper's
            # write-conflict note (end of Sec. 3.1) permits the clip.  z
            # takes the deltas plus the (clipped − unclipped) corrections,
            # each duplicate draw's share divided by the multiplicity.
            xhat = torch.clamp_min(xhat_raw, 0.0)
            corr = (xhat - xhat_raw)[ii] / counts
            z = obj.cols_matvec_add(Ap, delta + corr, z)
            fs.append(obj.data_loss_from_margin(z, y, dp.loss)
                      + lam * torch.sum(xhat))
            nnzs.append(torch.sum(obj.dup_to_signed(xhat) != 0))
    return _trace_result(xhat, z, fs, nnzs)


# ---------------------------------------------------------------------------
# Solver selection
# ---------------------------------------------------------------------------

SOLVER_NAMES = ("shooting", "shotgun", "shotgun_dup", "shotgun_cdn",
                "shooting_cdn", "block", "block_fused", "sharded",
                "shotgun_logreg_fused", "sparse_logreg_fused")


def _loss_bound(fn, loss: str, family, require_sparse: bool = False):
    """Wrap a solver so it refuses problems built for another loss (naming
    both) — and, for the sparse-only entries, dense designs."""
    @functools.wraps(fn)
    def solve(prob, *args, **kwargs):
        if prob.loss != loss:
            raise ValueError(
                f"solver {family!r} is bound to loss {loss!r} but the "
                f"problem carries loss {prob.loss!r}")
        if require_sparse:
            from repro_torch.data.sparse import BlockedCSC
            if not isinstance(prob.A, BlockedCSC):
                raise ValueError(
                    f"solver {family!r} needs a BlockedCSC design; got "
                    f"{type(prob.A).__name__}")
        return fn(prob, *args, **kwargs)
    return solve


def get_solver(name):
    """The solve callable for ``name`` (see ``SOLVER_NAMES``):

      shooting / shotgun / shotgun_dup   this module (Alg. 1 / Alg. 2)
      shotgun_cdn / shooting_cdn         CDN inner-Newton variants
      block                              two-kernel Block-Shotgun
      block_fused                        fused multi-round kernel
      sharded                            torch.distributed round-engine
                                         driver (``engine=``)
      shotgun_logreg_fused               fused kernel bound to logistic loss
      sparse_logreg_fused                same, BlockedCSC designs only

    ``name`` may also be a ``(family, loss)`` pair — e.g.
    ``("block_fused", "logistic")`` — which binds any family to a loss
    with an admission check (a problem of another loss raises
    ``ValueError`` naming both); the two ``*_logreg_fused`` strings are
    frozen aliases of ``("block_fused", "logistic")``.

    The kernel and sharded solvers are imported at call time:
    ``kernels.ops`` and ``core.sharded`` import this module.
    """
    if isinstance(name, tuple):
        family, loss = name
        if loss not in obj.BETA:
            raise ValueError(
                f"unknown loss {loss!r}; choose from {tuple(obj.BETA)}")
        return _loss_bound(get_solver(family), loss, family)
    if name == "shotgun_logreg_fused":
        from repro_torch.kernels import ops
        return _loss_bound(ops.fused_block_shotgun_solve, obj.LOGISTIC, name)
    if name == "sparse_logreg_fused":
        from repro_torch.kernels import ops
        return _loss_bound(ops.fused_block_shotgun_solve, obj.LOGISTIC, name,
                           require_sparse=True)
    if name == "shooting":
        return shooting_solve
    if name == "shotgun":
        return shotgun_solve
    if name == "shotgun_dup":
        return shotgun_dup_solve
    if name in ("shotgun_cdn", "shooting_cdn"):
        from repro_torch.core import cdn
        return {"shotgun_cdn": cdn.shotgun_cdn_solve,
                "shooting_cdn": cdn.shooting_cdn_solve}[name]
    if name == "block":
        from repro_torch.kernels import ops
        return ops.block_shotgun_solve
    if name == "block_fused":
        from repro_torch.kernels import ops
        return ops.fused_block_shotgun_solve
    if name == "sharded":
        from repro_torch.core import sharded
        return sharded.shotgun_sharded_solve
    raise ValueError(f"unknown solver {name!r}; choose from {SOLVER_NAMES}")


# ---------------------------------------------------------------------------
# Convergence utilities
# ---------------------------------------------------------------------------

def rounds_to_tolerance(trace_objective, f_star, rel_tol=0.005):
    """First round index with F within rel_tol of F* (the paper's 0.5%
    criterion); len(trace) if never reached.  Non-finite entries never
    count as hits: a −inf/NaN objective is divergence, not convergence."""
    t = torch.as_tensor(trace_objective)
    target = f_star + rel_tol * abs(float(f_star))
    hit = (t <= target) & torch.isfinite(t)
    return torch.where(torch.any(hit), torch.argmax(hit.to(torch.int32)),
                       t.shape[0])


def diverged(trace_objective) -> torch.Tensor:
    """True when the trace shows divergence anywhere: any non-finite entry,
    or a final objective blown 1000x past the start (a NaN margin can
    round-trip to a finite-looking objective later, so the last entry
    alone under-reports)."""
    t = torch.as_tensor(trace_objective)
    return (torch.any(~torch.isfinite(t))
            | (t[-1] > 1e3 * torch.abs(t[0]) + 1e3))
