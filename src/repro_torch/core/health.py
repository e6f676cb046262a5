"""Solver health: divergence sentinel, last-good rollback, adaptive-P backoff.

Port of ``repro.core.health`` (DESIGN §9).  Theorem 3.2 is two-sided:
Shotgun converges while P < P* ~ d/rho(AᵀA) and diverges beyond it.  The
sentinel detects the divergence, rolls back to the last-good (x, z, F)
snapshot and halves the effective parallelism.  Everything stays on the
device as ``torch.where``: no value is read back to the host, so a guarded
solve runs without a host sync per round or launch.

Backoff never changes shapes: solvers keep drawing their full K blocks and
mask updates past ``p_eff``; at full width the mask multiplies by exactly
1.0, so guarded and unguarded trajectories agree bit for bit until a trip.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

STATUS_OK = 0          # converging, no sentinel trips
STATUS_RECOVERED = 1   # sentinel tripped >= once, final trace healthy
STATUS_DIVERGED = 2    # final trace non-finite or blown past the start

STATUS_NAMES = {STATUS_OK: "ok", STATUS_RECOVERED: "recovered",
                STATUS_DIVERGED: "diverged"}


class GuardConfig(NamedTuple):
    """Sentinel configuration.

    factor   trip when F > factor·|F_good| + factor (the additive term
             guards F_good ≈ 0) or F goes NaN/Inf.
    p_min    backoff floor for the effective parallelism, in the solver's
             own units (128-blocks for the block solvers).
    """
    factor: float = 10.0
    p_min: int = 1


class GuardState(NamedTuple):
    """Sentinel state carried across rounds: last-good snapshot + live P."""
    x_good: torch.Tensor
    z_good: torch.Tensor
    f_good: torch.Tensor      # 0-dim f32
    p_eff: torch.Tensor       # 0-dim int32, current effective parallelism
    backoffs: torch.Tensor    # 0-dim int32, number of sentinel trips


def init_guard_state(x0, z0, f0, p_full: int) -> GuardState:
    dev = x0.device
    return GuardState(x_good=x0, z_good=z0,
                      f_good=torch.as_tensor(f0, dtype=torch.float32,
                                             device=dev),
                      p_eff=torch.tensor(p_full, dtype=torch.int32,
                                         device=dev),
                      backoffs=torch.zeros((), dtype=torch.int32,
                                           device=dev))


def guard_threshold(f_good, factor: float):
    """Objective level that trips the sentinel (the additive term guards
    the f_good ≈ 0 endgame, where a pure relative test would hair-trigger)."""
    return factor * torch.abs(f_good) + factor


def live_mask(width: int, p_eff, dtype=torch.float32, device=None):
    """(width,) mask activating the first ``p_eff`` of ``width`` candidate
    updates — exactly 1.0 everywhere when p_eff == width."""
    if isinstance(p_eff, torch.Tensor):
        device = p_eff.device
    return (torch.arange(width, device=device) < p_eff).to(dtype)


def apply_sentinel(gs: GuardState, x_new, z_new, f_new, *, factor: float,
                   p_floor: int, health=None):
    """One sentinel step after a round (or launch) produced (x, z, F).

    Trips when F is non-finite, F exceeds ``guard_threshold(f_good)``, or
    an in-kernel ``health`` flag is raised; on a trip the iterate rolls
    back to the last-good snapshot, ``p_eff`` halves (clamped to
    ``p_floor``), and the reported objective is ``f_good``.  On a
    non-tripped round the snapshot refreshes whenever F improves on it.

    Returns ``(x, z, f_report, new_state, tripped)``.
    """
    f_new = torch.as_tensor(f_new, dtype=torch.float32)
    bad = ~torch.isfinite(f_new) | (f_new > guard_threshold(gs.f_good, factor))
    if health is not None:
        bad = bad | (torch.as_tensor(health, dtype=torch.float32) > 0)
    x = torch.where(bad, gs.x_good, x_new)
    z = torch.where(bad, gs.z_good, z_new)
    f_report = torch.where(bad, gs.f_good, f_new)
    p_eff = torch.where(bad, torch.clamp_min(gs.p_eff // 2, p_floor),
                        gs.p_eff)
    improve = ~bad & (f_new <= gs.f_good)
    new_state = GuardState(
        x_good=torch.where(improve, x_new, gs.x_good),
        z_good=torch.where(improve, z_new, gs.z_good),
        f_good=torch.where(improve, f_new, gs.f_good),
        p_eff=p_eff.to(torch.int32),
        backoffs=gs.backoffs + bad.to(torch.int32))
    return x, z, f_report, new_state, bad


def nonfinite_flag(*tensors):
    """1.0 if any element of any tensor is NaN/Inf, else 0.0."""
    bad = torch.zeros((), dtype=torch.bool, device=tensors[0].device)
    for t in tensors:
        bad = bad | ~torch.all(torch.isfinite(t))
    return bad.to(torch.float32)


def status_from_trace(trace_objective, backoffs=None):
    """Map a finished objective trace (+ optional backoff count) to a
    ``Result.status`` code.  Scans the FULL trace: a NaN anywhere marks the
    run diverged even if later entries look finite."""
    t = torch.as_tensor(trace_objective)
    div = (torch.any(~torch.isfinite(t))
           | (t[-1] > 1e3 * torch.abs(t[0]) + 1e3))
    status = torch.where(div, STATUS_DIVERGED, STATUS_OK).to(torch.int32)
    if backoffs is not None:
        recovered = ~div & (torch.as_tensor(backoffs) > 0)
        status = torch.where(recovered, STATUS_RECOVERED, status)
    return status.to(torch.int32)


class SolverFailure(RuntimeError):
    """Simulated mid-solve process death (checkpoint/resume tests)."""
