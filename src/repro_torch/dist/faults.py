"""Fault injection on the Δz merge (port of ``repro.dist.faults``,
DESIGN §9.3).

  * ``FaultPlan``   — per-attempt probabilities of one rank's Δz being
    dropped (zeroed), corrupted (large additive garbage, or NaN with
    ``corrupt_nan``) or duplicated (counted twice), and the retry budget.
  * ``faulty_psum`` — an all-reduce with a reliable scalar checksum: the
    true global sum of the Δz entries travels as one scalar all-reduce
    (ack-sized, by assumption never faulted); each vector merge attempt is
    checked against it, and a mismatch triggers a re-merge, up to
    ``max_retries`` (every attempt runs, so the host never waits on a
    check).  Retries scale the probabilities by ``retry_decay**attempt``.
    If no attempt passes, the last one is NaN-sanitized and health is
    raised — the §9 sentinel then rolls the solve back at the next trace
    point.

The fault coins of attempt r of merge m on rank ``me`` come from a
``torch.Generator`` seeded with ``stream_seed(seed, m, r, me)``, where the
driver salts ``seed`` off the solve's own (``_FAULT_SALT``): the solve's
block draws are bit-identical with and without faults.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.dist import collectives

_MASK64 = (1 << 64) - 1


def stream_seed(*parts: int) -> int:
    """A 63-bit seed that depends only on ``parts`` (a splitmix64-style
    mix), for generators of independent named streams."""
    h = 0x9E3779B97F4A7C15
    for p in parts:
        h = ((h ^ (int(p) & _MASK64)) * 0xBF58476D1CE4E5B9) & _MASK64
        h ^= h >> 31
        h = (h * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 29
    return h >> 1


class FaultPlan(NamedTuple):
    """Fault-injection configuration; probabilities per rank per merge
    attempt."""
    drop_prob: float = 0.0      # rank's Δz zeroed (lost message)
    corrupt_prob: float = 0.0   # rank's Δz gets large additive garbage
    dup_prob: float = 0.0       # rank's Δz counted twice
    corrupt_nan: bool = False   # corrupt with NaN instead of finite garbage
    max_retries: int = 2        # re-merges after the first failed attempt
    retry_decay: float = 0.25   # fault-prob multiplier per retry attempt


def inject_dz(dz: torch.Tensor, generator: torch.Generator, plan: FaultPlan,
              scale: float = 1.0) -> torch.Tensor:
    """One rank's faulted view of its Δz for one attempt (coins drawn on
    the device; nothing read back)."""
    u = torch.rand(3, generator=generator, device=dz.device)
    drop = u[0] < plan.drop_prob * scale
    corrupt = u[1] < plan.corrupt_prob * scale
    dup = u[2] < plan.dup_prob * scale
    out = torch.where(dup, 2.0, 1.0) * dz
    out = torch.where(drop, torch.zeros_like(dz), out)
    if plan.corrupt_nan:
        garbage = torch.full_like(dz, torch.nan)
    else:
        # nonzero-mean offset so corruption cannot slip past the sum check
        noise = torch.randn(dz.shape, generator=generator, device=dz.device)
        garbage = dz + 1e3 * (1.0 + noise)
    return torch.where(corrupt, garbage, out)


def faulty_psum(dz: torch.Tensor, seed: int, me: int, plan: FaultPlan,
                group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """All-reduce of ``dz`` over ``group`` through the fault plan, with the
    checksummed bounded re-merge.  ``seed`` names the merge (the driver
    passes ``stream_seed(fault_seed, merge)``); ``me`` decorrelates the
    ranks.  Returns ``(dz_global, health)``, health 1.0 iff no attempt
    passed the checksum."""
    s_true = collectives.all_reduce(torch.sum(dz).reshape(1), group)[0]
    tol = 1e-3 * (1.0 + torch.abs(s_true))
    ok_any = torch.zeros((), dtype=torch.bool, device=dz.device)
    out = torch.zeros_like(dz)
    g_r = out
    for r in range(plan.max_retries + 1):
        gen = torch.Generator(device=dz.device)
        gen.manual_seed(stream_seed(seed, r, me))
        dz_r = inject_dz(dz, gen, plan, scale=plan.retry_decay ** r)
        g_r = collectives.all_reduce(dz_r, group)
        # a NaN sum compares False, so NaN corruption always fails
        ok_r = torch.abs(torch.sum(g_r) - s_true) <= tol
        out = torch.where(ok_r & ~ok_any, g_r, out)
        ok_any = ok_any | ok_r
    out = torch.where(ok_any, out, torch.nan_to_num(g_r, nan=0.0, posinf=0.0,
                                                    neginf=0.0))
    return out, (~ok_any).float()
