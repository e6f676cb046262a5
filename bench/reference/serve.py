"""The plain reference of a served λ-grid job: the slots, the warm-start
cache and the launch-boundary stop, replayed request by request over
``shotgun.rounds``.

The service's rules (``src/repro_torch/launch/solver_serve.py`` and
``launch/slots.py``, as documented there): S slots refilled in slot order
from a FIFO queue before each launch; a launch runs R rounds on every live
slot; a request is admitted with x0 from the cache — the solution of the
same (design, λ) if one has finished ("exact"), else of the nearest λ of
the same design ("near"), else zero ("miss") — and the margin z0 = A x0;
after a launch a slot whose F passed 10·|F_prev| + 10 or stopped being
finite in any round goes back to its admission state with half its live
blocks (it is given up as diverged at one block, or when its launches run
out); otherwise it stops once |F_prev − F_end| ≤ tol·max(1, |F_end|) or
its launches run out, and its x enters the cache.

Which finished solves a request can see depends on when it is admitted,
and that depends on how many launches each earlier request took.  The
replay takes those counts from the served job (``launches``, ``status``)
to place every request in time, and checks each request's own stop
against its own trace: ``stops`` counts the boundaries at which the
reference's verdict differs from the service's by more than the
rounding ``band`` allows.  Everything else — the cache's verdicts, the
warm starts, the margins, the iterates — is the reference's own.
"""
from __future__ import annotations

import collections
import math
from typing import NamedTuple

import torch

from bench.reference.shotgun import Design, rounds

GUARD_FACTOR = 10.0


class Served(NamedTuple):
    """What the service reported for one request."""
    pid: int
    lam_idx: int
    sched: torch.Tensor     # (max_launches·R, K) int32
    launches: int
    rounds_used: int
    status: str             # "ok" | "diverged"


class Replayed(NamedTuple):
    x: torch.Tensor         # (d,)
    f_final: float
    status: str
    warm: str
    launches: int
    rounds_used: int
    stops: int              # stop verdicts that differ beyond the band


def schedule(steps: list[int], slots: int):
    """(admit step, slot, final step) of each request of a FIFO queue over
    ``slots`` slots, request q holding its slot for ``steps[q]`` launches."""
    n = len(steps)
    admit, slot_of, final = [0] * n, [0] * n, [0] * n
    occupant: list[int | None] = [None] * slots
    left: dict[int, int] = {}
    queue = collections.deque(range(n))
    t = 0
    while True:
        for s in range(slots):
            o = occupant[s]
            if o is None or left[o] == 0:
                occupant[s] = None
                if queue:
                    q = queue.popleft()
                    occupant[s], left[q] = q, steps[q]
                    admit[q], slot_of[q] = t, s
        live = [o for o in occupant if o is not None and left[o] > 0]
        if not live:
            return admit, slot_of, final
        for o in live:
            left[o] -= 1
            if left[o] == 0:
                final[o] = t
        t += 1


def steps_of(req: Served, max_launches: int) -> int:
    """Launch steps a request held its slot: one a launch, and one more
    for a launch that tripped at one live block (given up uncounted)."""
    extra = req.status == "diverged" and req.launches < max_launches
    return req.launches + int(extra)


def replay(designs: list[Design], lams: list[list[float]],
           job: list[Served], *, slots: int, K: int, R: int,
           max_launches: int, tol: float, band: float) -> list[Replayed]:
    """Replay a served job; ``lams[pid][j]`` is the reference's λ of grid
    entry j on design pid, ``band`` the relative rounding of an objective
    within which a stop verdict counts as a tie."""
    admit, slot_of, final = schedule(
        [steps_of(r, max_launches) for r in job], slots)
    done: list[Replayed] = []
    for q, req in enumerate(job):
        D = designs[req.pid]
        lam = lams[req.pid][req.lam_idx]
        seen = {}
        for p in range(q):
            if (job[p].pid == req.pid and final[p] < admit[q]
                    and done[p].status == "ok"):
                key = (final[p], slot_of[p])
                j = job[p].lam_idx
                if j not in seen or seen[j][0] < key:
                    seen[j] = (key, done[p].x)
        x0 = torch.zeros(D.d_pad, dtype=D.dt, device=D.y.device)
        if req.lam_idx in seen:
            warm = "exact"
            x0[: D.d] = seen[req.lam_idx][1]
        elif seen:
            warm = "near"
            near = min(seen, key=lambda j: abs(lams[req.pid][j] - lam))
            x0[: D.d] = seen[near][1]
        else:
            warm = "miss"
        done.append(_solve(D, lam, x0, req, warm, K=K, R=R,
                           max_launches=max_launches, tol=tol, band=band))
    return done


def _solve(D: Design, lam: float, x0, req: Served, warm: str, *, K, R,
           max_launches, tol, band) -> Replayed:
    z0 = D.matvec(x0)
    f_prev = float(D.objective(z0, x0, lam))
    x, z = x0, z0
    k_eff, launches, used, stops = K, 0, 0, 0
    follow = req.status == "ok"
    status = "diverged"
    while launches < max_launches:
        idx = req.sched[launches * R:(launches + 1) * R].to(x.device)
        xn, zn, f = rounds(D, x, z, idx, lam, newton=False, k_eff=k_eff)
        thr = GUARD_FACTOR * abs(f_prev) + GUARD_FACTOR
        if not bool(torch.all(torch.isfinite(f))) or float(f.max()) > thr:
            if k_eff <= 1:
                break
            k_eff //= 2
            x, z = x0, z0
            launches += 1
            continue
        x, z = xn, zn
        launches += 1
        used += R
        f_end = float(f[-1])
        scale = max(1.0, abs(f_end))
        change = abs(f_prev - f_end) / scale
        stop = (math.isfinite(f_end) and change <= tol) or \
            launches >= max_launches
        if follow and stop != (used == req.rounds_used):
            tie = abs(change - tol) <= band * max(abs(f_prev),
                                                  abs(f_end)) / scale
            stops += int(not tie)
            stop = used == req.rounds_used
        f_prev = f_end
        if stop:
            status = "ok"
            break
    return Replayed(x=x[: D.d], f_final=f_prev, status=status, warm=warm,
                    launches=launches, rounds_used=used, stops=stops)
