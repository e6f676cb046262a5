"""Shotgun-as-a-service: continuous-batched solver serving (port of
``repro.launch.solver_serve``).

    PYTHONPATH=src python -m repro_torch.launch.solver_serve \
        --requests 12 --slots 4 --n 256 --d 512 --repeat-frac 0.5

(``--device cpu`` runs the kernels' plain versions on the host.)

A stream of ``SolveRequest``\\ s — (problem_id, λ, optional x0) — is served
through ``slots`` stacked problems advanced together by ONE batched launch
of the fused kernels per scheduler step (``core.batched.launch_rounds``),
R rounds at a time:

  * admission normalizes every problem onto the stream's one canvas
    (``normalize_problem``) and warm-starts from the shared
    ``WarmStartCache`` — (problem_id, λ) exact hit or nearest-λ fallback;
  * per-slot convergence is read at each launch boundary from the
    in-kernel objective trace (``launch_converged``) and health scalar —
    one host read of f (S, R) and health (S,) per launch; a converged slot
    is finalized, its solution written back to the cache, and the slot is
    refilled from the queue at once, so one slow problem never idles the
    batch;
  * empty and finalized slots ride along with ``k_eff = 0`` (an exact
    no-op); a slot whose health scalar trips rolls back to its admission
    snapshot with ``k_eff`` halved (the divergence backoff at launch
    granularity, per slot);
  * the stream's shapes and loss never change, so it runs one compiled
    kernel from first request to last: ``k_eff`` and ``guard_f`` are
    device values, not template arguments.

A request's draws are fixed at its first admission — the ``blk_sched`` it
carries, or drawn from its ``seed`` — and never depend on its slot, its
co-tenants or its eviction history, which is what makes a served stream
equal the same requests solved one at a time.  Slot/queue bookkeeping
(free slots, FIFO refill, age, round-deadline eviction with re-queue) is
``launch.slots.SlotBoard``; an evicted solve keeps its partial iterate and
margin and resumes from them when re-admitted.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import objectives as obj
from repro_torch.core.batched import (BatchMeta, SlotArrays, WarmStartCache,
                                      admit_slot, batch_meta_of, empty_slots,
                                      launch_converged, launch_rounds,
                                      map_slot_arrays, x_on_canvas)
from repro_torch.core.objectives import Problem
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import block_stream
from repro_torch.launch.slots import SlotBoard

GUARD_FACTOR = 10.0         # trip threshold: F > factor·|F_prev| + factor

# The service's spans (``obs``): an admission and its phases, a scheduler
# step (the batched launch, then the host read of f and health), and a
# finalized request.
ADMIT_SPAN = "repro_torch.serve.admit"
LAUNCH_SPAN = "repro_torch.serve.launch"
FINALIZE_SPAN = "repro_torch.serve.finalize"


@dataclasses.dataclass
class SolveRequest:
    """One (problem_id, λ, x0) solve in the stream.  ``prob`` carries λ
    (``Problem.lam``); ``x0`` (true-d) overrides the warm cache when set.
    Draws: ``blk_sched`` ((max_launches·R, K) int32, e.g. another
    package's stream) or, without it, a ``torch.Generator`` seeded with
    ``seed`` draws the whole schedule at first admission.  Filled in by
    the service: ``x`` (true-d solution, on the service's device),
    ``rounds_used``, ``status`` ("ok"/"diverged"/"gave_up"), ``warm`` (cache
    verdict)."""
    rid: int
    problem_id: object
    prob: Problem
    seed: int | None = None
    blk_sched: torch.Tensor | np.ndarray | None = None
    x0: torch.Tensor | np.ndarray | None = None
    x: torch.Tensor | None = None
    rounds_used: int = 0
    launches: int = 0
    status: str = ""
    warm: str = ""
    f_final: float = float("nan")
    done: bool = False
    evictions: int = 0
    # service-internal
    k_eff: int = 0
    f_prev: float = float("inf")
    sched: torch.Tensor | None = None      # (max_launches, R, K) int32
    z_resume: torch.Tensor | None = None   # evicted margin (padded n_pad)


# --- the service's device steps, plain functions ---------------------------

def _write_slot(stacked: SlotArrays, x, z, x_snap, z_snap, slot: int,
                sa: SlotArrays, x0, z0) -> None:
    """Admit one normalized problem into slot ``slot`` of the stacked state
    and refresh that slot's rollback snapshot — IN PLACE: the stacked
    tensors belong to the service, and an admission copies one slot's
    worth instead of rebuilding all S."""
    obs.count("serve.admit_bytes", obs.nbytes(*sa) + 2 * obs.nbytes(x0, z0))
    map_slot_arrays(lambda full, v: full[slot].copy_(v), stacked, sa)
    for full, v in ((x, x0), (z, z0), (x_snap, x0), (z_snap, z0)):
        full[slot].copy_(v)


def _rollback_slot(x, z, x_snap, z_snap, slot: int) -> None:
    """Slot ``slot`` back to its admission snapshot, in place."""
    x[slot].copy_(x_snap[slot])
    z[slot].copy_(z_snap[slot])


class SolverService:
    """Continuous-batched Shotgun solver over a fixed bank of slots.

    ``meta`` fixes the stream's canvas (build it from a template problem
    with ``batch_meta_of``); every request must normalize onto it.
    ``max_rounds`` is the fixed per-request budget (the cold-start budget);
    ``tol`` the launch-boundary relative-change stop.  ``deadline_launches``
    (optional) enables SlotBoard round-deadline eviction: a solve stuck
    past the deadline is re-queued at the tail and resumes from its partial
    iterate when re-admitted.  The stacked state lives on ``device``, where
    the requests' problems must live too.
    """

    def __init__(self, meta: BatchMeta, *, slots: int = 4, K: int = 2,
                 max_rounds: int = 64, rounds_per_launch: int = 8,
                 tol: float = 1e-4, cache: WarmStartCache | None = None,
                 deadline_launches: int | None = None,
                 max_evictions: int = 2, device="cuda"):
        if max_rounds % rounds_per_launch:
            raise ValueError(f"max_rounds={max_rounds} not divisible by "
                             f"rounds_per_launch={rounds_per_launch}")
        self.meta = meta
        self.K = K
        self.R = rounds_per_launch
        self.max_launches = max_rounds // rounds_per_launch
        self.tol = tol
        self.device = resolve_device(device)
        self.cache = WarmStartCache() if cache is None else cache
        self.board = SlotBoard(slots, max_rounds=deadline_launches,
                               max_evictions=max_evictions)
        S, m, dev = slots, meta, self.device

        def zero(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.stacked = empty_slots(m, S, dev)
        self.x = zero(S, m.d_pad)
        self.z = zero(S, m.n_pad)
        self.x_snap = zero(S, m.d_pad)
        self.z_snap = zero(S, m.n_pad)
        self._idle_idx = zero(self.R, K, dtype=torch.int32)
        self.launch_count = 0           # batched launches issued
        self.occupancy_samples: list[float] = []

    # -- admission ---------------------------------------------------------
    def _warm_start(self, req: SolveRequest):
        """Pick the slot's x0: explicit request x0 beats the warm cache
        (λ-path threading passes it directly); else (problem_id, λ) lookup
        with nearest-λ fallback; else cold zeros (None)."""
        if req.x0 is not None:
            req.warm = req.warm or "given"
            return req.x0
        x0, kind = self.cache.get(req.problem_id, float(req.prob.lam),
                                  loss=req.prob.loss)
        req.warm = kind
        return x0

    def _admit(self, req: SolveRequest, slot: int) -> None:
        m, dev = self.meta, self.device
        if req.prob.loss != m.loss:
            # one kernel per stream: a mixed-loss stream would either
            # switch kernels or silently run the wrong residual tile
            raise ValueError(
                f"mixed-loss stream: request {req.problem_id!r} carries "
                f"loss {req.prob.loss!r} but this stream is admitted for "
                f"loss {m.loss!r}")
        with obs.span(ADMIT_SPAN, rid=req.rid):
            with obs.span(ADMIT_SPAN + ".layout"):
                # a design served before brings its canvas and layouts
                # cached on its container
                adm = admit_slot(req.prob, m)
            with obs.span(ADMIT_SPAN + ".warm"):
                x0 = self._to_canvas(self._warm_start(req))
            with obs.span(ADMIT_SPAN + ".margin"):
                if req.z_resume is not None:
                    # deadline-evicted solve resuming mid-trajectory:
                    # restore the kernel-accumulated margin exactly
                    # (recomputing z = A·x0 would fork the fp trajectory —
                    # determinism test)
                    z0 = req.z_resume
                    req.z_resume = None
                    made = (x0,)
                else:
                    z0 = obj.matvec(adm.design, x0)
                    made = (x0, z0)
            adm.count(made)
            _write_slot(self.stacked, self.x, self.z, self.x_snap,
                        self.z_snap, slot, adm.slot, x0, z0)
            if req.f_prev == float("inf"):
                with obs.span(ADMIT_SPAN + ".objective"):
                    req.f_prev = float(obj.masked_objective(
                        z0, x0, adm.slot.y, adm.mask, adm.slot.lam, m.loss))
            req.k_eff = self.K if req.k_eff == 0 else req.k_eff
            if req.sched is None:
                # The request's whole draw schedule is fixed at first
                # admission from ITS stream — independent of slot,
                # co-tenants and eviction history, which makes the served
                # stream deterministic.
                if req.blk_sched is None and req.seed is None:
                    raise ValueError(f"request {req.rid}: pass seed= or "
                                     "blk_sched=")
                gen = (None if req.blk_sched is not None else
                       torch.Generator(device=dev).manual_seed(
                           int(req.seed)))
                rounds = self.max_launches * self.R
                with obs.span(ADMIT_SPAN + ".draws"):
                    req.sched = block_stream(
                        req.blk_sched, gen, rounds, self.K, m.nblk,
                        dev).reshape(self.max_launches, self.R, self.K)
            self.board.place(req, slot)

    def _to_canvas(self, x0) -> torch.Tensor:
        """A warm start (true-d, on the host or the card; None for cold)
        as a padded f32 iterate on the service's device."""
        dev = self.device
        if x0 is not None and not (isinstance(x0, torch.Tensor)
                                   and x0.device.type == dev.type):
            obs.count("serve.cache_host_bytes", x0.nbytes)
        return x_on_canvas(x0, self.meta.d_pad, dev)

    # -- the batched scheduler step ---------------------------------------
    def _launch_step(self) -> None:
        with obs.span(LAUNCH_SPAN):
            S = len(self.board.slots)
            idx = [self._idle_idx] * S
            k_eff = np.zeros(S, np.float32)
            guard = np.full(S, np.inf, np.float32)
            for i, r in enumerate(self.board.slots):
                if r is None or r.done:
                    continue
                idx[i] = r.sched[r.launches]
                k_eff[i] = r.k_eff
                guard[i] = GUARD_FACTOR * abs(r.f_prev) + GUARD_FACTOR
            with obs.span(LAUNCH_SPAN + ".kernel"):
                self.x, self.z, fs, _, hlt = launch_rounds(
                    self.meta, self.stacked, self.z, self.x,
                    torch.stack(idx), torch.from_numpy(k_eff).to(self.device),
                    guard_f=torch.from_numpy(guard).to(self.device))
            self.launch_count += 1
            # the launch-boundary contract: one host read of f and health
            with obs.span(LAUNCH_SPAN + ".read"):
                fs_h, hlt_h = fs.cpu().numpy(), hlt.cpu().numpy()
            for i, r in enumerate(self.board.slots):
                if r is None or r.done:
                    continue
                if hlt_h[i] > 0 or not np.isfinite(fs_h[i, -1]):
                    # in-kernel guard tripped: backoff at slot granularity
                    # — roll back to the admission snapshot, halve k_eff
                    if r.k_eff <= 1:
                        self._finalize(i, r, "diverged")
                        continue
                    r.k_eff = max(1, r.k_eff // 2)
                    _rollback_slot(self.x, self.z, self.x_snap, self.z_snap,
                                   i)
                    r.launches += 1    # burn the launch: draws stay scheduled
                    if r.launches >= self.max_launches:
                        self._finalize(i, r, "diverged")
                    continue
                r.launches += 1
                r.rounds_used += self.R
                done_budget = r.launches >= self.max_launches
                r_converged = launch_converged(r.f_prev, fs_h[i], self.tol)
                r.f_prev = float(fs_h[i, -1])
                if r_converged or done_budget:
                    self._finalize(i, r, "ok")

    def _finalize(self, slot: int, req: SolveRequest, status: str) -> None:
        with obs.span(FINALIZE_SPAN, rid=req.rid):
            req.x = self.x[slot, : req.prob.d].clone()
            req.f_final = req.f_prev
            req.status = status
            req.done = True
            req.k_eff = 0
            if status == "ok":
                self.cache.put(req.problem_id, float(req.prob.lam), req.x,
                               loss=req.prob.loss)

    def _save_partials(self) -> None:
        """Before deadline eviction: stash each stale slot's iterate and
        margin so the re-queued request resumes from them (its x0 and
        z_resume) when re-admitted."""
        if self.board.max_rounds is None:
            return
        for i, r in enumerate(self.board.slots):
            if r is None or r.done or self.board.age[i] < \
                    self.board.max_rounds:
                continue
            r.x0 = self.x[i, : r.prob.d].clone()
            r.z_resume = self.z[i].clone()
            r.warm = r.warm or "given"

    # -- the serving loop --------------------------------------------------
    def serve(self, requests) -> list[SolveRequest]:
        """Serve a request list to completion; returns them finished (in
        completion order — sort by ``rid`` for stream order)."""
        self.board.queue.extend(requests)
        while self.board.pending():
            self.board.refill(self._admit)
            if not self.board.live():
                break
            self.occupancy_samples.append(self.board.occupancy())
            self._launch_step()
            self.board.tick()
            self._save_partials()
            # evicted slots go empty → k_eff 0 next launch (exact no-op)
            self.board.evict_stale()
        out = self.board.drain()
        # the board's list keeps the reference's semantics (it grows for
        # the board's life); the service hands each call its own requests
        self.board.finished = []
        for r in out:                 # give-ups keep their partial iterate
            if r.status == "":
                r.x = r.x0 if r.x0 is not None else r.x
                r.status = "gave_up"
        return out

    @property
    def slot_occupancy(self) -> float:
        """Mean live-slot fraction over all scheduler steps."""
        return (float(np.mean(self.occupancy_samples))
                if self.occupancy_samples else 0.0)


def solve_queue_sequential(requests, *, K: int = 2, max_rounds: int = 64,
                           rounds_per_launch: int = 8, tol: float = 1e-4,
                           cache: WarmStartCache | None = None,
                           device="cuda"):
    """The solve-one-at-a-time baseline: each request served through a
    1-slot service (same launch schedule, same early stop, same cache
    semantics) with no batching."""
    out = []
    for req in requests:
        svc = SolverService(batch_meta_of(req.prob), slots=1, K=K,
                            max_rounds=max_rounds,
                            rounds_per_launch=rounds_per_launch, tol=tol,
                            cache=cache, device=device)
        out.extend(svc.serve([req]))
    return out


def make_stream(n: int, d: int, *, requests: int, repeat_frac: float = 0.0,
                num_designs: int = 2, lam: float = 0.5, seed: int = 0,
                device="cuda"):
    """A synthetic request stream over ``num_designs`` shared designs:
    unique (problem_id, λ) pairs with a ``repeat_frac`` tail of repeats
    (warm-cache traffic).  Designs are ``synthetic.sparco`` problems — low
    ρ(AᵀA), so K·128-wide parallel updates sit under the Thm 3.2 ceiling
    and solves converge.  Request ``rid`` draws from seed 1000 + rid."""
    from repro_torch.data import synthetic as syn
    dev = resolve_device(device)
    designs = []
    for pid in range(num_designs):
        A, y, _ = syn.sparco(seed=seed + pid, n=n, d=d)
        designs.append(obj.make_problem(A, y, lam=lam, device=dev))
    return stream_over(designs, requests=requests, repeat_frac=repeat_frac,
                       lam=lam, seed=1000)


def stream_over(designs, *, requests: int, repeat_frac: float, lam: float,
                seed: int) -> list[SolveRequest]:
    """``make_stream``'s request rule over given designs (problem_id = the
    design's index): the first round(requests·(1 − repeat_frac)) requests
    are unique pairs, request j on design j mod D at λ·(1 + 0.5·⌊j/D⌋); the
    rest repeat them in order.  Request ``rid`` draws from seed + rid."""
    D = len(designs)
    n_unique = max(1, int(round(requests * (1.0 - repeat_frac))))
    reqs = []
    for rid in range(requests):
        src = rid if rid < n_unique else rid % n_unique
        pid = src % D
        lam_r = lam * (1.0 + 0.5 * (src // D))
        prob = designs[pid]._replace(lam=torch.full(
            (), lam_r, dtype=torch.float32, device=designs[pid].y.device))
        reqs.append(SolveRequest(rid=rid, problem_id=pid, prob=prob,
                                 seed=seed + rid))
    return reqs


def main():
    ap = argparse.ArgumentParser()
    # defaults: K=1 at this shape/λ stays under the paper's P* interference
    # limit, so cold solves converge in 48-72 rounds
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--d", type=int, default=512)
    ap.add_argument("--K", type=int, default=1)
    ap.add_argument("--max-rounds", type=int, default=128)
    ap.add_argument("--rounds-per-launch", type=int, default=8)
    ap.add_argument("--repeat-frac", type=float, default=0.5)
    ap.add_argument("--lam", type=float, default=4.0)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    reqs = make_stream(a.n, a.d, requests=a.requests,
                       repeat_frac=a.repeat_frac, lam=a.lam, seed=a.seed,
                       device=a.device)
    svc = SolverService(batch_meta_of(reqs[0].prob), slots=a.slots, K=a.K,
                        max_rounds=a.max_rounds,
                        rounds_per_launch=a.rounds_per_launch, tol=a.tol,
                        device=a.device)
    t0 = time.time()
    done = svc.serve(reqs)
    dt = time.time() - t0
    for r in sorted(done, key=lambda r: r.rid):
        print(f"[solver-serve] req {r.rid} pid={r.problem_id} "
              f"lam={float(r.prob.lam):.3f}: {r.status} "
              f"rounds={r.rounds_used} warm={r.warm} f={r.f_final:.5f}")
    st = svc.cache.stats
    print(f"[solver-serve] {len(done)} solves in {dt:.2f}s "
          f"({len(done)/max(dt,1e-9):.2f} solves/s) on {svc.device}, "
          f"{svc.launch_count} launches, "
          f"occupancy={svc.slot_occupancy:.2f}, cache "
          f"exact/near/miss={st.hits_exact}/{st.hits_near}/{st.misses}")


if __name__ == "__main__":
    main()
