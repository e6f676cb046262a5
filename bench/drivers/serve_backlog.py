"""A backlog of λ-grid jobs through ``SolverService``: each call serves one
job of requests over a few shared designs, to completion, with a warm-start
cache of its own (a job warms only from its own solves, as a
cross-validation or grid job over fresh data would)."""
from __future__ import annotations

import torch

from bench.data import generators, streams
from bench.drivers.common import Reservoir, now, port_problem, sync
from bench.reference import bytes as nbytes
from bench.reference import serve as ref_serve
from bench.reference import shotgun as ref


class Driver:
    range_name = "bench.serve"

    def __init__(self, cfg: dict, mix: dict, seed: int, device,
                 variant: str | None = None):
        if variant is not None:
            raise ValueError("the service has no lower-precision path: its "
                             "control is the reference in bfloat16")
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.grid = streams.lam_grid(*mix["lam_grid"])
        self.max_launches = mix["max_rounds"] // mix["rounds_per_launch"]
        self.requests = mix["designs"] * len(self.grid) * mix["copies"]
        self.sample = Reservoir(mix["sample"], seed)
        self.traced: list[list[ref_serve.Served]] = []
        self.attempted = self.completed = self.launches = 0
        self.occupancy: list[float] = []

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.core.batched import batch_meta_of
        from repro_torch.launch import solver_serve
        self.serve_mod = solver_serve
        self.probs, self.lams, self.block_bytes = [], [], []
        for p in range(self.mix["designs"]):
            data = generators.make(self.cfg, self._design_seed(p),
                                   self.device)
            prob, lam_max = port_problem(self.cfg, data, self.device)
            self.probs.append(prob)
            self.lams.append([r * lam_max for r in self.grid])
            if isinstance(data.A, generators.SparseRaw):
                self.block_bytes.append(nbytes.block_bytes_sparse(
                    data.A.nnz_blk, 4))
            else:
                self.block_bytes.append(nbytes.block_bytes_dense(
                    prob.n, prob.d, 4))
            del data
        self.n, self.d = self.probs[0].n, self.probs[0].d
        metas = {batch_meta_of(p) for p in self.probs}
        if len(metas) != 1:
            raise ValueError(f"designs of one stream differ in shape: "
                             f"{metas}")
        self.meta = metas.pop()
        self.svc = solver_serve.SolverService(
            self.meta, slots=self.mix["slots"], K=self.mix["K"],
            max_rounds=self.mix["max_rounds"],
            rounds_per_launch=self.mix["rounds_per_launch"],
            tol=self.mix["tol"], device=self.device)
        for w in range(self.mix["warmup"]):
            self._serve(self._requests(-1 - w))
        sync(self.device)

    def _design_seed(self, p: int) -> int:
        return streams.subseed(self.seed, streams.DESIGN, p)

    def _pairs(self, index: int) -> list[streams.Request]:
        return streams.job(self.seed, index, designs=self.mix["designs"],
                           grid=len(self.grid), copies=self.mix["copies"])

    def scheds(self, index: int) -> torch.Tensor:
        return streams.job_draws(self.seed, index,
                                 requests=self.requests,
                                 rounds=self.mix["max_rounds"],
                                 K=self.mix["K"], nblk=self.meta.nblk,
                                 device=self.device)

    def _requests(self, index: int):
        scheds = self.scheds(index)
        return [self.serve_mod.SolveRequest(
            rid=r, problem_id=q.pid,
            prob=self.probs[q.pid]._replace(lam=self.lams[q.pid][q.lam_idx]),
            blk_sched=scheds[r])
            for r, q in enumerate(self._pairs(index))]

    def _serve(self, reqs):
        """Serve one job with a fresh cache; ``serve`` returns every
        request the service ever finished, so keep this job's."""
        from repro_torch.core.batched import WarmStartCache
        self.svc.cache = WarmStartCache()
        mine = {id(r) for r in reqs}
        return [r for r in self.svc.serve(reqs) if id(r) in mine]

    # -- the window -------------------------------------------------------------
    def call(self, i: int) -> list[float]:
        """Serve job ``i`` to completion; no per-solve times (a request's
        time in a backlog is its place in the queue)."""
        reqs = self._requests(i)
        sync(self.device)
        launches0 = self.svc.launch_count
        samples0 = len(self.svc.occupancy_samples)
        with torch.profiler.record_function(self.range_name):
            done = self._serve(reqs)
        sync(self.device)
        done = sorted(done, key=lambda r: r.rid)
        self.attempted += len(done)
        self.completed += sum(r.status == "ok" for r in done)
        self.launches += self.svc.launch_count - launches0
        self.occupancy += self.svc.occupancy_samples[samples0:]
        if len(self.traced) < self.mix["trace_calls"]:
            self.traced.append(self._served(i, done))
        self.sample.offer(lambda: (i, self._served(i, done),
                                   [(r.x, r.f_final, r.warm) for r in done]))
        return []

    def _served(self, i, done) -> list[ref_serve.Served]:
        """What the service reported for job ``i``, in request order (the
        draws are made again when the job is judged)."""
        pairs = self._pairs(i)
        return [ref_serve.Served(pid=pairs[r.rid].pid,
                                 lam_idx=pairs[r.rid].lam_idx, sched=None,
                                 launches=r.launches,
                                 rounds_used=r.rounds_used, status=r.status)
                for r in done]

    def tally(self) -> dict:
        occ = (sum(self.occupancy) / len(self.occupancy)
               if self.occupancy else None)
        return dict(attempted=self.attempted, completed=self.completed,
                    failed=self.attempted - self.completed,
                    counters=dict(launches=self.launches, occupancy=occ))

    def trace_work(self, calls: int) -> tuple[int, int]:
        """(completed solves, bytes) of the first ``calls`` jobs: each
        launch step's rounds read the distinct (design, block) pairs its
        live slots draw."""
        solves, total = 0, 0
        K, R = self.mix["K"], self.mix["rounds_per_launch"]
        for i, job in enumerate(self.traced[:calls]):
            scheds = self.scheds(i).long().cpu()
            steps = [ref_serve.steps_of(r, self.max_launches) for r in job]
            admit, _, final = ref_serve.schedule(steps, self.mix["slots"])
            for t in range(max(final) + 1):
                live = [q for q in range(len(job)) if admit[q] <= t <= final[q]]
                idx = torch.stack([scheds[q, (t - admit[q]) * R:
                                          (t - admit[q] + 1) * R]
                                   for q in live], dim=1)   # (R, m, K)
                pid = torch.tensor([job[q].pid for q in live])
                pairs = torch.stack([pid[None, :, None].expand_as(idx), idx],
                                    dim=-1).reshape(R, len(live) * K, 2)
                total += nbytes.rounds_bytes(pairs, self.block_bytes)
            total += len(job) * nbytes.solve_bytes(self.n, self.d)
            solves += sum(r.status == "ok" for r in job)
        return solves, total

    # -- after the window -------------------------------------------------------
    def release(self) -> None:
        self.svc = self.probs = self.lams = self.serve_mod = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "f64"):
        designs = []
        for p in range(self.mix["designs"]):
            data = generators.make(self.cfg, self._design_seed(p),
                                   self.device)
            designs.append(ref.Design(data.A, data.y, self.cfg["loss"],
                                      precision))
            del data
        lams = [[r * D.lambda_max() for r in self.grid] for D in designs]
        return designs, lams

    def replay(self, designs, lams, job, band: float):
        return ref_serve.replay(
            designs, lams, job, slots=self.mix["slots"], K=self.mix["K"],
            R=self.mix["rounds_per_launch"], max_launches=self.max_launches,
            tol=self.mix["tol"], band=band)

    def verify(self, limits: dict, served=None) -> dict:
        """The numbers compared over the sampled jobs' requests: the widest
        relative gap of x and of the final objective from the reference's
        replay, and the count of differing decisions (cache verdict,
        status, launches, rounds, and stops beyond the rounding band)."""
        designs, lams = self.reference()
        band = 2.0 * limits["f_gap"]
        out = dict(f_gap=0.0, x_gap=0.0, decisions=0)
        for i, job, answers in (served or self.sample.items):
            scheds = self.scheds(i)
            job = [r._replace(sched=scheds[q]) for q, r in enumerate(job)]
            want = self.replay(designs, lams, job, band)
            for r, (x, f_final, warm), w in zip(job, answers, want):
                out["x_gap"] = max(out["x_gap"], ref.rel_gap(x, w.x))
                out["f_gap"] = max(out["f_gap"], ref.trace_gap(
                    torch.tensor([f_final]), torch.tensor([w.f_final])))
                out["decisions"] += w.stops + sum(
                    a != b for a, b in ((warm, w.warm), (r.status, w.status),
                                        (r.launches, w.launches),
                                        (r.rounds_used, w.rounds_used)))
        return out
