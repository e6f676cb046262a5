"""One client solving back to back in a closed loop: each call is one
cold-start ``block_shotgun_solve`` on the configuration's problem with
block draws the benchmark makes from (seed, call index)."""
from __future__ import annotations

import torch

from bench.data import generators, streams
from bench.drivers.common import Reservoir, now, port_problem, sync, to_bf16
from bench.reference import bytes as nbytes
from bench.reference import shotgun as ref

BLOCK = generators.BLOCK


class Driver:
    range_name = "bench.solve"

    def __init__(self, cfg: dict, mix: dict, seed: int, device,
                 variant: str | None = None):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.variant = variant
        self.K = -(-mix["P"] // BLOCK)
        self.sample = Reservoir(mix["sample"], seed)
        self.statuses: list[torch.Tensor] = []

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.core.health import GuardConfig
        from repro_torch.core.spec import SolverSpec
        from repro_torch.kernels import ops
        self.ops = ops
        data = generators.make(self.cfg, self._design_seed(), self.device)
        self.n, self.d = data.y.shape[0], data.x_true.shape[0]
        self.nblk = -(-self.d // BLOCK)
        prob, lam_max = port_problem(self.cfg, data, self.device)
        prob = prob._replace(lam=self.cfg["lam_ratio"] * lam_max)
        if self.variant == "bf16":
            prob = to_bf16(prob)
        self.prob = prob
        self.block_bytes = self._block_bytes(data, prob)
        del data
        guard = self.mix["guard"]
        self.spec = SolverSpec(loss=self.cfg["loss"], P=self.mix["P"],
                               rounds=self.mix["rounds"], fused=True,
                               newton=self.mix["newton"],
                               guard=None if guard is None
                               else GuardConfig(**guard))
        for w in range(self.mix["warmup"]):
            self._solve(self._draws(streams.WARMUP, w))
        sync(self.device)

    def _design_seed(self) -> int:
        return streams.subseed(self.seed, streams.DESIGN, 0)

    def _block_bytes(self, data, prob) -> torch.Tensor:
        if isinstance(data.A, generators.SparseRaw):
            return nbytes.block_bytes_sparse(data.A.nnz_blk,
                                             prob.A.vals.element_size())
        return nbytes.block_bytes_dense(self.n, self.d,
                                        prob.A.element_size())

    def _draws(self, space: int, i: int) -> torch.Tensor:
        return streams.draws(streams.subseed(self.seed, space, i),
                             self.mix["rounds"], self.K, self.nblk,
                             self.device)

    def _solve(self, idx):
        return self.ops.block_shotgun_solve(
            self.prob, spec=self.spec, blk_idx=idx,
            rounds_per_launch=self.mix["rounds_per_launch"])

    # -- the window -------------------------------------------------------------
    def call(self, i: int) -> list[float]:
        """Solve ``i``; returns its seconds, call to synchronised result."""
        idx = self._draws(streams.WINDOW, i)
        sync(self.device)
        t0 = now()
        with torch.profiler.record_function(self.range_name):
            res = self._solve(idx)
        sync(self.device)
        seconds = now() - t0
        self.statuses.append(res.status)
        self.sample.offer(lambda: (i, res.x, res.z, res.trace.objective,
                                   res.status))
        return [seconds]

    def tally(self) -> dict:
        """The window's solves: attempted, completed (not diverged),
        failed, and the driver's counters."""
        st = torch.stack(self.statuses).cpu() if self.statuses else \
            torch.zeros(0)
        failed = int((st == ref.STATUS_DIVERGED).sum())
        return dict(attempted=len(self.statuses),
                    completed=len(self.statuses) - failed, failed=failed,
                    counters={})

    def trace_work(self, calls: int) -> tuple[int, int]:
        """(solves, bytes) of the first ``calls`` calls of the window."""
        total = 0
        for i in range(calls):
            idx = self._draws(streams.WINDOW, i).long().cpu()
            pairs = torch.stack([torch.zeros_like(idx), idx], dim=-1)
            total += nbytes.rounds_bytes(pairs, [self.block_bytes])
            total += nbytes.solve_bytes(self.n, self.d)
        return calls, total

    # -- after the window -------------------------------------------------------
    def release(self) -> None:
        """Free the port's state; the sampled answers stay."""
        self.prob = None
        self.ops = None
        self.statuses = []
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def verify(self, limits: dict) -> dict:
        """The numbers compared: over the sampled solves, the widest
        relative gap of the objective trace, of x and of z from the
        reference's, and the count of differing statuses."""
        data = generators.make(self.cfg, self._design_seed(), self.device)
        D = ref.Design(data.A, data.y, self.cfg["loss"])
        del data
        lam = self.cfg["lam_ratio"] * D.lambda_max()
        out = dict(f_gap=0.0, x_gap=0.0, z_gap=0.0, decisions=0)
        for i, x, z, trace, status in self.sample.items:
            want = ref.solve(D, lam, self._draws(streams.WINDOW, i),
                             R=self.mix["rounds_per_launch"],
                             newton=self.mix["newton"],
                             guard=self.mix["guard"])
            out["f_gap"] = max(out["f_gap"], ref.trace_gap(trace,
                                                           want.trace))
            out["x_gap"] = max(out["x_gap"], ref.rel_gap(x, want.x))
            out["z_gap"] = max(out["z_gap"], ref.rel_gap(z, want.z))
            out["decisions"] += int(int(status) != want.status)
        return out
