"""``solve_loop``'s closed loop on a design drawn in CSC (``bench.data.
csc``): the port's design is ``BlockedCSC.from_csc`` at the
configuration's ``tile``, so the columns deeper than the tile go to its
overflow store; the reference is ``bench.reference.csc.Design``.  The
bytes of the traced work count each drawn block's true nonzeros, spilled
ones included."""
from __future__ import annotations

import torch

from bench.data import csc, streams
from bench.drivers import solve_loop
from bench.drivers.common import sync, to_bf16
from bench.reference import bytes as nbytes
from bench.reference import csc as ref_csc
from bench.reference import shotgun as ref


def port_problem(cfg: dict, A: csc.CscRaw, y, device):
    """The port's ``Problem`` of a CSC design through its public
    constructors (``BlockedCSC.from_csc``, ``make_problem``) at λ =
    lam_ratio·λ_max, where the port computes λ_max."""
    from repro_torch.core import objectives as obj
    from repro_torch.data.sparse import BlockedCSC
    S = BlockedCSC.from_csc(A.col_ptr, A.rows, A.vals, A.n, A.d,
                            tile=cfg["tile"], device=device)
    prob = obj.make_problem(S, y, 1.0, loss=cfg["loss"], device=device)
    lam_max = obj.lambda_max(prob.A, prob.y, cfg["loss"])
    return prob._replace(lam=cfg["lam_ratio"] * lam_max)


class Driver(solve_loop.Driver):

    def setup(self) -> None:
        from repro_torch.core.health import GuardConfig
        from repro_torch.core.spec import SolverSpec
        from repro_torch.kernels import ops
        self.ops = ops
        data = csc.make(self.cfg, self._design_seed(), self.device)
        self.n, self.d = data.A.n, data.A.d
        self.nblk = -(-self.d // solve_loop.BLOCK)
        prob = port_problem(self.cfg, data.A, data.y, self.device)
        if self.variant == "bf16":
            prob = to_bf16(prob)
        self.prob = prob
        self.block_bytes = nbytes.block_bytes_sparse(
            data.A.nnz_blk, prob.A.vals.element_size())
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

    def verify(self, limits: dict) -> dict:
        """As ``solve_loop``'s, against the CSC reference."""
        data = csc.make(self.cfg, self._design_seed(), self.device)
        D = ref_csc.Design(data.A, data.y, self.cfg["loss"])
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
