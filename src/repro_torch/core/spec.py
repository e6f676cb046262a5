"""SolverSpec: one declarative description of a solve (DESIGN §12).

Port of ``repro.core.spec``.  The spec is solver-family agnostic: fields a
family does not implement are ignored by it (``merge``/``pipeline`` only
matter to the sharded solver; ``fused``/``newton`` only to the block
solvers).  ``loss`` is always validated against the problem's loss so a
spec built for one workload can never silently drive another.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.health import GuardConfig


@dataclasses.dataclass(frozen=True)
class SolverSpec:
    """Declarative solve description accepted via ``spec=``.

    loss      "lasso" or "logistic" — must match ``prob.loss``.
    P         target coordinate parallelism per round.  Block solvers
              round up to K = ceil(P / 128) blocks.
    rounds    number of (outer) rounds.
    merge     sharded merge cadence, "round" (one Δz all-reduce per round)
              or "launch" (``rounds_per_launch`` stale rounds per merge);
              ``core.sharded`` rejects any other value.  Ignored elsewhere.
    pipeline  sharded double-buffered merge pipeline; ignored elsewhere.
    guard     ``health.GuardConfig`` enabling the divergence sentinel +
              adaptive-P backoff (DESIGN §9), or None.
    fused     run the fused multi-round kernel path (block solvers).
    newton    per-block Newton curvature (Bian et al.) instead of the
              β-Lipschitz step; requires ``fused=True`` (the curvature
              tile only exists inside the fused kernel body).
    """

    loss: str = "lasso"
    P: int = 8
    rounds: int = 500
    merge: str = "round"
    pipeline: bool = False
    guard: GuardConfig | None = None
    fused: bool = False
    newton: bool = False

    def __post_init__(self):
        if self.newton and not self.fused:
            raise ValueError(
                "SolverSpec(newton=True) requires fused=True: the per-block "
                "curvature tile is computed inside the fused kernel body")
        if self.P < 1 or self.rounds < 1:
            raise ValueError(
                f"SolverSpec needs P >= 1 and rounds >= 1, got "
                f"P={self.P}, rounds={self.rounds}")

    def check_loss(self, prob_loss: str):
        """Raise if this spec was built for a different loss than the
        problem's — both losses named, per the serve-layer convention."""
        if self.loss != prob_loss:
            raise ValueError(
                f"SolverSpec(loss={self.loss!r}) does not match problem "
                f"loss {prob_loss!r}")


def reject_legacy_kwargs(spec, **named):
    """Guard for the shim entry points: with ``spec=`` given, any
    explicitly-passed legacy solver-shape kwarg (non-None) is an error —
    the caller must pick one interface."""
    if spec is None:
        return
    bad = [k for k, v in named.items() if v is not None]
    if bad:
        raise ValueError(
            f"pass spec= or the legacy kwargs {bad}, not both")
