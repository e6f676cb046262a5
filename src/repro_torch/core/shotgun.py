"""Result types of the Shotgun solvers (port of ``repro.core.shotgun``
:36-47).  The scalar solvers themselves are ROADMAP Queue 1 #7."""
from __future__ import annotations

from typing import NamedTuple

import torch


class Trace(NamedTuple):
    objective: torch.Tensor   # (rounds,) F(x^(t)) after round t
    nnz: torch.Tensor         # (rounds,) number of non-zeros


class Result(NamedTuple):
    x: torch.Tensor
    z: torch.Tensor           # final margin A x
    trace: Trace
    # health.STATUS_OK / STATUS_RECOVERED / STATUS_DIVERGED (0-dim int32).
    status: torch.Tensor | None = None
