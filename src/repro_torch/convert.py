"""Carry a problem and a result across between the JAX package and the port
as numpy arrays (the port never imports JAX)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import objectives as obj
from repro_torch.core.objectives import Problem
from repro_torch.core.shotgun import Result, Trace
from repro_torch.device import resolve_device


def problem_from_numpy(A, y, lam, loss, scales=None, *,
                       device="cuda") -> Problem:
    """The port's ``Problem`` from the arrays of a JAX ``Problem`` (as
    numpy).  Nothing is renormalized, so both packages solve the identical
    problem."""
    dev = resolve_device(device)
    if loss == obj.LOGISTIC:
        obj.check_logistic_labels(y)
    f32 = dict(dtype=torch.float32, device=dev)
    return Problem(
        A=torch.tensor(np.asarray(A, np.float32), **f32),
        y=torch.tensor(np.asarray(y, np.float32), **f32),
        lam=torch.tensor(np.float32(lam), **f32),
        loss=loss,
        scales=(None if scales is None
                else torch.tensor(np.asarray(scales, np.float32), **f32)))


def result_to_numpy(res: Result) -> Result:
    """The same ``Result`` with every tensor as a numpy array."""
    def cpu(t):
        return None if t is None else t.detach().cpu().numpy()
    return Result(x=cpu(res.x), z=cpu(res.z),
                  trace=Trace(objective=cpu(res.trace.objective),
                              nnz=cpu(res.trace.nnz)),
                  status=cpu(res.status))
