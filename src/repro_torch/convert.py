"""Carry a problem and a result across between the JAX package and the port
as numpy arrays (the port never imports JAX)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import objectives as obj
from repro_torch.core.objectives import Problem
from repro_torch.core.shotgun import Result, Trace
from repro_torch.data.sparse import BLOCK, BlockedCSC
from repro_torch.device import resolve_device


def bcsc_from_numpy(rows, vals, n: int, d: int, block: int = BLOCK, *,
                    device="cuda") -> BlockedCSC:
    """The port's ``BlockedCSC`` from a JAX container's ``rows``/``vals``
    (as numpy; bf16 values stay bf16, exactly) and its ``n``/``d``."""
    dev = resolve_device(device)
    vals = np.asarray(vals)
    bf16 = vals.dtype.name == "bfloat16"
    tv = torch.from_numpy(np.array(vals, np.float32)).to(dev)
    return BlockedCSC(
        rows=torch.from_numpy(np.array(rows, np.int32)).to(dev),
        vals=tv.to(torch.bfloat16) if bf16 else tv, n=int(n), d=int(d),
        block=int(block))


def problem_from_numpy(A, y, lam, loss, scales=None, *,
                       device="cuda") -> Problem:
    """The port's ``Problem`` from the arrays of a JAX ``Problem`` (as
    numpy; ``A`` dense, or a port ``BlockedCSC`` from ``bcsc_from_numpy``).
    Nothing is renormalized, so both packages solve the identical
    problem."""
    dev = resolve_device(device)
    if loss == obj.LOGISTIC:
        obj.check_logistic_labels(y)
    f32 = dict(dtype=torch.float32, device=dev)
    return Problem(
        A=(A.to(dev) if isinstance(A, BlockedCSC)
           else torch.tensor(np.asarray(A, np.float32), **f32)),
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


def slot_arrays_from_numpy(meta_tuple, stacked_numpy, *, device="cuda"):
    """The port's ``(BatchMeta, SlotArrays)`` from the JAX package's
    normalized, stacked ``SlotArrays`` (as numpy, fields in order; unused
    fields None) and its ``BatchMeta`` (as a tuple), so both packages'
    ``launch_rounds`` can run on the identical stacked state.  BlockedCSC
    stacks get their scatter order and range-start tables built on the
    device."""
    from repro_torch.core.batched import BatchMeta, SlotArrays
    from repro_torch.kernels.batched import (stacked_range_starts,
                                             stacked_scatter_order)
    dev = resolve_device(device)
    meta = BatchMeta(*meta_tuple)

    def tensor(a, dtype):
        return None if a is None else torch.tensor(np.asarray(a, dtype),
                                                   device=dev)

    A, rows, vals, y, mask, lam, beta = stacked_numpy
    rows, vals = tensor(rows, np.int32), tensor(vals, np.float32)
    order = None if rows is None else stacked_scatter_order(rows, vals)
    return meta, SlotArrays(
        A=tensor(A, np.float32), rows=rows, vals=vals,
        y=tensor(y, np.float32), mask=tensor(mask, np.float32),
        lam=tensor(lam, np.float32), beta=tensor(beta, np.float32),
        order=order, rstart=None if rows is None else stacked_range_starts(
            rows, order, meta.n_pad))
