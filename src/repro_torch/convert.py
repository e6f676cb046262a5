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


def _lm_layout(cfg):
    """{reference path: (port paths, stacked shape)} for ``cfg``
    (``models.model.ref_layout`` with each reference leaf's shape)."""
    from repro_torch import tree as T
    from repro_torch.models import model as M
    meta = M.init(cfg, device="meta")
    out = {}
    for path, (stacked, dests) in M.ref_layout(cfg).items():
        shape = tuple(T.get(meta, dests[0]).shape)
        out[path] = (dests if stacked else None, ((len(dests),) + shape
                                                  if stacked else shape),
                     dests[0])
    return out


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {}) if isinstance(k, str) else tree[k]
    tree[path[-1]] = value


def lm_params_from_numpy(cfg, flat, *, device="cuda"):
    """The port's LM parameters (``models.model``) from the reference's
    parameter tree as a flat dict of ``/``-joined paths (``embed``,
    ``final_norm/scale``, ``blocks/l0/attn/wq`` with the leading group
    axis, ``encoder/blocks/…`` with the encoder's layer axis, …) to numpy
    arrays, so that both packages compute with the same weights.  bf16
    arrays stay bf16, everything else becomes float32.  Raises
    ``ValueError`` on a missing or unknown path or a wrong shape."""
    dev = resolve_device(device)
    layout = _lm_layout(cfg)
    missing = sorted(set(layout) - set(flat))
    unknown = sorted(set(flat) - set(layout))
    if missing or unknown:
        raise ValueError(f"{cfg.name}: parameter paths missing {missing}, "
                         f"unknown {unknown}")
    params: dict = {"blocks": [{} for _ in range(cfg.num_layers)]}
    if cfg.is_encdec:
        params["encoder"] = {"blocks": [{} for _ in
                                        range(cfg.encoder_layers)]}
    for path, (dests, shape, first) in layout.items():
        arr = np.asarray(flat[path])
        if arr.shape != shape:
            raise ValueError(f"{cfg.name}: {path} has shape {arr.shape}, "
                             f"expected {shape}")
        bf16 = arr.dtype.name == "bfloat16"
        t = torch.from_numpy(np.array(arr, np.float32)).to(dev)
        t = t.to(torch.bfloat16) if bf16 else t
        if dests is None:
            _put(params, first, t)
        for group, dest in enumerate(dests or ()):
            _put(params, dest, t[group])
    return params


def lm_params_to_numpy(cfg, params):
    """Inverse of ``lm_params_from_numpy``: the reference's flat
    ``/``-joined paths to numpy arrays (float32; bf16 leaves as float32
    arrays of their values), the blocks stacked over groups."""
    from repro_torch import tree as T
    flat = {}
    for path, (dests, _, first) in _lm_layout(cfg).items():
        arrs = [T.get(params, d).detach().float().cpu().numpy()
                for d in (dests or [first])]
        flat[path] = arrs[0] if dests is None else np.stack(arrs)
    return flat


def _sub(flat, prefix):
    n = len(prefix)
    return {k[n:]: v for k, v in flat.items() if k.startswith(prefix)}


def train_state_from_numpy(cfg, flat, *, device="cuda"):
    """The port's ``models.steps.TrainState`` from the reference's, as a
    flat dict of ``/``-joined paths to numpy arrays: ``params/…``,
    ``opt/count`` and ``step``, with AdamW's ``opt/mu/…`` and
    ``opt/nu/…`` (the parameters' paths, carried through the same layout
    as the parameters) or Adafactor's ``opt/vr/…``, ``opt/vc/…`` and
    ``opt/v/…`` (kept in the reference's stacked layout, as the port's
    Adafactor keeps them)."""
    from repro_torch.models.steps import TrainState
    from repro_torch.optim.adafactor import AdafactorState
    from repro_torch.optim.adamw import AdamWState
    dev = resolve_device(device)

    def i32(a):
        return torch.tensor(np.asarray(a, np.int32), device=dev)

    params = lm_params_from_numpy(cfg, _sub(flat, "params/"), device=dev)
    count = i32(flat["opt/count"])
    if cfg.optimizer == "adafactor":
        opt = AdafactorState(*[
            {k: torch.tensor(np.asarray(v, np.float32), device=dev)
             for k, v in _sub(flat, f"opt/{name}/").items()}
            for name in ("vr", "vc", "v")], count=count)
    else:
        opt = AdamWState(
            mu=lm_params_from_numpy(cfg, _sub(flat, "opt/mu/"), device=dev),
            nu=lm_params_from_numpy(cfg, _sub(flat, "opt/nu/"), device=dev),
            count=count)
    return TrainState(params=params, opt=opt, step=i32(flat["step"]))


def train_state_to_numpy(cfg, state):
    """Inverse of ``train_state_from_numpy``: the reference's flat paths to
    numpy arrays."""
    flat = {f"params/{k}": v
            for k, v in lm_params_to_numpy(cfg, state.params).items()}
    opt = state.opt
    if cfg.optimizer == "adafactor":
        for name in ("vr", "vc", "v"):
            for k, v in getattr(opt, name).items():
                flat[f"opt/{name}/{k}"] = v.detach().cpu().numpy()
    else:
        for name in ("mu", "nu"):
            for k, v in lm_params_to_numpy(cfg, getattr(opt, name)).items():
                flat[f"opt/{name}/{k}"] = v
    flat["opt/count"] = opt.count.cpu().numpy()
    flat["step"] = state.step.cpu().numpy()
    return flat
