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


def _lm_leaf_paths(tree, prefix=""):
    """(path, tensor) of every leaf of a port parameter (sub)tree outside
    its lists of layers, paths ``/``-joined in the reference's spelling."""
    for k in sorted(tree):
        v, path = tree[k], f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _lm_leaf_paths(v, path + "/")
        elif not isinstance(v, list):
            yield path, v


def _lm_layout(cfg):
    """{reference path: (port leaves it maps to, stacked shape)} for
    ``cfg``.  A port leaf is (list path, layer, sub-path), list path None
    for a leaf outside the layer lists.  A ``blocks/l{i}/…`` path carries
    the group axis and maps to layers i, i + P, i + 2P, … of the port's
    ``blocks`` list (P = pattern length; an MoE expert leaf keeps its
    expert axis after the group axis); an ``encoder/blocks/…`` path is
    stacked over the encoder's layers."""
    from repro_torch.models import model as M
    meta = M.init(cfg, device="meta")
    layout = {path: ([(None, None, path)], tuple(t.shape))
              for path, t in _lm_leaf_paths(meta)}
    P = len(cfg.pattern)
    stacks = [(f"blocks/l{i}/", "blocks", range(i, cfg.num_layers, P))
              for i in range(P)]
    if cfg.is_encdec:
        stacks.append(("encoder/blocks/", "encoder/blocks",
                       range(cfg.encoder_layers)))
    for prefix, seq, layers in stacks:
        for sub, t in _lm_leaf_paths(_get(meta, seq)[layers[0]]):
            layout[prefix + sub] = ([(seq, layer, sub) for layer in layers],
                                    (len(layers),) + tuple(t.shape))
    return layout


def _put(tree, path, value):
    *dirs, leaf = path.split("/")
    for d in dirs:
        tree = tree.setdefault(d, {})
    tree[leaf] = value


def _get(tree, path):
    for d in path.split("/"):
        tree = tree[d]
    return tree


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
    for path, (dests, shape) in layout.items():
        arr = np.asarray(flat[path])
        if arr.shape != shape:
            raise ValueError(f"{cfg.name}: {path} has shape {arr.shape}, "
                             f"expected {shape}")
        bf16 = arr.dtype.name == "bfloat16"
        t = torch.from_numpy(np.array(arr, np.float32)).to(dev)
        t = t.to(torch.bfloat16) if bf16 else t
        for group, (seq, layer, sub) in enumerate(dests):
            if seq is None:
                _put(params, sub, t)
            else:
                _put(_get(params, seq)[layer], sub, t[group])
    return params


def lm_params_to_numpy(cfg, params):
    """Inverse of ``lm_params_from_numpy``: the reference's flat
    ``/``-joined paths to numpy arrays (float32; bf16 leaves as float32
    arrays of their values), the blocks stacked over groups."""
    flat = {}
    for path, (dests, _) in _lm_layout(cfg).items():
        ts = [(_get(params, sub) if seq is None
               else _get(_get(params, seq)[layer], sub))
              for seq, layer, sub in dests]
        arrs = [t.detach().float().cpu().numpy() for t in ts]
        flat[path] = arrs[0] if dests[0][0] is None else np.stack(arrs)
    return flat
