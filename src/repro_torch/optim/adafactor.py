"""Adafactor (Shazeer & Stern 2018; port of ``repro.optim.adafactor``) —
factored second moment, no momentum.  Used by the ≥ 50B configurations,
whose AdamW state would not fit (DESIGN §5).

**The reference's stacked layout.**  The reference holds each decoder
parameter stacked over the groups of its layer pattern (``blocks/l{i}/…``
with a leading group axis; ``encoder/blocks/…`` over the encoder's layers),
and its Adafactor sees the stacked leaf: a leaf is factored when the
*stacked* leaf has ≥ 2 dims, so a per-layer norm scale or bias, (G, d)
there, is factored — its row statistics ``vr`` are (G,), its column
statistics ``vc`` (d,) are a mean over the layers — and the update's RMS
clip runs over the whole stacked leaf, all G layers at once.  The port
holds one dict per layer, so it keeps the state in the reference's layout,
keyed by reference path, and computes the statistics from the per-layer
grads with the reference's semantics: ``stacks`` (for an LM,
``models.model.ref_layout(cfg)``) names the port leaves each reference
leaf stacks.  A leaf of ≤ 1 dim per layer is stacked (it is small) and
updated as the reference updates it; a larger one is updated layer by
layer in place, its RMS clip in two passes (the sum of u² over the layers,
then the scaled update).  Without ``stacks`` every leaf stands alone,
keyed by its ``/``-joined tree path.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import tree as T
from repro_torch.models import sharding as SH
from repro_torch.optim.adamw import clip_by_global_norm


class AdafactorState(NamedTuple):
    vr: dict      # row statistics  (shape[:-1])   for ndim >= 2 leaves
    vc: dict      # col statistics  (shape[:-2] + shape[-1:])
    v: dict       # full statistics for ndim < 2 leaves
    count: torch.Tensor


def layout(params, stacks=None) -> list:
    """[(key, stacked, leaf indices into ``tree.leaves(params)``)]: the
    reference leaves of ``stacks`` ({key: (stacked, tree paths)}), or one
    entry a leaf without it."""
    index = {path: i for i, (path, _) in enumerate(T.items(params))}
    if stacks is None:
        return [("/".join(str(k) for k in path), False, [i])
                for path, i in index.items()]
    out = [(key, stacked, [index[p] for p in paths])
           for key, (stacked, paths) in stacks.items()]
    used = sorted(i for _, _, ids in out for i in ids)
    if used != list(range(len(index))):
        raise ValueError(f"stacks cover leaves {used}, the tree has "
                         f"{len(index)}")
    return out


def _shape(leaves, stacked, ids):
    shape = tuple(leaves[ids[0]].shape)
    return ((len(ids),) + shape) if stacked else shape


def _factored(shape) -> bool:
    return len(shape) >= 2


def init(params, stacks=None) -> AdafactorState:
    """Zero statistics in the reference's shapes, keyed as ``layout``
    keys them (on the parameters' device; meta tensors give a template)."""
    leaves = T.leaves(params)
    dev = leaves[0].device
    vr, vc, v = {}, {}, {}
    one = lambda: torch.zeros((1,), dtype=torch.float32,  # noqa: E731
                              device=dev)
    for key, stacked, ids in layout(params, stacks):
        s = _shape(leaves, stacked, ids)
        f32 = dict(dtype=torch.float32, device=dev)
        if _factored(s):
            vr[key] = torch.zeros(s[:-1], **f32)
            vc[key] = torch.zeros(s[:-2] + s[-1:], **f32)
            v[key] = one()
        else:
            vr[key], vc[key], v[key] = one(), one(), torch.zeros(s, **f32)
    return AdafactorState(vr=vr, vc=vc, v=v,
                          count=torch.zeros((), dtype=torch.int32,
                                            device=dev))


def _precondition(g, vr, vc, v, factored, decay, eps):
    """The reference's statistics update on the float32 grad ``g`` of one
    (stacked or single) leaf, in place on ``vr``/``vc``/``v``; returns
    u = g / √(statistics)."""
    g2 = g * g + eps
    if factored:
        vr.mul_(decay).add_((1 - decay) * g2.mean(-1))
        vc.mul_(decay).add_((1 - decay) * g2.mean(-2))
        r = vr / torch.clamp(vr.mean(-1, keepdim=True), min=eps)
        return g / torch.sqrt(r[..., None]) / torch.sqrt(vc[..., None, :])
    v.mul_(decay).add_((1 - decay) * g2)
    return g / torch.sqrt(v)


def _step(p, u, lr):
    if p.dtype == torch.float32:
        p.sub_(u.mul_(lr))
    else:
        p.copy_(p.float() - u.mul_(lr))


def apply(grads: list, state: AdafactorState, params: list, lr, *, groups,
          decay=0.99, eps=1e-30, clip_threshold=1.0, max_grad_norm=1.0):
    """``update`` on flat lists in ``tree.leaves(params)`` order, the
    reference leaves given by ``groups`` (``layout`` of the parameter
    tree): the float32 ``grads`` are clipped in place and each entry is
    set to None once its leaf is updated; ``params`` and the statistics
    are updated in place.  Returns (AdafactorState with the new count, the
    grads' global norm before clipping)."""
    _, gnorm = clip_by_global_norm(grads, max_grad_norm)
    count = state.count + 1
    with torch.no_grad():
        for key, stacked, ids in groups:
            vr, vc, v = state.vr[key], state.vc[key], state.v[key]
            if not stacked or params[ids[0]].dim() <= 1:
                # the reference's computation on the (stacked) leaf
                g = (torch.stack([grads[i].float() for i in ids])
                     if stacked else grads[ids[0]].float())
                u = _precondition(g, vr, vc, v, _factored(g.shape), decay,
                                  eps)
                rms = torch.sqrt(torch.mean(u * u))
                u = u / torch.clamp(rms / clip_threshold, min=1.0)
                for j, i in enumerate(ids):
                    _step(params[i], u[j] if stacked else u, lr)
                    grads[i] = None
                continue
            # a stacked leaf of >= 2 dims a layer: every statistic is the
            # layer's own, only the RMS clip spans the layers — u in place
            # of each grad, then the clipped update
            sq = torch.zeros((), dtype=torch.float32, device=vr.device)
            for j, i in enumerate(ids):
                u = _precondition(grads[i].float(), vr[j], vc[j], None,
                                  True, decay, eps)
                sq = sq + SH.sum_squares(u)
                grads[i] = u
            n = len(ids) * params[ids[0]].numel()
            den = torch.clamp(torch.sqrt(sq / n) / clip_threshold, min=1.0)
            for i in ids:
                _step(params[i], grads[i].div_(den), lr)
                grads[i] = None
    return AdafactorState(state.vr, state.vc, state.v, count), gnorm


def update(grads, state: AdafactorState, params, lr, *, stacks=None, **kw):
    """The reference's ``update`` over trees: (params, state, grad norm),
    with ``params``, the statistics and the grads updated in place."""
    new_state, gnorm = apply(T.leaves(grads), state, T.leaves(params), lr,
                             groups=layout(params, stacks), **kw)
    return params, new_state, gnorm
