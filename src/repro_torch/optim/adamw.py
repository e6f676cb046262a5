"""AdamW with global-norm clipping (port of ``repro.optim.adamw``), over
the port's parameter trees (``repro_torch.tree``): the state's ``mu`` and
``nu`` mirror the parameter tree.

The reference's formula as it stands — not ``torch.optim.AdamW``, which
decays the weights and adds eps elsewhere, and not
``torch.nn.utils.clip_grad_norm_``, which divides by norm + 1e-6:

    g  <- g · min(1, max_norm / max(‖g‖, 1e-9))        (global norm)
    m  <- b1·m + (1 − b1)·g ;  v <- b2·v + (1 − b2)·g·g
    p  <- p − lr·((m / c1) / (√(v / c2) + eps) + wd·p)
    c1 = 1 − b1^count, c2 = 1 − b2^count               (float32, on the
                                                       device)

Memory: full-width parameters, grads and both moments fill most of a card,
so the update works in place — the grads are clipped in place, then each
leaf is updated on its own with at most two temporaries of its size, and
``apply`` releases each grad as soon as its leaf is done.  Nothing is read
to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import tree as T
from repro_torch.models import sharding as SH


class AdamWState(NamedTuple):
    mu: dict
    nu: dict
    count: torch.Tensor


def init(params) -> AdamWState:
    """Zero float32 moments shaped like ``params`` (on their devices; meta
    tensors give a template) and a 0-d int32 count."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    dev = T.leaves(params)[0].device
    return AdamWState(mu=T.map_tree(zeros, params),
                      nu=T.map_tree(zeros, params),
                      count=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(grads):
    """√(Σ ⟨g, g⟩) over the leaves (a list or a tree), in float32."""
    gs = T.leaves(grads)
    return torch.sqrt(torch.stack([SH.sum_squares(g) for g in gs]).sum())


def clip_scale(norm, max_norm):
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm):
    """(grads · min(1, max_norm / max(‖grads‖, 1e-9)), ‖grads‖), the grads
    scaled in place (float32 leaves)."""
    norm = global_norm(grads)
    scale = clip_scale(norm, max_norm)
    for g in T.leaves(grads):
        g.mul_(scale)
    return grads, norm


def apply(grads: list, state: AdamWState, params: list, lr, *, b1=0.9,
          b2=0.95, eps=1e-8, weight_decay=0.1, max_grad_norm=1.0):
    """``update`` on flat lists in ``tree.leaves(params)`` order: the
    float32 ``grads`` are clipped in place and each entry is set to None
    once its leaf is updated (the caller's list lets the grads go one by
    one); ``params`` and the moments are updated in place.  Returns
    (AdamWState with the new count, the grads' global norm before
    clipping)."""
    _, gnorm = clip_by_global_norm(grads, max_grad_norm)
    count = state.count + 1
    c1 = 1.0 - b1 ** count.to(torch.float32)
    c2 = 1.0 - b2 ** count.to(torch.float32)
    mus, nus = T.leaves(state.mu), T.leaves(state.nu)
    if not len(grads) == len(params) == len(mus) == len(nus):
        raise ValueError(f"{len(grads)} grads, {len(params)} params, "
                         f"{len(mus)}/{len(nus)} moments")
    with torch.no_grad():
        for i, (p, m, v) in enumerate(zip(params, mus, nus)):
            g = grads[i].float()
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            grads[i] = g = None
            step = m / c1
            step.div_((v / c2).sqrt_().add_(eps))
            step.add_(weight_decay * p.float())
            if p.dtype == torch.float32:
                p.sub_(step.mul_(lr))
            else:
                p.copy_(p.float() - step.mul_(lr))
    return AdamWState(state.mu, state.nu, count), gnorm


def update(grads, state: AdamWState, params, lr, **kw):
    """The reference's ``update`` over trees: (params, state, grad norm),
    with ``params``, the moments and the grads updated in place (the
    returned trees are the ones passed in)."""
    new_state, gnorm = apply(T.leaves(grads), state, T.leaves(params), lr,
                             **kw)
    return params, new_state, gnorm
