"""Proximal-L1 operators (port of ``repro.optim.prox``) — the paper's
objective as a first-class training feature (DESIGN §6.2): sparse
fine-tuning / sparse readout heads via the shrink operator, over the
port's parameter trees (``repro_torch.tree``)."""
from __future__ import annotations

import torch

from repro_torch import tree as T
# sign(x)·max(|x| − t, 0): the solvers' NaN-preserving form, the
# reference's values
from repro_torch.core.objectives import soft_threshold  # noqa: F401


def prox_l1(params, lr, lam, mask_tree=None):
    """The L1 prox of (a masked subset of) a parameter tree after a
    gradient step, in float32, each leaf cast back to its dtype; where
    ``mask_tree`` (a tree of bool tensors of the same structure) is False
    the leaf keeps its value."""
    def one(p, m=None):
        p32 = p.float()
        s = soft_threshold(p32, lr * lam)
        if m is not None:
            s = torch.where(m, s, p32)
        return s.to(p.dtype)
    if mask_tree is None:
        return T.map_tree(one, params)
    return T.map_tree(one, params, mask_tree)


def l1_penalty(params):
    """Σ |p| over every leaf, in float32 (a 0-d tensor)."""
    return sum(p.float().abs().sum() for p in T.leaves(params))


def sparsity(params):
    """The share of nonzero entries over every leaf (a 0-d tensor)."""
    ps = T.leaves(params)
    nz = sum(torch.count_nonzero(p) for p in ps)
    return nz / sum(p.numel() for p in ps)
