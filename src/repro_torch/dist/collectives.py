"""The collectives of the Δz merge on ``torch.distributed`` (port of
``repro.dist.collectives``, DESIGN §7).

Every collective of the sharded driver goes through ``host_hop``: with
NCCL the tensors stay on the card; a gloo group takes host memory only,
so card tensors are copied to the host and back there — the one place the
wire leaves the card.  (NCCL refuses two ranks on one device, so a
one-card multi-rank run uses gloo.)

``hierarchical_psum`` on an (outer, inner) layout of the ranks does

    reduce-scatter over the inner group
    -> all-reduce of the 1/inner slice over the outer group
    -> all-gather back over the inner group

so the slow outer hop carries 1/inner of the bytes.  Dim 0 of the operand
must be divisible by the inner size.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

# all_gather_single / reduce_scatter_single where this torch has them (the
# *_tensor names are deprecated there); the same arguments either way.
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def host_hop(fn, out: torch.Tensor, *inputs: torch.Tensor, group=None,
             async_op: bool = False):
    """Run the collective ``fn(out, *inputs, group=..)`` and return ``out``
    (with ``async_op``, a handle whose ``wait()`` returns it).  For a gloo
    group and card tensors the collective runs on host copies and the
    result is copied back into ``out``."""
    if out.is_cuda and dist.get_backend(group) == "gloo":
        h_out = out.cpu()                     # a copy: fn may work in place
        work = fn(h_out, *[t.cpu() for t in inputs], group=group,
                  async_op=async_op)

        def finish():
            if work is not None:
                work.wait()
            return out.copy_(h_out)
    else:
        work = fn(out, *inputs, group=group, async_op=async_op)

        def finish():
            if work is not None:
                work.wait()
            return out
    return Pending(finish) if async_op else finish()


class Pending:
    """A started collective; ``wait()`` returns its result."""

    def __init__(self, finish):
        self._finish = finish

    def wait(self) -> torch.Tensor:
        return self._finish()


def ready(t: torch.Tensor) -> Pending:
    """A finished result in the shape of a started collective."""
    return Pending(lambda: t)


def _all_reduce(t, *, group, async_op):
    return dist.all_reduce(t, group=group, async_op=async_op)


def all_reduce(x: torch.Tensor, group=None, async_op: bool = False):
    """Sum of ``x`` over the group (a new tensor; ``x`` is untouched)."""
    return host_hop(_all_reduce, x.clone(), group=group, async_op=async_op)


def reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's 1/size slice (dim 0) of the group sum of ``x``."""
    size = dist.get_world_size(group)
    out = torch.empty((x.shape[0] // size,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    return host_hop(_reduce_scatter, out, x.contiguous(), group=group)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """The group ranks' ``x`` concatenated on dim 0, in group-rank order."""
    size = dist.get_world_size(group)
    out = torch.empty((x.shape[0] * size,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    return host_hop(_all_gather, out, x.contiguous(), group=group)


def hierarchical_psum(x: torch.Tensor, outer, inner) -> torch.Tensor:
    """Group sum over outer × inner as reduce-scatter(inner) →
    all-reduce(outer) → all-gather(inner)."""
    return all_gather(all_reduce(reduce_scatter(x, inner), outer), inner)


def hierarchical_faulty_psum(x: torch.Tensor, seed: int, me: int, plan,
                             outer, inner):
    """``hierarchical_psum`` with the outer hop through
    ``dist.faults.faulty_psum`` (DESIGN §9.3): injection and the
    checksummed bounded re-merge happen on the 1/inner slice, on the link
    that real fleets drop and corrupt.  The inner reduce-scatter and
    all-gather are assumed reliable.  Returns ``(x_global, health)``;
    health is per rank — combine it over all ranks before any replicated
    decision."""
    from repro_torch.dist.faults import faulty_psum
    part, health = faulty_psum(reduce_scatter(x, inner), seed, me, plan,
                               outer)
    return all_gather(part, inner), health
