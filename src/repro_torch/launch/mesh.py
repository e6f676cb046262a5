"""Device meshes (port of ``repro.launch.mesh``), over the process group
this process belongs to.

Single pod: 256 ranks as (data=16, model=16).
Multi-pod:  512 ranks as (pod=2, data=16, model=16) — 'pod' is pure data
parallelism (+ ZeRO sharding of params and optimizer state across it when
fsdp is on).

Each function needs an initialized process group of the mesh's size
(``torch.distributed.init_process_group``: nothing on a machine tells a
program of a cluster).  The production meshes are built only on the
dry-run's fake process group (``launch.dryrun``).  Meshes are on the card
(``"cuda"``) unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_mesh(shape, axes, *, device="cuda"):
    """A mesh of any (shape, axes) over all ranks of the process group."""
    shape, axes = tuple(shape), tuple(axes)
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs an initialized process group of {n} "
            "ranks (torch.distributed.init_process_group); none is")
    if dist.get_world_size() != n:
        raise RuntimeError(f"a {shape} mesh needs a process group of {n} "
                           f"ranks; this one has {dist.get_world_size()}")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=axes)


def make_host_mesh(data: int | None = None, model: int = 1, *,
                   device="cuda"):
    """(data, model) over every rank of the process group (``data``
    defaults to all the ranks ``model`` leaves)."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialized process "
                           "group (torch.distributed.init_process_group)")
    data = dist.get_world_size() // model if data is None else data
    return make_mesh((data, model), ("data", "model"), device=device)
