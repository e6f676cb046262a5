"""Process groups for the port's command-line checks: one rank in this
process, or N gloo ranks spawned as child processes on the CPU.

Nothing on a machine tells a program of a cluster, so both give
``torch.distributed`` its store (a ``FileStore`` in a temporary
directory), world size and rank themselves.  NCCL refuses two ranks on one
card, so a one-card run is one NCCL rank; several ranks on one host are
gloo ranks on the CPU.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import pathlib
import subprocess
import sys
import tempfile

import torch.distributed as dist

SRC = pathlib.Path(__file__).resolve().parents[2]   # the port's src/


@contextlib.contextmanager
def one_rank(backend: str, timeout_s: float = 300.0):
    """A process group of this process alone for the ``with`` block."""
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized in "
                           "this process")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            yield
        finally:
            dist.destroy_process_group()


def join_group(rank: int, world: int, store: str,
               timeout_s: float = 300.0) -> None:
    """Join the gloo group of ``spawn``'s children (call in each child)."""
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))


def spawn(entry: str, world: int, *args: str,
          timeout_s: float = 600.0) -> list[str]:
    """Run ``entry`` ("package.module:function") as ``world`` child
    processes, child r calling ``function(r, world, store, *args)`` with
    ``store`` a fresh ``FileStore`` path for ``join_group``; see
    ``spawn_code``."""
    module, func = entry.split(":")
    code = (f"import sys; from {module} import {func}; "
            f"{func}(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:])")
    return spawn_code(code, world, *args, timeout_s=timeout_s, name=entry)


def spawn_code(code: str, world: int, *args: str, timeout_s: float = 600.0,
               name: str = "python -c") -> list[str]:
    """Run the Python source ``code`` as ``world`` child processes with
    ``sys.argv[1:]`` = (rank, world, store, *args), ``store`` a fresh
    ``FileStore`` path; return each child's output (stdout and stderr) in
    rank order.  Raises when a child fails or outlives ``timeout_s``; no
    child is left running."""
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [str(SRC)] + ([os.environ["PYTHONPATH"]]
                             if os.environ.get("PYTHONPATH") else []))}
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-c", code, str(r), str(world), store, *args],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout_s)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {world} ({name}) exited "
                               f"{p.returncode}:\n{out[-4000:]}")
    return outs
