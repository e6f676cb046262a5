"""Atomic checkpoints of global arrays (port of ``repro.ckpt.checkpoint``).

Layout on disk:

    <dir>/step_<k>/
        manifest.json      per-leaf global shape/dtype, step
        arrays.npz         one entry per leaf (global values)
    <dir>/LATEST           text file naming the newest complete step dir

Writes are atomic: everything lands in ``step_<k>.tmp`` and is renamed
only after the npz and the manifest are flushed; a crash mid-write leaves
the previous checkpoint untouched, and a half-written step is ignored.
A checkpoint holds global values (the sharded driver's rank 0 writes the
gathered arrays), so it restores onto any number of ranks.

A tree is any ``repro_torch.tree``: nested dicts, lists, tuples and
NamedTuples (a ``TrainState`` with its optimizer state); a leaf's npz key
is its path joined by ``|``, and ``restore`` walks its template, so lists
and NamedTuples come back as they went in.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.device import resolve_device

LATEST = "LATEST"
SEP = "|"  # path-key separator inside the npz


def _flatten(tree) -> dict:
    """{"a|0|b": leaf} of every leaf of ``tree``, in ``tree.items`` order."""
    return {SEP.join(str(k) for k in path): leaf
            for path, leaf in T.items(tree)}


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir, step: int, tree, *, keep: int = 3) -> pathlib.Path:
    """Atomically save the tree of arrays ``tree`` as step ``step``; prune
    to the ``keep`` newest steps."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:012d}"
    tmp = ckpt_dir / f"step_{step:012d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    arrays = {k: _numpy(v) for k, v in _flatten(tree).items()}
    with open(tmp / "arrays.npz", "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    manifest = {"step": step, "leaves": {
        k: {"shape": list(a.shape), "dtype": str(a.dtype)}
        for k, a in arrays.items()}}
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())

    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                     # atomic publish
    (ckpt_dir / LATEST).write_text(final.name)

    for s in all_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s:012d}", ignore_errors=True)
    return final


def all_steps(ckpt_dir) -> list[int]:
    """Complete steps (a published manifest), ascending."""
    out = []
    for p in pathlib.Path(ckpt_dir).glob("step_*"):
        if p.suffix == ".tmp" or not (p / "manifest.json").exists():
            continue
        out.append(int(p.name.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir, template, *, step: int | None = None,
            device="cuda"):
    """Restore into the structure of ``template`` (a tree whose leaves have
    ``.shape`` and ``.dtype``: tensors — meta tensors too —, or numpy
    arrays), as torch tensors of the template's dtypes on ``device`` (the
    card unless the caller asks for the CPU; raises without a card).

    Returns (step, tree).  Raises FileNotFoundError without a checkpoint,
    KeyError for a missing leaf and ValueError for a shape mismatch."""
    device = resolve_device(device)
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = ckpt_dir / f"step_{step:012d}"
    manifest = json.loads((path / "manifest.json").read_text())
    out = []
    with np.load(path / "arrays.npz") as data:
        for key, leaf in _flatten(template).items():
            if key not in data:
                raise KeyError(f"checkpoint {path} missing leaf {key}")
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                                 f"template {tuple(leaf.shape)}")
            t = torch.from_numpy(np.array(arr))
            dtype = (leaf.dtype if isinstance(leaf.dtype, torch.dtype)
                     else torch.from_numpy(np.zeros(0, leaf.dtype)).dtype)
            out.append(t.to(device=device, dtype=dtype))
    return manifest["step"], T.unflatten(template, out)
