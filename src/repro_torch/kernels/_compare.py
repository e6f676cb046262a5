"""What the parent-versus-change tools (``compare_pair``, ``compare_fused``)
share: an earlier ``csrc/`` built and loaded, bit comparisons, the two
clocks and the turns old, new, new, old."""
from __future__ import annotations

import contextlib
import ctypes
import pathlib

import torch

from repro_torch.kernels import _build


def build_old(csrc: pathlib.Path, work: pathlib.Path,
              argtypes: dict) -> ctypes.CDLL:
    """The library of ``csrc`` built with ``_build``'s flags into ``work``
    and loaded, with ``argtypes`` (entry -> ctypes argument list) set and
    every entry returning int."""
    lib_path = work / "libold.so"
    _build.compile_library(csrc, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, types in argtypes.items():
        getattr(lib, name).argtypes = types
        getattr(lib, name).restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def library(lib: ctypes.CDLL):
    """Route the wrappers' launches through ``lib`` (an earlier build with
    the same C interface for the entries they call)."""
    saved = _build.load()
    _build._lib = lib
    try:
        yield
    finally:
        _build._lib = saved


def bit_compare(a: torch.Tensor, b: torch.Tensor) -> dict:
    """Counts of f32 elements equal in bits, equal but for the sign of a
    zero, and otherwise different."""
    ai, bi = a.view(torch.int32), b.view(torch.int32)
    same = ai == bi
    zero_sign = ~same & (a == 0) & (b == 0)
    return dict(n=a.numel(), bitwise=int(same.sum()),
                zero_sign=int(zero_sign.sum()),
                other=int((~same & ~zero_sign).sum()))


def bits_equal(got, want) -> bool:
    """Every output tensor of two tuples equal in its bit pattern."""
    for g, w in zip(got, want, strict=True):
        g, w = g.contiguous(), w.contiguous()
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        if g.shape != w.shape or not torch.equal(g, w):
            return False
    return True


def events_ms(fn, iters: int) -> float:
    """CUDA events over ``iters`` back-to-back calls, per call."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, kernels: tuple[str, ...] = ()) -> float | None:
    """Device time per call in a profiled window of ``iters`` calls of
    ``fn``: every device op, or only the kernels whose names hold one of
    ``kernels``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.time_range.end - e.time_range.start for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and (not kernels or any(k in e.name for k in kernels)))
    return total / iters / 1e3 if total else None


def turns(old, new, *clocks) -> list[tuple]:
    """(label, clock(f) for each clock) for f in old, new, new, old."""
    return [(label, *(c(f) for c in clocks))
            for label, f in (("old", old), ("new", new), ("new", new),
                             ("old", old))]
