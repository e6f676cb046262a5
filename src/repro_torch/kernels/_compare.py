"""What the parent-versus-change tools (``compare_pair``, ``compare_fused``)
share: an earlier ``csrc/`` built and loaded, bit comparisons, the
clocks (events over back-to-back calls, the profiler's device records,
events behind a spin kernel) and the turns old, new, new, old."""
from __future__ import annotations

import contextlib
import ctypes
import pathlib
import sys
import time

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
    the same C interface for the entries they call).  What the wrappers
    ask of ``shotgun_block._lib()`` (the grid size behind the overflow
    launch's counters) stays with this package's build."""
    from repro_torch.kernels import shotgun_block as sb
    sb._lib()
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


def _device_records(fn, calls: int, kernels: tuple[str, ...]) -> list[float]:
    """Durations (µs) of the device records of ``calls`` calls of ``fn`` in
    one profiled window: every device op, or only the kernels whose names
    hold one of ``kernels``.  The window opens and closes on an idle card
    with a few ms to spare on each side, so that no record falls outside
    it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.005)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.005)
    return [e.time_range.end - e.time_range.start for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and (not kernels or any(k in e.name for k in kernels))]


def records_per_call(fn) -> int:
    """Device records (kernels, memsets, copies) of one call of ``fn``,
    after a warm-up call."""
    fn()
    return len(_device_records(fn, 1, ()))


def device_ms(fn, iters: int, kernels: tuple[str, ...] = (),
              per_call: int | None = None, tries: int = 3) -> float | None:
    """Device time per call from the profiler's records of ``iters`` calls
    of ``fn`` (every device op, or only the named ``kernels``).  A window
    must hold ``per_call`` records a call — as given, or as one profiled
    call holds — or it is measured again, up to ``tries`` times, each short
    window reported on stderr: the profiler has returned fewer records than
    launches.  When every window came back short, a given ``per_call``
    (launches of the named kernels, alike in shape) takes the mean of the
    records that came back times ``per_call``, and a measured one gives
    None.  A short window is never summed as if it were whole."""
    fn()
    got: list[float] = []
    for t in range(tries):
        per = (len(_device_records(fn, 1, kernels)) if per_call is None
               else per_call)
        got = _device_records(fn, iters, kernels)
        if per and len(got) == per * iters:
            return sum(got) / iters / 1e3
        print(f"device_ms: {len(got)} device records in a window of {iters}"
              f" calls of {per} each (try {t + 1} of {tries})",
              file=sys.stderr)
    if per_call is None or not got:
        return None
    print(f"device_ms: the mean of the {len(got)} records that came back",
          file=sys.stderr)
    return sum(got) / len(got) * per_call / 1e3


def queued_ms(fn, iters: int) -> float:
    """Device time per call from CUDA events recorded around each of
    ``iters`` calls of ``fn``, enqueued behind a spin kernel
    (``torch.cuda._sleep``) that outlasts the host's enqueue of them all:
    the card runs the calls back to back and never waits on the host
    inside a pair of events, so the host's enqueue time is left out.  The
    spin doubles until an event recorded after it is still pending when
    the last call has been enqueued.  Counts every device op of a call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(4 * host * 2e9) + 2_000_000
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    gate = torch.cuda.Event()
    for _ in range(8):
        torch.cuda._sleep(cycles)
        gate.record()
        for a, b in pairs:
            a.record()
            fn()
            b.record()
        hidden = not gate.query()
        torch.cuda.synchronize()
        if hidden:
            return sum(a.elapsed_time(b) for a, b in pairs) / iters
        cycles *= 2
    raise RuntimeError("queued_ms: the host's enqueue outlasted every spin")


def turns(old, new, *clocks) -> list[tuple]:
    """(label, clock(f) for each clock) for f in old, new, new, old."""
    return [(label, *(c(f) for c in clocks))
            for label, f in (("old", old), ("new", new), ("new", new),
                             ("old", old))]
