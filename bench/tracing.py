"""What the benchmark reads from a ``torch.profiler`` window.

The busy-interval union is a frozen copy of ``busy_of`` in
``chip_smoke.py`` at commit 58376ee: device busy is the union of the
device records' intervals (a ``record_function`` range shows on the device
timeline too, as an annotation, and is not device work), and the idle
share is one minus busy over the span.  Here the span is the harness's
``bench.window`` range, from the first profiled call to the end of the
synchronise after the last.  The host-wait count follows ``SYNC_CALLS`` in
``src/repro_torch/analyze/trace_checks.py`` at the same commit, counted
once a wait: the runtime's blocking calls, and a scalar read
(``aten::_local_scalar_dense``) only where the profiler holds no runtime
wait inside it.
"""
from __future__ import annotations

import bisect
import collections
from typing import NamedTuple

import torch

WINDOW = "bench.window"
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")
SCALAR_READ = "aten::_local_scalar_dense"
TOP = 10
NAME_CHARS = 160


class Summary(NamedTuple):
    """One profiled window: device busy and span seconds, the host waits
    inside the harness's call ranges, the device operations that took most
    time and the longest idle gaps by what the host was doing (each a list
    of [name, seconds])."""
    busy_s: float
    span_s: float
    waits: int
    device_ops: list
    idle_gaps: list


def _is_device(e) -> bool:
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("bench."))


def _is_host(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CPU


def union(spans, lo: float, hi: float) -> list[tuple[float, float]]:
    """The merged intervals of ``spans`` clipped to [lo, hi]."""
    out: list[list[float]] = []
    for a, b in sorted(spans):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def count_waits(host, ranges) -> int:
    """Blocking host waits that start inside any of ``ranges``."""
    waits = sorted(e.time_range.start for e in host if e.name in WAITS)
    reads = [e for e in host if e.name == SCALAR_READ]
    total = 0
    for r in ranges:
        lo = bisect.bisect_left(waits, r.start)
        total += bisect.bisect_right(waits, r.end) - lo
    for e in reads:
        t = e.time_range
        if not any(r.start <= t.start <= r.end for r in ranges):
            continue
        lo = bisect.bisect_left(waits, t.start)
        if lo == len(waits) or waits[lo] > t.end:
            total += 1
    return total


def _host_at(host_sorted, starts, t: float) -> str:
    """The innermost host operation running at time ``t``: the latest
    started of those still open (within the 2,000 before it), else
    "python" (host code the profiler does not record)."""
    i = bisect.bisect_right(starts, t) - 1
    for e in reversed(host_sorted[max(0, i - 2000): i + 1]):
        if e.time_range.end >= t:
            return e.name[:NAME_CHARS]
    return "python"


def summarize(events, range_name: str) -> Summary | None:
    """The profiled window of ``events``; None when it holds no window."""
    windows = [e for e in events if _is_host(e) and e.name == WINDOW]
    if not windows:
        return None
    lo, hi = windows[0].time_range.start, windows[0].time_range.end
    device = [e for e in events if _is_device(e)]
    host = [e for e in events if _is_host(e)
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("bench.")]
    ranges = [e.time_range for e in events
              if _is_host(e) and e.name == range_name]
    busy = union(((e.time_range.start, e.time_range.end) for e in device),
                 lo, hi)
    per_op = collections.Counter()
    for e in device:
        per_op[e.name[:NAME_CHARS]] += (e.time_range.end
                                        - e.time_range.start) / 1e6
    host.sort(key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    gaps = collections.Counter()
    edges = [lo] + [t for ab in busy for t in ab] + [hi]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            gaps[_host_at(host, starts, (a + b) / 2)] += (b - a) / 1e6
    return Summary(
        busy_s=sum(b - a for a, b in busy) / 1e6, span_s=(hi - lo) / 1e6,
        waits=count_waits(host, ranges),
        device_ops=[[k, v] for k, v in per_op.most_common(TOP)],
        idle_gaps=[[k, v] for k, v in gaps.most_common(TOP)])
