"""The port's spans and counters: one process-wide tally, recorded only
while a ``torch.profiler`` (or ``emit_nvtx``) session records.

``span(name, rid=None)``  a context manager around a piece of host work.
                          With no profiler recording it checks the
                          profiler's own enabled flag once and does nothing
                          else (no allocation, no ``record_function``).
                          While one records it enters
                          ``torch.profiler.record_function(name)``, so the
                          span lies in the profiler's timeline on the clock
                          of the device records, and keeps (name, parent,
                          request id, start, end) on ``time.perf_counter_ns``.
``count(name, n)``        adds ``n`` to a counter, only while a profiler
                          records; a device tensor ``n`` is kept as it is
                          and read by ``totals()``, so counting what lies
                          on the device makes no host wait.
``totals()``              each span name's calls, inclusive seconds and
                          self seconds (inclusive less its children's), the
                          counters, and how many span records the cap
                          dropped.
``spans()``               the kept span records, in start order.
``reset()``               clears the tally.

The tally is per process and is never cleared by a profiler session: a
reader that wants one session's numbers calls ``reset()`` before it (the
benchmark's ``bench/run.py`` runs one cell per process, so its traced
window is the only session there).  Span names are fixed strings, so
aggregates over a trace add like with like.  A span whose name constant
ends in ``_RANGE`` marks a window that holds no host read by design, as
``record_function(<NAME>_RANGE)`` does, and lint rule SL001 checks its
source.  The spans assume one thread drives the port, as the solver and
the service do.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import torch

SPAN_CAP = 1 << 16          # span records kept; totals count past it

_enabled = torch._C._autograd._profiler_enabled
_clock = time.perf_counter_ns


class SpanRecord(NamedTuple):
    name: str
    parent: int             # index of the enclosing record, -1 at the top
    rid: object             # the request id, or None
    start_ns: int
    end_ns: int


class _Open:
    """A span being recorded."""
    __slots__ = ("name", "rid", "rf", "index", "parent", "t0", "child_ns")

    def __init__(self, name: str, rid):
        self.name, self.rid = name, rid

    def __enter__(self):
        global _dropped
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.parent = _stack[-1].index if _stack else -1
        if len(_records) < SPAN_CAP:
            self.index = len(_records)
            _records.append(None)
        else:
            self.index = -1
            _dropped += 1
        _stack.append(self)
        self.child_ns = 0
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        t1 = _clock()
        dt = t1 - self.t0
        if _stack and _stack[-1] is self:
            _stack.pop()
        if _stack:
            _stack[-1].child_ns += dt
        agg = _spans.get(self.name)
        if agg is None:
            agg = _spans[self.name] = [0, 0, 0]
        agg[0] += 1
        agg[1] += dt
        agg[2] += dt - self.child_ns
        if self.index >= 0:
            _records[self.index] = SpanRecord(self.name, self.parent,
                                              self.rid, self.t0, t1)
        self.rf.__exit__(*exc)
        return False


class _Off:
    """The span of a process no profiler records: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_stack: list[_Open] = []
_records: list = []
_spans: dict[str, list[int]] = {}    # name -> [calls, inclusive, self] ns
_counters: dict[str, int] = {}
_pending: dict[str, list] = {}       # name -> device tensors not read yet
_dropped = 0


def enabled() -> bool:
    """Whether a profiler records (the flag every span checks)."""
    return _enabled()


def span(name: str, rid=None):
    """A span named ``name`` (for one request ``rid``)."""
    if not _enabled():
        return _OFF
    return _Open(name, rid)


def count(name: str, n) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records; a
    tensor ``n`` is read only by ``totals()``."""
    if not _enabled():
        return
    if isinstance(n, torch.Tensor):
        _pending.setdefault(name, []).append(n)
    else:
        _counters[name] = _counters.get(name, 0) + int(n)


def nbytes(*arrays) -> int:
    """Bytes of ``arrays`` (tensors, numpy arrays, tuples of them; None
    counts 0)."""
    total = 0
    for a in arrays:
        if a is None:
            continue
        if isinstance(a, tuple):
            total += nbytes(*a)
        else:
            total += a.nbytes
    return total


def totals() -> dict:
    """{"spans": {name: {"calls", "seconds", "self_seconds"}},
    "counters": {name: n}, "dropped": records the cap dropped}.  Reads
    the counters' device tensors (a host wait where there are any)."""
    counters = dict(_counters)
    for k, ts in _pending.items():
        counters[k] = counters.get(k, 0) + int(torch.stack(ts).sum())
    return {"spans": {k: {"calls": c, "seconds": t / 1e9,
                          "self_seconds": s / 1e9}
                      for k, (c, t, s) in _spans.items()},
            "counters": counters, "dropped": _dropped}


def spans() -> list[SpanRecord]:
    """The kept span records in start order (those still open are left
    out)."""
    return [r for r in _records if r is not None]


def reset() -> None:
    """Clear every span, record and counter."""
    global _dropped
    _stack.clear()
    _records.clear()
    _spans.clear()
    _counters.clear()
    _pending.clear()
    _dropped = 0
