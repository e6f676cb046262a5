"""Overflow segments the profiled calls' launches covered (the port's
``solver.overflow_segments``: each round's drawn blocks' segments, summed
on the device), a solve.  None where the program has no such counter."""


def read(rec):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    n = obs.totals()["counters"].get("solver.overflow_segments")
    if rec.trace is None or n is None or not rec.trace_solves:
        return None
    return n / rec.trace_solves
