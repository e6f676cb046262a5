"""Bytes ``pad_problem`` writes (the padded A and y where it pads, and the
mask) in the profiled calls (the port's ``solver.pad_bytes`` counter), a
solve.  None where the program has no such counter."""


def read(rec):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    n = obs.totals()["counters"].get("solver.pad_bytes")
    if rec.trace is None or n is None or not rec.trace_solves:
        return None
    return n / rec.trace_solves
