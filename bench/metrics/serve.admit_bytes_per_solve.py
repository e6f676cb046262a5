"""Bytes admission builds and writes (the normalized arrays, x0 and z0,
then their copy into the slot; the port's ``serve.admit_bytes`` counter)
in the profiled jobs, a completed solve.  None where the program has no
such counter."""


def read(rec):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    n = obs.totals()["counters"].get("serve.admit_bytes")
    if rec.trace is None or n is None or not rec.trace_solves:
        return None
    return n / rec.trace_solves
