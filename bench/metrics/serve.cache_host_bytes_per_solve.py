"""Bytes the warm-start cache moves between the card and the host (each
put's x to the host, each warm start's x0 back; the port's
``serve.cache_host_bytes`` counter) in the profiled jobs, a completed
solve.  None where the program has no such counter."""


def read(rec):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    n = obs.totals()["counters"].get("serve.cache_host_bytes")
    if rec.trace is None or n is None or not rec.trace_solves:
        return None
    return n / rec.trace_solves
