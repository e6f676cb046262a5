"""Blocking host waits inside the harness's range around each solver call
(the harness's own synchronise after it is outside), per solve."""


def read(rec):
    t = rec.trace
    if t is None or rec.range_name != "bench.solve" or not rec.trace_solves:
        return None
    return t.waits / rec.trace_solves
