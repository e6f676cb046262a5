"""Blocking host waits inside the harness's range around each ``serve()``
call, per completed solve of those calls."""


def read(rec):
    t = rec.trace
    if t is None or rec.range_name != "bench.serve" or not rec.trace_solves:
        return None
    return t.waits / rec.trace_solves
