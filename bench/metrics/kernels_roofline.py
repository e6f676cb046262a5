"""The bytes the profiled calls' rounds and solves need
(``bench/reference/bytes.py``) over 3.35 TB/s, as a share of the device's
busy seconds in the same profile, in percent.  No kernel name is read, so
the share holds whatever implements the work; in a served job the busy
time includes admission's device work."""
from bench.reference.bytes import roofline_percent


def read(rec):
    t = rec.trace
    if t is None or not rec.trace_bytes:
        return None
    return roofline_percent(rec.trace_bytes, t.busy_s)
