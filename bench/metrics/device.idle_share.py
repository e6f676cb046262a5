"""One minus the device's busy time over the traced span, from the first
profiled call to the end of the synchronise after the last."""


def read(rec):
    t = rec.trace
    if t is None or t.span_s <= 0 or t.busy_s <= 0:
        return None
    return 1.0 - t.busy_s / t.span_s
