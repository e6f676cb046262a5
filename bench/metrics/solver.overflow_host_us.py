"""Host microseconds a launch spends on a design's overflow store (the
port's span ``repro_torch.solve.overflow``: the launch's overflow
workspaces, sized on the host from the store's segment slots) over the
launches that took a store (``solver.overflow_launches``), in the profiled
calls.  None where the program has no such span or counter."""


def read(rec):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    t = obs.totals()
    span = t["spans"].get("repro_torch.solve.overflow")
    launches = t["counters"].get("solver.overflow_launches")
    if rec.trace is None or span is None or not launches:
        return None
    return span["seconds"] * 1e6 / launches
