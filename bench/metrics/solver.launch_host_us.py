"""Host microseconds a launch inside the port's launch-loop span
(``repro_torch.solve.launches``, sentinel included; it holds no host
wait): the span's inclusive seconds over the launches it issued
(``solver.launches``), in the profiled calls.  None where the program has
no such span."""


def read(rec):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    t = obs.totals()
    loop = t["spans"].get("repro_torch.solve.launches")
    launches = t["counters"].get("solver.launches")
    if rec.trace is None or loop is None or not launches:
        return None
    return loop["seconds"] * 1e6 / launches
