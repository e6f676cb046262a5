"""The share of the service's BlockedCSC admissions that took the design's
cached layouts instead of building them (the port's counters
``serve.layout_hits`` and ``serve.layout_builds``: hits over hits plus
builds) in the profiled jobs.  None where the program has no such counter
or admitted no BlockedCSC design."""


def read(rec):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    counters = obs.totals()["counters"]
    hits = counters.get("serve.layout_hits", 0)
    builds = counters.get("serve.layout_builds", 0)
    if rec.trace is None or not hits + builds:
        return None
    return hits / (hits + builds)
