"""The live share of the service's slots, averaged over every batched
launch of the window (``SolverService.occupancy_samples``, one a launch)."""


def read(rec):
    return rec.counters.get("occupancy")
