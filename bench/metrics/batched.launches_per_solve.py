"""The window's batched launches (growth of
``SolverService.launch_count``) over its completed solves."""


def read(rec):
    launches = rec.counters.get("launches")
    if launches is None or not rec.completed:
        return None
    return launches / rec.completed
