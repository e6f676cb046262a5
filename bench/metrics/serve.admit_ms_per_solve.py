"""Host milliseconds of the service's admissions (the port's span
``repro_torch.serve.admit``, inclusive: its own reads wait for its device
work) in the profiled jobs, a completed solve.  None where the program has
no such span."""


def read(rec):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    admit = obs.totals()["spans"].get("repro_torch.serve.admit")
    if rec.trace is None or admit is None or not rec.trace_solves:
        return None
    return admit["seconds"] * 1e3 / rec.trace_solves
