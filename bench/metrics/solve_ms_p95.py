"""The 95th percentile of every solve's wall time in the window: from the
call into the solver to the end of the synchronise after it returns."""
import numpy as np


def read(rec):
    if not rec.solve_s:
        return None
    return float(np.percentile(np.asarray(rec.solve_s) * 1e3, 95))
