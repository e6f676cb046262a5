"""Every solver the paper compares against (Secs. 4.1.2, 4.2.2), in
PyTorch (port of ``repro.core.baselines``)."""
from repro_torch.core.baselines.common import BaselineResult
from repro_torch.core.baselines.fista import fista_solve, f_star
from repro_torch.core.baselines.sgd import (sgd_solve, sgd_rate_search,
                                            parallel_sgd_solve)
from repro_torch.core.baselines.smidas import smidas_solve
from repro_torch.core.baselines.sparsa import sparsa_solve
from repro_torch.core.baselines.gpsr import gpsr_bb_solve
from repro_torch.core.baselines.iht import iht_solve
from repro_torch.core.baselines.fpc_as import fpc_as_solve
from repro_torch.core.baselines.l1_ls import l1_ls_solve

__all__ = ["BaselineResult", "fista_solve", "f_star", "sgd_solve",
           "sgd_rate_search", "parallel_sgd_solve", "smidas_solve",
           "sparsa_solve", "gpsr_bb_solve", "iht_solve", "fpc_as_solve",
           "l1_ls_solve"]
