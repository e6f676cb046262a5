"""Shotgun: parallel coordinate descent for L1-regularized losses (ICML
2011), in PyTorch (port of ``repro.core``).

Public API:
    make_problem, Problem, objective, lambda_max          (objectives)
    shooting_solve, shotgun_solve, shotgun_dup_solve      (Alg. 1 / Alg. 2)
    shotgun_cdn_solve, shooting_cdn_solve                 (CDN variants)
    get_solver, SOLVER_NAMES                              (solver registry)
    SolverSpec                                            (declarative solve spec)
    make_engine, ENGINE_NAMES                             (round-engine registry)
    spectral_radius, p_star                               (parallelism limit)
    solve_path                                            (lambda continuation)
    shotgun_sharded_solve                                 (multi-device driver)

The kernel solvers (``block`` / ``block_fused`` in ``get_solver``) live in
``repro_torch.kernels.ops``.  ``solve_path(solver=<name>)`` accepts any
registry entry; ``shotgun_sharded_solve(engine=<name>)`` any engine.
"""
from repro_torch.core.objectives import (LASSO, LOGISTIC, Problem,
                                         DupProblem, make_problem, dup_from,
                                         objective, lambda_max,
                                         soft_threshold, unscale_x, matvec,
                                         rmatvec, gather_cols)
from repro_torch.core.spec import SolverSpec
from repro_torch.core.shotgun import (shooting_solve, shotgun_solve,
                                      shotgun_dup_solve, rounds_to_tolerance,
                                      diverged, get_solver, SOLVER_NAMES,
                                      Result, Trace)
from repro_torch.core.cdn import shotgun_cdn_solve, shooting_cdn_solve
from repro_torch.core.engines import (ENGINE_NAMES, BlockEngine, FusedEngine,
                                      ScalarEngine, make_engine)
from repro_torch.core.spectral import spectral_radius, p_star, p_star_dup
from repro_torch.core.path import solve_path, lambda_sequence
from repro_torch.core.sharded import shotgun_sharded_solve

__all__ = [
    "LASSO", "LOGISTIC", "Problem", "DupProblem", "make_problem", "dup_from",
    "objective", "lambda_max", "soft_threshold", "unscale_x", "matvec",
    "rmatvec", "gather_cols", "SolverSpec", "shooting_solve",
    "shotgun_solve", "shotgun_dup_solve", "rounds_to_tolerance", "diverged",
    "get_solver", "SOLVER_NAMES", "Result", "Trace", "shotgun_cdn_solve",
    "shooting_cdn_solve", "ENGINE_NAMES", "BlockEngine", "FusedEngine",
    "ScalarEngine", "make_engine", "spectral_radius", "p_star", "p_star_dup",
    "solve_path", "lambda_sequence", "shotgun_sharded_solve"]
