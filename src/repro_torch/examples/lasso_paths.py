"""Pathwise λ-continuation (Sec. 4.1.1): warm-started regularization paths,
the trick Shotgun shares with GLMNET (port of ``examples/lasso_paths.py``).

    PYTHONPATH=src python -m repro_torch.examples.lasso_paths [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import objectives as obj
from repro_torch.core.path import solve_path
from repro_torch.core.shotgun import draw_coords, shotgun_solve
from repro_torch.core.spec import SolverSpec
from repro_torch.core.spectral import p_star
from repro_torch.data import synthetic as syn
from repro_torch.device import resolve_device
from repro_torch.examples import start_vector

ROUNDS_PER_LAMBDA, COLD_ROUNDS, NUM_LAMBDAS, P_TARGET = 300, 3000, 10, 16


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.lasso_paths",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)

    # blocked-CSC layout: the solvers run on the nnz tiles, never the dense A
    A, y, _ = syn.large_sparse(seed=0, n=1024, d=4096, layout="bcsc")
    prob = obj.make_problem(A, y, lam=0.5, device=dev)
    ps = p_star(prob.A, v0=start_vector(prob.d))
    P = min(P_TARGET, ps)      # solve_path's own clamp, before the draws

    # one (rounds, P) stream a λ, drawn from seed 0
    g = torch.Generator().manual_seed(0)
    draws = [draw_coords(g, ROUNDS_PER_LAMBDA, P, prob.d)
             for _ in range(NUM_LAMBDAS)]
    path = solve_path(prob, lam_target=0.5,
                      spec=SolverSpec(P=P, rounds=ROUNDS_PER_LAMBDA),
                      num_lambdas=NUM_LAMBDAS, draws=draws)
    print("lambda      F(x)          nnz")
    for lam, f, nnz in zip(path.lambdas, path.objectives, path.nnz):
        print(f"{lam:9.4f}  {f:12.4f}  {nnz:6d}")

    # contrast: cold start at the target lambda, drawing from seed 1
    cold = shotgun_solve(prob, spec=SolverSpec(P=P, rounds=COLD_ROUNDS),
                         idx=draw_coords(torch.Generator().manual_seed(1),
                                         COLD_ROUNDS, P, prob.d))
    cold_F = cold.trace.objective.cpu().numpy()
    print(f"\nwarm-started path final F = {path.objectives[-1]:.4f}")
    print(f"cold start ({COLD_ROUNDS} rounds) F = {float(cold_F[-1]):.4f}")

    # make_problem normalized the columns; map the solution back to the raw
    # bigram-count feature space before reporting coefficients
    x_raw = obj.unscale_x(path.x, prob.scales)
    top = torch.argsort(-torch.abs(x_raw), stable=True)[:5]
    top = list(zip(top.tolist(), x_raw[top].tolist()))
    print("\ntop raw-space coefficients (feature, weight):")
    for j, w in top:
        print(f"  {j:6d}  {w:+9.4f}")
    return dict(p_star=ps, P=P, lambdas=path.lambdas,
                objectives=path.objectives, nnz=path.nnz,
                path_F=float(path.objectives[-1]), cold_F=cold_F,
                final_nnz=int(path.nnz[-1]), top=top)


if __name__ == "__main__":
    main()
