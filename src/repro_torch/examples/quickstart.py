"""Quickstart: solve a Lasso with Shotgun and check the theory's P* estimate
(port of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import objectives as obj
from repro_torch.core.baselines.fista import fista_solve
from repro_torch.core.shotgun import (draw_coords, rounds_to_tolerance,
                                      shooting_solve, shotgun_solve)
from repro_torch.core.spec import SolverSpec
from repro_torch.core.spectral import p_star, spectral_radius
from repro_torch.data import synthetic as syn
from repro_torch.device import resolve_device
from repro_torch.examples import start_vector

SHOOTING_ROUNDS, SHOTGUN_ROUNDS, FISTA_ITERS = 20000, 2000, 6000


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.quickstart",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)

    # 1. a compressed-sensing style problem (n < d, sparse truth)
    A, y, _ = syn.singlepixcam(seed=0, n=410, d=1024, nnz_frac=0.05)
    prob = obj.make_problem(A, y, lam=0.5, device=dev)

    # 2. the paper's parallelism estimate: P* = ceil(d / rho(A^T A))
    v0 = start_vector(prob.d)
    rho = float(spectral_radius(prob.A, v0=v0))
    ps = p_star(prob.A, v0=v0)
    print(f"d = {prob.d}, rho = {rho:.2f} -> P* = {ps} "
          f"(max useful parallel updates, Thm 3.2)")

    # 3. solve with Shooting (P=1) and Shotgun (P near P*), both drawing
    #    from seed 0
    P = max(1, min(ps, 64))
    fstar = float(fista_solve(prob, FISTA_ITERS, v0=v0).objective[-1])
    res1 = shooting_solve(prob, rounds=SHOOTING_ROUNDS, idx=draw_coords(
        torch.Generator().manual_seed(0), SHOOTING_ROUNDS, 1, prob.d))
    resP = shotgun_solve(prob, spec=SolverSpec(P=P, rounds=SHOTGUN_ROUNDS),
                         idx=draw_coords(torch.Generator().manual_seed(0),
                                         SHOTGUN_ROUNDS, P, prob.d))
    t1 = int(rounds_to_tolerance(res1.trace.objective, fstar))
    tP = int(rounds_to_tolerance(resP.trace.objective, fstar))
    f_shooting = res1.trace.objective.cpu().numpy()
    f_shotgun = resP.trace.objective.cpu().numpy()
    nnz = int(resP.trace.nnz[-1])
    print(f"Shooting  (P=1):  {t1} rounds to 0.5% of F*")
    print(f"Shotgun (P={P}): {tP} rounds to 0.5% of F* "
          f"({t1 / max(tP, 1):.1f}x fewer — theory predicts ~{P}x)")
    print(f"final F: {float(f_shotgun[-1]):.4f} (F* = {fstar:.4f}), "
          f"nnz = {nnz}/{prob.d}")
    return dict(d=prob.d, rho=rho, p_star=ps, P=P, fstar=fstar,
                shooting_rounds_to_tol=t1, shotgun_rounds_to_tol=tP,
                shooting_F=f_shooting, shotgun_F=f_shotgun,
                final_F=float(f_shotgun[-1]), nnz=nnz)


if __name__ == "__main__":
    main()
