"""Pathwise optimization (Sec. 4.1.1, after Friedman et al. 2010; port of
``repro.core.path``).

Rather than solving directly at the target λ, solve along an exponentially
decreasing sequence λ_1 > λ_2 > ... > λ_target, warm-starting each solve
from the previous solution.  λ_1 is chosen just below
λ_max = ‖Aᵀ dL/dz(0)‖_∞ (above which x* = 0).

``solve_path`` runs on any ``SOLVER_NAMES`` entry (``core.get_solver``):
with ``solver="block_fused"`` the per-λ solves run the fused kernels.

Draws: the path takes a ``torch.Generator``, shared by every solver call,
or ``draws``, an iterable with one explicit draw stream per solver call in
call order — the stream the family takes as ``idx`` or ``blk_idx`` (the
parity tests pass the JAX path's own draws).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import objectives as obj
from repro_torch.core import shotgun
from repro_torch.core.spec import SolverSpec

BLOCK = 128


class PathResult(NamedTuple):
    x: torch.Tensor               # solution at the target λ
    lambdas: np.ndarray           # the continuation sequence
    objectives: np.ndarray        # final objective at each λ
    nnz: np.ndarray               # sparsity along the path
    rounds: np.ndarray | None = None   # rounds spent per λ (cache= only)


def lambda_sequence(lam_max: float, lam_target: float,
                    num: int = 10) -> np.ndarray:
    """Geometric sequence from just below lam_max down to lam_target."""
    lam_max = float(lam_max)
    lam_target = float(lam_target)
    if lam_target >= lam_max:
        return np.array([lam_target])
    return np.geomspace(0.95 * lam_max, lam_target, num)


def _largest_divisor_leq(n: int, cap: int) -> int:
    for c in range(min(cap, n), 0, -1):
        if n % c == 0:
            return c
    return 1


def _source(src, name: str) -> tuple[tuple, dict]:
    """(positional, keyword) arguments handing ``src`` — a generator, or
    an explicit draw stream passed as ``name`` — to a solver."""
    if src is None or isinstance(src, torch.Generator):
        return (src,), {}
    return (None,), {name: src}


def _solver_by_name(name, **solver_kwargs) -> Callable:
    """Adapt any ``SOLVER_NAMES`` entry to the path signature
    ``(prob, src, P, rounds, x0) -> Result``, ``src`` a generator or one
    call's explicit draws.

    ``P`` maps onto each family's parallelism knob: the per-round update
    count for the scalar solvers, K = ceil(P / 128) blocks for the kernel
    solvers, and P_local for the sharded driver.  ``solver_kwargs`` pass
    through (``K=``, ``rounds_per_launch=``, ``engine=``, ...).
    """
    solve = shotgun.get_solver(name)
    # (family, loss) pairs and the frozen *_logreg_fused aliases adapt like
    # their base family; the loss admission check rides inside ``solve``.
    family = name[0] if isinstance(name, tuple) else name
    if family in ("shotgun_logreg_fused", "sparse_logreg_fused"):
        family = "block_fused"

    if family in ("shooting", "shooting_cdn"):
        def run_shooting(p, src, P, r, x0):
            args, kw = _source(src, "idx")
            return solve(p, *args, rounds=r, x0=x0, **kw, **solver_kwargs)
        return run_shooting
    if family == "shotgun":
        def run_shotgun(p, src, P, r, x0):
            args, kw = _source(src, "idx")
            return solve(p, *args, spec=SolverSpec(loss=p.loss, P=P,
                                                   rounds=r),
                         x0=x0, **kw, **solver_kwargs)
        return run_shotgun
    if family == "shotgun_cdn":
        def run_cdn(p, src, P, r, x0):
            args, kw = _source(src, "idx")
            return solve(p, *args, P=P, rounds=r, x0=x0, **kw,
                         **solver_kwargs)
        return run_cdn
    if family == "shotgun_dup":
        def run_dup(p, src, P, r, x0):
            dp = obj.dup_from(p)
            xhat0 = (None if x0 is None else
                     torch.cat([torch.clamp_min(x0, 0.0),
                                torch.clamp_min(-x0, 0.0)]))
            args, kw = _source(src, "idx")
            res = solve(dp, *args, P=P, rounds=r, xhat0=xhat0, **kw,
                        **solver_kwargs)
            return res._replace(x=obj.dup_to_signed(res.x))
        return run_dup

    if family in ("block", "block_fused"):
        def run_block(p, src, P, r, x0):
            kw = dict(solver_kwargs)
            K = kw.pop("K", max(1, -(-P // BLOCK)))
            if family == "block_fused":
                kw.setdefault("rounds_per_launch", _largest_divisor_leq(r, 8))
            spec = SolverSpec(loss=p.loss, P=K * BLOCK, rounds=r,
                              fused=family == "block_fused")
            args, src_kw = _source(src, "blk_idx")
            return solve(p, *args, spec=spec, x0=x0, **src_kw, **kw)
        return run_block
    if family == "sharded":
        def run_sharded(p, src, P, r, x0):
            kw = dict(solver_kwargs)
            if kw.get("engine") in ("block", "fused", "sparse_block",
                                    "sparse_fused"):
                # block engines take their parallelism as K blocks of 128
                # per shard, not P_local
                kw.setdefault("K", max(1, -(-P // BLOCK)))
            if isinstance(src, torch.Generator):
                # the driver names its streams by an integer seed
                kw["seed"] = int(torch.randint(
                    2**31 - 1, (1,), generator=src, device=src.device))
            elif src is not None:
                kw["blk_idx"] = src
            return solve(p, spec=SolverSpec(loss=p.loss, P=P, rounds=r),
                         x0=x0, **kw)
        return run_sharded
    raise ValueError(f"no path adapter for solver {name!r}")


def solve_path(prob: obj.Problem, generator: torch.Generator | None = None,
               *, lam_target: float, spec: SolverSpec | None = None,
               num_lambdas: int = 10, solver: str | Callable | None = None,
               validate_p: bool = True, cache=None, problem_id=None,
               tol: float = 1e-4, draws=None,
               rounds_per_launch: int | None = None,
               **solver_kwargs) -> PathResult:
    """Warm-started λ-continuation around any Shotgun-family solver.

    ``spec=SolverSpec(...)`` gives P = spec.P and rounds_per_lambda =
    spec.rounds, with ``spec.loss`` validated against ``prob.loss``.
    ``solver`` is a ``SOLVER_NAMES`` entry (adapted automatically, warm
    starts included), a callable ``solver(prob, src, P, rounds, x0) ->
    shotgun.Result`` (``src`` a generator or one call's draws), or None
    for ``shotgun_solve``.  Each solver call takes ``generator`` or the
    next stream of ``draws``.

    ``validate_p`` checks P against the safe parallelism
    ``spectral.p_star(A)`` (Thm 3.2) before the continuation loop and
    clamps with a warning: a diverging per-λ solve would poison every later
    warm start (DESIGN §9).

    ``cache`` (a ``core.batched.WarmStartCache``, DESIGN §11.4) plugs the
    sweep into the solver service's warm-start store: each λ reads
    ``cache.get(problem_id, λ)`` (exact hit, else nearest λ) before the
    in-sweep warm start, writes its solution back, and stops early on a
    ``tol``-flat chunk of rounds — so a second sweep over the same
    (problem_id, λ grid) takes fewer rounds.  With a cache the per-λ budget
    is a cap and ``PathResult.rounds`` reports the rounds spent per λ;
    ``cache=None`` keeps the fixed budget and one solver call per λ.

    ``rounds_per_launch`` (the fused block solvers) is the launch length,
    handed to a registry solver; under a cache it is also the chunk after
    which a λ checks convergence, so each chunk is one launch.  It must
    divide the per-λ budget.  None keeps the largest divisor of the budget
    up to 8.
    """
    if spec is None:
        raise TypeError("solve_path needs spec=SolverSpec(...); the legacy "
                        "(P, rounds_per_lambda) kwargs are not ported")
    spec.check_loss(prob.loss)
    P, rounds_per_lambda = spec.P, spec.rounds
    if validate_p:
        import warnings

        from repro_torch.core import spectral
        ps = spectral.p_star(prob.A)
        if P > ps:
            warnings.warn(
                f"solve_path: P={P} exceeds the Thm 3.2 safe parallelism "
                f"P*={ps} for this design; clamping to P*={ps} "
                f"(pass validate_p=False to override)", stacklevel=2)
            P = ps
    chunk = (_largest_divisor_leq(rounds_per_lambda, 8)
             if rounds_per_launch is None else int(rounds_per_launch))
    if chunk < 1 or rounds_per_lambda % chunk:
        raise ValueError(f"rounds_per_launch={rounds_per_launch} must divide "
                         f"the rounds a λ, {rounds_per_lambda}")
    if isinstance(solver, str):
        if rounds_per_launch is not None:
            solver_kwargs["rounds_per_launch"] = chunk
        solver = _solver_by_name(solver, **solver_kwargs)
    elif solver_kwargs:
        raise ValueError(
            f"solver_kwargs {sorted(solver_kwargs)} are only forwarded when "
            f"``solver`` is a registry name; got solver={solver!r}")
    elif solver is None:
        solver = _solver_by_name("shotgun")
    streams = None if draws is None else iter(draws)

    def call(p_i, r, x):
        src = generator if streams is None else next(streams)
        return solver(p_i, src, P, r, x)

    lmax = float(obj.lambda_max(prob.A, prob.y, prob.loss))
    lams = lambda_sequence(lmax, lam_target, num_lambdas)
    dev = prob.A.device
    x = torch.zeros(prob.d, dtype=torch.float32, device=dev)
    objs, nnzs = [], []

    def lam_problem(lam):
        return prob._replace(lam=torch.tensor(np.float32(lam), device=dev))

    if cache is None:
        for lam in lams:
            res = call(lam_problem(lam), rounds_per_lambda, x)
            x = res.x
            objs.append(float(res.trace.objective[-1]))
            nnzs.append(int(res.trace.nnz[-1]))
        return PathResult(x=x, lambdas=lams, objectives=np.array(objs),
                          nnz=np.array(nnzs))

    from repro_torch.core.batched import launch_converged
    pid = "path" if problem_id is None else problem_id
    rounds_used = []
    for lam in lams:
        p_i = lam_problem(lam)
        x0, kind = cache.get(pid, float(lam), loss=prob.loss)
        if kind != "miss":
            x = torch.as_tensor(x0, dtype=torch.float32, device=dev)
        f_prev = float(obj.objective(x, p_i))
        spent = 0
        res = None
        while spent < rounds_per_lambda:
            res = call(p_i, chunk, x)
            x = res.x
            spent += chunk
            f_chunk = res.trace.objective.cpu().numpy()
            if launch_converged(f_prev, f_chunk, tol):
                break
            f_prev = float(f_chunk[-1])
        cache.put(pid, float(lam), x, loss=prob.loss)
        rounds_used.append(spent)
        objs.append(float(res.trace.objective[-1]))
        nnzs.append(int(res.trace.nnz[-1]))
    return PathResult(x=x, lambdas=lams, objectives=np.array(objs),
                      nnz=np.array(nnzs), rounds=np.array(rounds_used))
