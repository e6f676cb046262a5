"""Block-Shotgun solvers over the Hopper kernels (port of
``repro.kernels.ops``).

``block_shotgun_round``   one synchronous round: K aligned blocks of 128
                          coordinates updated in parallel (P_eff = K·128),
                          two kernel launches (gather, scatter).
``sparse_block_shotgun_round``  the same round on BlockedCSC nnz tiles.
``block_shotgun_solve``   full solver, dense or BlockedCSC.
                          ``spec.fused=False`` loops over
                          rounds (two launches each); ``spec.fused=True``
                          loops over *launches* of ``rounds_per_launch``
                          fused rounds.  Both consume the same block stream,
                          so their traces coincide.

Block draws: JAX's threefry stream cannot be reproduced in torch, so every
solver takes an explicit ``blk_idx`` of shape (rounds, K) — the parity
tests feed it the JAX package's own draws — or draws K distinct blocks per
round from a ``torch.Generator`` on the problem's device (no host round
trip).  The legacy ``(K, rounds)`` kwargs are not ported yet: ``spec=`` is
required.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.core import health
from repro_torch.core import objectives as obj
from repro_torch.core.objectives import Problem
from repro_torch.core.shotgun import Result, Trace
from repro_torch.core.spec import SolverSpec
from repro_torch.data.sparse import BlockedCSC
from repro_torch.kernels.shotgun_block import (BLOCK, TILE_N, Loss,
                                               fused_shotgun_rounds,
                                               gather_block_matvec,
                                               resolve_loss,
                                               scatter_block_update)
from repro_torch.kernels.shotgun_sparse import (block_delta,
                                                fused_sparse_shotgun_rounds,
                                                sparse_gather_block_matvec,
                                                sparse_scatter_block_update)

# The spans of a solve (``obs``): the whole call, and its draws, padding
# and launch loop (sentinel included).  The loop's span is not a
# ``*_RANGE`` window: a guarded loop's ``health.init_guard_state`` copies
# p_eff from the host, and that copy waits for the stream.
SOLVE_SPAN = "repro_torch.solve"
DRAWS_SPAN = "repro_torch.solve.draws"
PAD_SPAN = "repro_torch.solve.pad"
LAUNCHES_SPAN = "repro_torch.solve.launches"


def pad_problem(A, y, block=BLOCK, tile_n=TILE_N):
    """Zero-pad A to (n % tile_n == 0, d % block == 0); returns (A, y, mask)
    with mask 1 on real samples and 0 on the added rows."""
    n, d = A.shape
    n_pad = (-n) % tile_n
    d_pad = (-d) % block
    if n_pad or d_pad:
        A = F.pad(A, (0, d_pad, 0, n_pad))
        y = F.pad(y, (0, n_pad))
    mask = F.pad(torch.ones(n, dtype=A.dtype, device=A.device), (0, n_pad))
    obs.count("solver.pad_bytes",
              obs.nbytes(A, y, mask) if n_pad or d_pad else mask.nbytes)
    return A, y, mask


def _add_blocks(xb, idx, delta):
    """xb[idx[k]] += delta[k] for k in order (duplicates accumulate), one
    index per step so the sum order is fixed on every device."""
    xb = xb.clone()
    for k in range(idx.shape[0]):
        xb.index_add_(0, idx[k:k + 1], delta[k:k + 1])
    return xb


def block_shotgun_round(A, z, x, blk_idx, lam, beta, y, mask,
                        loss: str = obj.LASSO, k_eff=None):
    """One Block-Shotgun round.  Returns (x_new, z_new, delta).

    ``k_eff`` masks blocks at or past the backoff point (DESIGN §9); None
    applies all K drawn blocks, bit-exactly."""
    r = obj.residual_like(z, y, loss) * mask
    g = gather_block_matvec(A, r, blk_idx)
    d = x.shape[0]
    idx = blk_idx.long()
    xb = x.reshape(d // BLOCK, BLOCK)
    x_sel = xb[idx]
    delta = obj.soft_threshold(x_sel - g / beta, lam / beta) - x_sel
    if k_eff is not None:
        delta = delta * health.live_mask(idx.shape[0], k_eff,
                                         device=delta.device)[:, None]
    z_new = scatter_block_update(A, z, blk_idx, delta)
    return _add_blocks(xb, idx, delta).reshape(d), z_new, delta


def _round_loop(step, objective, x, z, blk_idx, guard):
    """The two-kernel solves' loop over rounds; blk_idx (rounds, K).
    ``step(z, x, idx, k_eff)`` runs one round and returns (x, z);
    ``objective(z, x)`` is F.  With ``guard`` each round passes the
    sentinel (rollback to the last-good snapshot, k_eff halving)."""
    K = blk_idx.shape[1]
    fs, nnzs = [], []
    if guard is None:
        for idx in blk_idx:
            x, z = step(z, x, idx, None)
            fs.append(objective(z, x))
            nnzs.append(torch.sum(x != 0))
        fs = torch.stack(fs)
        return Result(x=x, z=z, trace=Trace(
            objective=fs, nnz=torch.stack(nnzs).to(torch.int32)),
            status=health.status_from_trace(fs))

    p_floor = max(1, min(guard.p_min, K))
    gs = health.init_guard_state(x, z, objective(z, x), K)
    for idx in blk_idx:
        x_new, z_new = step(z, x, idx, gs.p_eff)
        x, z, f, gs, _ = health.apply_sentinel(
            gs, x_new, z_new, objective(z_new, x_new), factor=guard.factor,
            p_floor=p_floor)
        fs.append(f)
        nnzs.append(torch.sum(x != 0))
    fs = torch.stack(fs)
    return Result(x=x, z=z, trace=Trace(
        objective=fs, nnz=torch.stack(nnzs).to(torch.int32)),
        status=health.status_from_trace(fs, gs.backoffs))


def _launch_loop(launch, objective, x, z, blk_idx, guard):
    """The fused solves' loop over launches; blk_idx (L, R, K).
    ``launch(z, x, idx, k_eff, guard_f)`` runs R rounds and returns
    (x, z, f, nnz, health).

    With ``guard`` the in-kernel sentinel (health flag + k_eff mask) makes
    the *launch* the rollback granularity: a launch whose health flag trips
    is discarded wholesale — iterate and margin roll back to the last-good
    snapshot, k_eff halves — all on the device.
    """
    obs.count("solver.launches", blk_idx.shape[0])
    with obs.span(LAUNCHES_SPAN):
        K = blk_idx.shape[2]
        fs, nnzs = [], []
        if guard is None:
            for idx in blk_idx:
                x, z, f, nz, _ = launch(z, x, idx, None, None)
                fs.append(f)
                nnzs.append(nz)
            fs = torch.cat(fs)
            return Result(x=x, z=z, trace=Trace(objective=fs,
                                                nnz=torch.cat(nnzs)),
                          status=health.status_from_trace(fs))

        p_floor = max(1, min(guard.p_min, K))
        gs = health.init_guard_state(x, z, objective(z, x), K)
        for idx in blk_idx:
            x_new, z_new, f, nz, h = launch(
                z, x, idx, gs.p_eff,
                health.guard_threshold(gs.f_good, guard.factor))
            x, z, f_rep, gs, bad = health.apply_sentinel(
                gs, x_new, z_new, f[-1], factor=guard.factor,
                p_floor=p_floor, health=h)
            # A rolled-back launch reports the snapshot objective for all
            # its rounds: the trace stays finite through a recovered
            # divergence.
            fs.append(torch.where(bad, f_rep.expand_as(f), f))
            nnzs.append(torch.where(
                bad, torch.sum(x != 0).to(torch.int32).expand_as(nz), nz))
        fs = torch.cat(fs)
        return Result(x=x, z=z, trace=Trace(objective=fs,
                                            nnz=torch.cat(nnzs)),
                      status=health.status_from_trace(fs, gs.backoffs))


def _objective(y, mask, lam, loss: str):
    def objective(z, x):
        return obj.masked_objective(z, x, y, mask, lam, loss)
    return objective


def _solve(A, y, mask, lam, beta, blk_idx, loss, x0=None, guard=None):
    """Round loop over the two-kernel round; blk_idx (rounds, K).  x stays
    f32 also for bf16 A."""
    mask = mask.to(torch.float32)
    x, z = obj.start(A, x0, A.shape[1])

    def step(z, x, idx, k_eff):
        x, z, _ = block_shotgun_round(A, z, x, idx, lam, beta, y, mask,
                                      loss=loss, k_eff=k_eff)
        return x, z

    return _round_loop(step, _objective(y, mask, lam, loss), x, z, blk_idx,
                       guard)


def _fused_solve(A, y, mask, lam, beta, blk_idx, loss: Loss, x0=None,
                 guard=None):
    """Loop over launches: one fused kernel launch per R rounds; blk_idx
    (L, R, K)."""
    mask = mask.to(torch.float32)
    x, z = obj.start(A, x0, A.shape[1])

    def launch(z, x, idx, k_eff, guard_f):
        return fused_shotgun_rounds(A, z, x, idx, lam, beta, y, mask,
                                    loss=loss, k_eff=k_eff, guard_f=guard_f)

    return _launch_loop(launch, _objective(y, mask, lam, loss.name), x, z,
                        blk_idx, guard)


# ---------------------------------------------------------------------------
# BlockedCSC solves: no sample padding, z stays full length (n,)
# ---------------------------------------------------------------------------

def sparse_block_shotgun_round(rows, vals, z, x, blk_idx, lam, beta, y,
                               loss: str = obj.LASSO, k_eff=None, *,
                               order=None, rstart=None):
    """One Block-Shotgun round on BlockedCSC nnz tiles (two launches:
    gather, scatter; no mask — the sparse path never pads samples).
    ``order``/``rstart`` are the container's ``scatter_order()`` and
    ``range_starts()``.  Returns (x_new, z_new, delta)."""
    nblk, tile, block = rows.shape
    r = obj.residual_like(z, y, loss)
    g = sparse_gather_block_matvec(rows, vals, r, blk_idx)
    idx = blk_idx.long()
    xb = x.reshape(nblk, block)
    delta = block_delta(xb[idx], g, lam, beta)
    if k_eff is not None:
        delta = delta * health.live_mask(idx.shape[0], k_eff,
                                         device=delta.device)[:, None]
    z_new = sparse_scatter_block_update(rows, vals, z, blk_idx, delta,
                                        order=order, rstart=rstart)
    return _add_blocks(xb, idx, delta).reshape(-1), z_new, delta


def _sparse_solve(S: BlockedCSC, y, lam, beta, blk_idx, loss, x0=None,
                  guard=None):
    """Round loop over the sparse two-kernel round; blk_idx (rounds, K).
    x stays f32 also for bf16 vals."""
    if S.ovf is not None:
        raise ValueError("the two-kernel sparse round reads the tiles only; "
                         "a design with an overflow store takes the fused "
                         "path (spec.fused=True)")
    x, z = obj.start(S, x0, S.d_pad)
    order, rstart = S.scatter_order(), S.range_starts()
    ones = torch.ones_like(y, dtype=torch.float32)

    def step(z, x, idx, k_eff):
        x, z, _ = sparse_block_shotgun_round(S.rows, S.vals, z, x, idx, lam,
                                             beta, y, loss=loss, k_eff=k_eff,
                                             order=order, rstart=rstart)
        return x, z

    return _round_loop(step, _objective(y, ones, lam, loss), x, z, blk_idx,
                       guard)


def _fused_sparse_solve(S: BlockedCSC, y, lam, beta, blk_idx, loss: Loss,
                        x0=None, guard=None):
    """Loop over launches of the fused sparse kernel, one per R rounds;
    blk_idx (L, R, K); launch-granular rollback with ``guard``.  A design's
    overflow store goes with its tiles."""
    x, z = obj.start(S, x0, S.d_pad)
    order, rstart = S.scatter_order(), S.range_starts()
    ones = torch.ones_like(y, dtype=torch.float32)

    def launch(z, x, idx, k_eff, guard_f):
        return fused_sparse_shotgun_rounds(S.rows, S.vals, z, x, idx, lam,
                                           beta, y, loss=loss, k_eff=k_eff,
                                           guard_f=guard_f, order=order,
                                           rstart=rstart, ovf=S.ovf)

    return _launch_loop(launch, _objective(y, ones, lam, loss.name), x, z,
                        blk_idx, guard)


def block_stream(blk_idx, generator, rounds: int, K: int, nblk: int,
                 device) -> torch.Tensor:
    """(rounds, K) int32 block indices on ``device``: the caller's, checked
    once on the host, or K distinct blocks per round drawn on the device."""
    if K > nblk:
        raise ValueError(f"K={K} blocks per round > {nblk} blocks in d")
    if blk_idx is not None:
        idx = (blk_idx if isinstance(blk_idx, torch.Tensor)
               else torch.tensor(np.asarray(blk_idx))).to(torch.int32)
        if tuple(idx.shape) != (rounds, K):
            raise ValueError(f"blk_idx shape {tuple(idx.shape)} != "
                             f"(rounds, K) = {(rounds, K)}")
        if bool(((idx < 0) | (idx >= nblk)).any()):
            raise ValueError(f"blk_idx entries must lie in [0, {nblk})")
        return idx.to(device)
    if generator is None:
        raise ValueError("pass a torch.Generator or an explicit blk_idx")
    return draw_blocks(generator, rounds, K, nblk, device)


def draw_blocks(generator: torch.Generator, rounds: int, K: int, nblk: int,
                device) -> torch.Tensor:
    """(rounds, K) int32: K distinct blocks per round, drawn on ``device``
    from ``generator`` (one uniform key per block; the K smallest win)."""
    u = torch.rand(rounds, nblk, generator=generator, device=device)
    return u.argsort(dim=-1)[:, :K].to(torch.int32)


def block_shotgun_solve(prob: Problem, generator: torch.Generator | None = None,
                        *, spec: SolverSpec | None = None,
                        blk_idx=None, x0=None,
                        rounds_per_launch: int = 8) -> Result:
    """Shotgun with K = ceil(spec.P / 128) parallel blocks of 128
    coordinates per round, on the problem's device.

    ``spec.fused=True`` runs ``rounds_per_launch`` rounds per kernel launch
    (must divide ``spec.rounds``); the trajectory equals the two-kernel
    path's for the same block stream.  ``spec.newton`` swaps the β step for
    the per-block Newton curvature (fused only).  ``spec.guard`` enables
    the divergence sentinel + adaptive-K backoff (``p_min`` in blocks).

    ``blk_idx`` (rounds, K) fixes the block draws; otherwise they come from
    ``generator`` (a ``torch.Generator`` on the problem's device).  ``x0``
    warm-starts the iterate (zero-padded to the block-padded width, margin
    z0 = A x0).

    A ``BlockedCSC`` problem runs the sparse kernels on the same draws: no
    sample padding (n is arbitrary), x kept in f32 at the padded width and
    sliced to d, z full length (n,).
    """
    with obs.span(SOLVE_SPAN):
        return _block_shotgun_solve(prob, generator, spec, blk_idx, x0,
                                    rounds_per_launch)


def _block_shotgun_solve(prob, generator, spec, blk_idx, x0,
                         rounds_per_launch) -> Result:
    if spec is None:
        raise TypeError("block_shotgun_solve needs spec=SolverSpec(...); the "
                        "legacy (K, rounds) kwargs are not ported yet")
    spec.check_loss(prob.loss)
    K = max(1, -(-spec.P // BLOCK))
    rounds = spec.rounds
    if spec.fused and rounds % rounds_per_launch:
        raise ValueError(f"rounds={rounds} not divisible by "
                         f"rounds_per_launch={rounds_per_launch}")
    loss = resolve_loss(prob.loss)
    if spec.newton:
        loss = loss._replace(newton=True)
    if isinstance(prob.A, BlockedCSC):
        S = prob.A
        if S.block != BLOCK:
            raise ValueError(f"BlockedCSC block {S.block} != {BLOCK}")
        dev = S.device
        if x0 is not None:
            x0 = F.pad(torch.as_tensor(x0, dtype=torch.float32, device=dev),
                       (0, S.d_pad - prob.d))
        with obs.span(DRAWS_SPAN):
            idx = block_stream(blk_idx, generator, rounds, K, S.nblk, dev)
        if spec.fused:
            res = _fused_sparse_solve(
                S, prob.y, prob.lam, prob.beta,
                idx.reshape(rounds // rounds_per_launch, rounds_per_launch,
                            K), loss, x0=x0, guard=spec.guard)
        else:
            res = _sparse_solve(S, prob.y, prob.lam, prob.beta, idx,
                                prob.loss, x0=x0, guard=spec.guard)
        return Result(x=res.x[: prob.d], z=res.z, trace=res.trace,
                      status=res.status)
    with obs.span(PAD_SPAN):
        A, y, mask = pad_problem(prob.A, prob.y)
    dev = A.device
    if x0 is not None:
        x0 = F.pad(torch.as_tensor(x0, dtype=torch.float32, device=dev),
                   (0, A.shape[1] - prob.d))
    with obs.span(DRAWS_SPAN):
        idx = block_stream(blk_idx, generator, rounds, K,
                           A.shape[1] // BLOCK, dev)
    if spec.fused:
        res = _fused_solve(A, y, mask, prob.lam, prob.beta,
                           idx.reshape(rounds // rounds_per_launch,
                                       rounds_per_launch, K),
                           loss, x0=x0, guard=spec.guard)
    else:
        res = _solve(A, y, mask, prob.lam, prob.beta, idx, prob.loss, x0=x0,
                     guard=spec.guard)
    return Result(x=res.x[: prob.d], z=res.z[: prob.n], trace=res.trace,
                  status=res.status)


def fused_block_shotgun_solve(prob: Problem,
                              generator: torch.Generator | None = None, *,
                              spec: SolverSpec | None = None, blk_idx=None,
                              x0=None, rounds_per_launch: int = 8) -> Result:
    """``block_shotgun_solve`` pinned to the fused path: a spec left at
    ``fused=False`` is promoted to ``fused=True``."""
    if spec is None:
        raise TypeError("fused_block_shotgun_solve needs spec=SolverSpec(...)")
    if not spec.fused:
        spec = dataclasses.replace(spec, fused=True)
    return block_shotgun_solve(prob, generator, spec=spec, blk_idx=blk_idx,
                               x0=x0, rounds_per_launch=rounds_per_launch)

