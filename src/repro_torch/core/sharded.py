"""Distributed Shotgun on ``torch.distributed``: a driver over round
engines (port of ``repro.core.sharded``, DESIGN §3).

The paper's multicore Shotgun shares one ``Ax`` vector between P threads.
Here each rank owns a column slice of A (features sharded over the ranks)
and the full margin z (n,), replicated; each merge window a rank runs a
round engine (``core/engines.py``) for R rounds against the last merged z
and emits Δz = A_rank δx; one all-reduce of Δz per merge is the shared-Ax
write.

  ``merge="round"``    R = 1: one all-reduce per round, no staleness — Alg. 2
                       with P = P_rank × ranks; on one rank the fused engine
                       follows ``block_shotgun_solve(fused=True)``.
  ``merge="launch"``   R = rounds_per_launch stale rounds per merge: a rank
                       sees its own updates at once and other ranks' at
                       merge boundaries (Lemma 3.3's interference/staleness
                       trade-off as a knob), for 1/R of the wire traffic.

``pipeline=True`` (DESIGN §3.4) merges each segment's wire one segment
late: the all-reduce of the rank's previous wire ``w_pend`` is started
before the engine runs against ``z + w_pend`` and waited for after it, so
the wire overlaps the compute; the catch-up ``z + Σ w_pend`` counts each
wire once and an epilogue drains the last one.  On one rank it is exactly
the synchronous trajectory.

The loop runs in Python over merges.  Trace points (one per
``trace_every`` merges) stay on the device and are read once at the end;
the guard (``health.apply_sentinel``, p_eff halving, error feedback
cleared on a rollback) works on the device too.  With NCCL the wire stays
on the card; with gloo it goes through the host (``dist.collectives``).

Every rank passes the full ``Problem``; the driver pads it and takes its
own columns.  It returns x gathered to full d on every rank and z
replicated.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import health
from repro_torch.core import objectives as obj
from repro_torch.core.engines import ENGINE_NAMES, make_engine
from repro_torch.core.objectives import Problem
from repro_torch.core.shotgun import Result, Trace
from repro_torch.core.spec import SolverSpec
from repro_torch.data.sparse import BlockedCSC, pad_feature_blocks
from repro_torch.device import exact_f32_matmul
from repro_torch.dist import collectives as C
from repro_torch.dist.faults import faulty_psum, stream_seed
from repro_torch.kernels import ops
from repro_torch.kernels.shotgun_block import BLOCK

MERGE_MODES = ("round", "launch")
COMPRESSION_SCHEMES = ("none", "bf16", "int8", "topk")

_FAULT_SALT = 0x5EED  # fault coins branch off the solve's seed here (§9.3)


class FeatureGroup(NamedTuple):
    """The ranks the features are sharded over: the process group (None =
    the default group), this rank, the size, and for the hierarchical
    merge the (outer, inner) subgroups of a row-major
    (size / inner, inner) layout of the ranks."""
    group: object
    rank: int
    size: int
    outer: object = None
    inner: object = None
    inner_size: int = 1


def make_feature_group(group=None, *, inner: int | None = None
                       ) -> FeatureGroup:
    """``FeatureGroup`` over ``group``; with ``inner`` also the subgroups
    of the hierarchical merge (``dist.new_group`` is collective: every rank
    of the default group must make the same call)."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "init_process_group first (the sharded solver "
                           "never runs as an implicit single shard)")
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    if inner is None:
        return FeatureGroup(group, rank, size)
    if inner < 1 or size % inner:
        raise ValueError(f"inner={inner} must divide the group size {size}")
    ranks = (dist.get_process_group_ranks(group) if group is not None
             else list(range(size)))
    n_outer = size // inner
    inners = [dist.new_group([ranks[o * inner + j] for j in range(inner)])
              for o in range(n_outer)]
    outers = [dist.new_group([ranks[o * inner + j] for o in range(n_outer)])
              for j in range(inner)]
    return FeatureGroup(group, rank, size, outer=outers[rank % inner],
                        inner=inners[rank // inner], inner_size=inner)


def pad_features(A: torch.Tensor, multiple: int) -> torch.Tensor:
    """Right-pad A with zero columns to a multiple of ``multiple``.  Zero
    columns are fixed points of the update (grad 0 → δ 0)."""
    pad = (-A.shape[1]) % multiple
    return F.pad(A, (0, pad)) if pad else A


def _margin(A, x) -> torch.Tensor:
    """A x in f32 (dense A cast first, as the single-device solves do)."""
    if isinstance(A, BlockedCSC):
        return A.matvec(x)
    if A.is_cuda:
        exact_f32_matmul()
    return A.to(torch.float32) @ x


def _compress_dz(dz, ef, scheme: str, topk_frac: float):
    """One §7 wire step: (receiver-side reconstruction of dz + ef, the
    error-feedback residual of what the scheme dropped)."""
    from repro_torch.dist.compression import compress_grads
    wire, ef_new = compress_grads({"dz": dz}, {"dz": ef}, scheme=scheme,
                                  topk_frac=topk_frac)
    return wire["dz"], ef_new["dz"]


def _engine_solve(A_loc, y, mask, x0_loc, lam, beta, idx, *, engine,
                  fg: FeatureGroup, merge_rounds: int, trace_every: int,
                  compression: str, topk_frac: float, hierarchical: bool,
                  guard, faults, pipeline: bool, fault_seed: int):
    """The merge loop on this rank's columns; ``idx`` (rounds, W) is its
    draw stream.  Returns (x gathered to full d, z, f (points,), nnz
    (points,), backoffs).

    ``guard`` checks F (and the all-reduced health flags of the engines
    and the fault merges) at every trace point, rolling back (x_l, z) and
    halving p_eff on a trip.  A guarded pipelined solve drains the wire at
    each trace point, so the sentinel snapshots a consistent (x, z, F) and
    a rollback leaves nothing in flight; an unguarded one reports F at the
    stale z and drains in an epilogue."""
    n = y.shape[0]
    dev = y.device
    rounds = idx.shape[0]
    n_pts = rounds // merge_rounds // trace_every
    idx = idx.reshape(n_pts, trace_every, merge_rounds, -1)
    lname = engine.loss if isinstance(engine.loss, str) else engine.loss.name
    group = fg.group

    def psum(v):
        return C.all_reduce(v, group)

    def data_loss(z):
        return obj.masked_data_loss(z, y, mask, lname)

    def start_merge(w, m, h):
        """Start one Δz merge: (pending, h); pending.wait() is the merged
        wire.  The flat merge runs asynchronously; the others at once."""
        if faults is not None:
            seed_m = stream_seed(fault_seed, m)
            if hierarchical:
                w_g, h_f = C.hierarchical_faulty_psum(
                    w, seed_m, fg.rank, faults, fg.outer, fg.inner)
            else:
                w_g, h_f = faulty_psum(w, seed_m, fg.rank, faults, group)
            return C.ready(w_g), torch.maximum(h, h_f)
        if hierarchical:
            return C.ready(C.hierarchical_psum(w, fg.outer, fg.inner)), h
        return C.all_reduce(w, group, async_op=True), h

    z = psum(_margin(A_loc, x0_loc))          # the global margin of x0
    x_l = x0_loc.to(torch.float32)
    ef = torch.zeros(n, dtype=torch.float32, device=dev)
    w_pend = torch.zeros(n, dtype=torch.float32, device=dev)
    p_eff = torch.tensor(engine.p_full, dtype=torch.int32, device=dev)
    h0 = torch.zeros((), dtype=torch.float32, device=dev)
    h = h0
    m = 0
    gs = None
    if guard is not None:
        p_floor = max(1, min(guard.p_min, engine.p_full))
        l1 = psum(torch.sum(torch.abs(x_l)).reshape(1))[0]
        gs = health.init_guard_state(x_l, z, data_loss(z) + lam * l1,
                                     engine.p_full)
    fs, nnzs = [], []
    for o in range(n_pts):
        for j in range(trace_every):
            if pipeline:
                pend, h = start_merge(w_pend, m, h)
                x_l, dz, h_e = engine.run_segment(A_loc, y, mask, lam, beta,
                                                  z, w_pend, x_l, idx[o, j],
                                                  p_eff)
                if compression != "none":
                    # pend the receiver-side reconstruction, so the next
                    # segment's view matches what its merge adds
                    dz, ef = _compress_dz(dz, ef, compression, topk_frac)
                z = z + pend.wait()
                w_pend = dz
            else:
                x_l, dz, h_e = engine.run(A_loc, y, mask, lam, beta, z, x_l,
                                          idx[o, j], p_eff)
                if compression != "none":
                    dz, ef = _compress_dz(dz, ef, compression, topk_frac)
                pend, h = start_merge(dz, m, h)
                z = z + pend.wait()
            h = torch.maximum(h, h_e)
            m += 1
        if guard is None:
            l1, nnz = psum(torch.stack([torch.sum(torch.abs(x_l)),
                                        torch.sum(x_l != 0).float()]))
            f_out = data_loss(z) + lam * l1
        else:
            if pipeline:
                pend, h = start_merge(w_pend, m, h)
                z = z + pend.wait()
                w_pend = torch.zeros_like(w_pend)
                m += 1
            # health flags are rank-local: combine before the replicated
            # trip decision (one all-reduce with |x|)
            h_g, l1 = psum(torch.stack([h, torch.sum(torch.abs(x_l))]))
            x_l, z, f_out, gs, bad = health.apply_sentinel(
                gs, x_l, z, data_loss(z) + lam * l1, factor=guard.factor,
                p_floor=p_floor, health=h_g)
            # discarded updates invalidate their error feedback too
            ef = torch.where(bad, torch.zeros_like(ef), ef)
            p_eff = gs.p_eff
            nnz = psum(torch.sum(x_l != 0).float().reshape(1))[0]
        fs.append(f_out)
        nnzs.append(nnz)
        h = h0
    if pipeline and guard is None:        # epilogue: drain the last wire
        pend, _ = start_merge(w_pend, m, h)
        z = z + pend.wait()
    backoffs = (gs.backoffs if gs is not None
                else torch.zeros((), dtype=torch.int32, device=dev))
    x = C.all_gather(x_l, group)
    return (x, z, torch.stack(fs), torch.stack(nnzs).to(torch.int32),
            backoffs)


def _draws(blk_idx, seed: int, fg: FeatureGroup, seg: int, r0: int,
           rounds: int, width: int, limit: int, scalar: bool, dev):
    """This rank's (rounds, width) int32 draws for rounds [r0, r0 + rounds):
    the caller's ``blk_idx[rank]``, or drawn on the device from a generator
    seeded by (seed, rank, segment) only.  Block engines draw ``width``
    distinct blocks of ``limit`` per round, the scalar engine ``width``
    coordinates of ``limit`` with replacement."""
    if blk_idx is not None:
        return blk_idx[fg.rank, r0:r0 + rounds].to(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(stream_seed(seed, fg.rank, seg))
    if scalar:
        return torch.randint(0, limit, (rounds, width), generator=g,
                             device=dev, dtype=torch.int32)
    u = torch.rand(rounds, limit, generator=g, device=dev)
    return u.argsort(dim=-1)[:, :width].to(torch.int32)


def _check_draws(blk_idx, fg: FeatureGroup, rounds: int, width: int,
                 limit: int, scalar: bool):
    """The caller's (ranks, rounds, width) draws as an int32 tensor,
    checked once on the host."""
    import numpy as np
    idx = (blk_idx if isinstance(blk_idx, torch.Tensor)
           else torch.tensor(np.asarray(blk_idx))).to(torch.int32)
    want = (fg.size, rounds, width)
    if tuple(idx.shape) != want:
        raise ValueError(f"blk_idx shape {tuple(idx.shape)} != (ranks, "
                         f"rounds, {'P_local' if scalar else 'K'}) = "
                         f"{want}")
    if bool(((idx < 0) | (idx >= limit)).any()):
        raise ValueError(f"blk_idx entries must lie in [0, {limit})")
    return idx


def shotgun_sharded_solve(prob: Problem, *, spec: SolverSpec | None = None,
                          engine: str = "scalar", group=None, seed: int = 0,
                          blk_idx=None, trace_every: int = 1,
                          rounds_per_launch: int = 8, K: int = 2, x0=None,
                          compression: str = "none",
                          topk_frac: float = 0.01,
                          hierarchical: bool = False, faults=None,
                          ckpt_dir=None, ckpt_every: int = 0,
                          fail_at_merge: int | None = None,
                          resume: bool = False) -> Result:
    """Distributed Shotgun over any round engine (DESIGN §3).  Every rank
    of the group calls it with the same arguments.

    spec        ``SolverSpec``: P_local = spec.P (scalar engine), rounds,
                merge ("round" | "launch"), pipeline, guard (``p_min`` in
                the engine's units), newton (fused engines only).
    engine      "scalar" (P = P_local × ranks coordinates a round),
                "block" / "fused" (P = K × 128 × ranks), "sparse_block" /
                "sparse_fused" (the same over a BlockedCSC design, column
                blocks sharded).
    group       a ``FeatureGroup`` (``make_feature_group``; needed for
                ``hierarchical``), a process group, or None (the default
                group).  Raises when torch.distributed is not initialized.
    seed        names the draw streams (rank and segment mixed in) and,
                salted, the fault coins.
    blk_idx     (ranks, rounds, K) block draws — (ranks, rounds, P_local)
                coordinate draws for the scalar engine — in place of the
                generator streams; rank r uses blk_idx[r].
    x0          warm start (length d); z starts at the all-reduce of
                A_rank x0_rank.
    compression "none" | "bf16" | "int8" | "topk", with error feedback.
    hierarchical  merge via reduce-scatter(inner) → all-reduce(outer) →
                all-gather(inner) over the group's subgroups.
    faults      a ``dist.faults.FaultPlan``: every merge runs through the
                checksummed bounded re-merge.
    ckpt_every  > 0 segments the solve at merge granularity (a multiple of
                ``trace_every`` dividing the merge count): segment s draws
                from a stream of (seed, rank, s) only and rebuilds z from x,
                so an interrupted and resumed solve equals an uninterrupted
                one.  With ``ckpt_dir`` rank 0 checkpoints the gathered
                state after each segment; ``resume=True`` continues from
                the newest checkpoint, on any number of ranks.
                ``fail_at_merge`` raises ``health.SolverFailure`` once that
                many merges are done.

    The trace has one (objective, nnz) point per ``trace_every`` merges.
    """
    if spec is None:
        raise TypeError("shotgun_sharded_solve needs spec=SolverSpec(...); "
                        "the legacy (P_local, rounds) kwargs are not ported")
    spec.check_loss(prob.loss)
    P_local, rounds = spec.P, spec.rounds
    merge, pipeline, guard = spec.merge, spec.pipeline, spec.guard
    if engine not in ENGINE_NAMES:
        raise ValueError(f"unknown engine {engine!r}; choose from "
                         f"{ENGINE_NAMES}")
    if merge not in MERGE_MODES:
        raise ValueError(f"unknown merge {merge!r}; choose from {MERGE_MODES}")
    if compression not in COMPRESSION_SCHEMES:
        raise ValueError(f"unknown compression {compression!r}; choose from "
                         f"{COMPRESSION_SCHEMES}")
    fg = group if isinstance(group, FeatureGroup) else make_feature_group(group)
    nshards, me = fg.size, fg.rank
    merge_rounds = 1 if merge == "round" else rounds_per_launch

    if engine in ("sparse_block", "sparse_fused"):
        if not isinstance(prob.A, BlockedCSC):
            raise ValueError(
                f"engine={engine!r} needs a BlockedCSC design; got "
                f"{type(prob.A).__name__} (use data.sparse.BlockedCSC."
                "from_dense or a layout='bcsc' generator)")
        A = pad_feature_blocks(prob.A, nshards)
        nblk_local = A.nblk // nshards
        if K > nblk_local:
            raise ValueError(f"K={K} blocks > {nblk_local} local blocks "
                             f"(nblk={A.nblk}, shards={nshards})")
        y = prob.y
        mask = torch.ones(prob.n, dtype=torch.float32, device=y.device)
        d_local = nblk_local * A.block
        A_loc = A.col_blocks(me * nblk_local, (me + 1) * nblk_local)
        d_full = A.d_pad
    elif isinstance(prob.A, BlockedCSC):
        raise ValueError(f"engine={engine!r} needs a dense design; BlockedCSC "
                         "problems use engine='sparse_block' or "
                         "'sparse_fused'")
    else:
        if engine == "scalar":
            A, y = pad_features(prob.A, nshards), prob.y
            mask = torch.ones(prob.n, dtype=torch.float32, device=y.device)
            d_local = A.shape[1] // nshards
        else:
            A, y, mask = ops.pad_problem(prob.A, prob.y)
            A = pad_features(A, nshards * BLOCK)   # d_local tiles by 128
            d_local = A.shape[1] // nshards
            nblk_local = d_local // BLOCK
            if K > nblk_local:
                raise ValueError(f"K={K} blocks > {nblk_local} local blocks "
                                 f"(d_local={d_local}, block={BLOCK})")
            mask = mask.to(torch.float32)
        A_loc = A[:, me * d_local:(me + 1) * d_local].contiguous()
        d_full = A.shape[1]
        del A
    eng = make_engine(engine, loss=prob.loss, P_local=P_local, K=K,
                      newton=spec.newton)
    scalar = engine == "scalar"
    width, limit = (P_local, d_local) if scalar else (K, nblk_local)
    dev = y.device

    if rounds % merge_rounds:
        raise ValueError(
            f"rounds={rounds} not divisible by merge_rounds={merge_rounds}")
    n_merges = rounds // merge_rounds
    if n_merges % trace_every:
        raise ValueError(
            f"number of merges {n_merges} (= rounds {rounds} / merge_rounds "
            f"{merge_rounds}) not divisible by trace_every={trace_every}")
    if hierarchical:
        if fg.inner is None:
            raise ValueError(
                "hierarchical=True needs a FeatureGroup with (outer, inner) "
                "subgroups: pass group=make_feature_group(inner=...)")
        if y.shape[0] % fg.inner_size:
            raise ValueError(
                f"n={y.shape[0]} not divisible by inner group size "
                f"{fg.inner_size} (hierarchical reduce-scatter)")
    if blk_idx is not None:
        blk_idx = _check_draws(blk_idx, fg, rounds, width, limit, scalar)

    x0 = (torch.zeros(d_full, dtype=torch.float32, device=dev) if x0 is None
          else F.pad(torch.as_tensor(x0, dtype=torch.float32, device=dev),
                     (0, d_full - prob.d)))
    cols = slice(me * d_local, (me + 1) * d_local)
    kw = dict(engine=eng, fg=fg, merge_rounds=merge_rounds,
              trace_every=trace_every, compression=compression,
              topk_frac=topk_frac, hierarchical=hierarchical, guard=guard,
              faults=faults, pipeline=pipeline)

    def solve_segment(x_start, seg: int, r0: int, seg_rounds: int):
        idx = _draws(blk_idx, seed, fg, seg, r0, seg_rounds, width, limit,
                     scalar, dev)
        return _engine_solve(A_loc, y, mask, x_start[cols], prob.lam,
                             prob.beta, idx,
                             fault_seed=stream_seed(seed, _FAULT_SALT, seg),
                             **kw)

    if ckpt_every <= 0:
        if fail_at_merge is not None or resume or ckpt_dir is not None:
            raise ValueError("ckpt_dir/fail_at_merge/resume need ckpt_every "
                             "> 0 (segmented solve)")
        x, z, fs, nnzs, backoffs = solve_segment(x0, 0, 0, rounds)
        return Result(x=x[: prob.d], z=z[: prob.n],
                      trace=Trace(objective=fs, nnz=nnzs),
                      status=health.status_from_trace(fs, backoffs))

    # --- segmented solve with periodic checkpoints (DESIGN §9.4) ---------
    if ckpt_every % trace_every or n_merges % ckpt_every:
        raise ValueError(
            f"ckpt_every={ckpt_every} must be a multiple of trace_every="
            f"{trace_every} and divide the merge count {n_merges}")
    from repro_torch.ckpt import checkpoint as ckpt
    n_seg = n_merges // ckpt_every
    seg_rounds = ckpt_every * merge_rounds
    pts = ckpt_every // trace_every
    n_pts = n_merges // trace_every
    fs_full = torch.zeros(n_pts, dtype=torch.float32, device=dev)
    nnz_full = torch.zeros(n_pts, dtype=torch.int32, device=dev)
    status = torch.zeros((), dtype=torch.int32, device=dev)
    seg0, x_cur, z_cur = 0, x0, None
    if resume:
        template = {"x": torch.zeros(prob.d), "fs": fs_full,
                    "nnz": nnz_full, "seg": status, "status": status}
        _, state = ckpt.restore(ckpt_dir, template, device=dev)
        seg0 = int(state["seg"])
        status = state["status"]
        fs_full, nnz_full = state["fs"], state["nnz"]
        x_cur = F.pad(state["x"], (0, d_full - prob.d))

    for seg in range(seg0, n_seg):
        if fail_at_merge is not None and seg * ckpt_every >= fail_at_merge:
            raise health.SolverFailure(
                f"simulated death at merge {seg * ckpt_every} "
                f"({seg}/{n_seg} segments checkpointed)")
        x_cur, z_cur, fs, nnzs, backoffs = solve_segment(
            x_cur, seg, seg * seg_rounds, seg_rounds)
        fs_full[seg * pts:(seg + 1) * pts] = fs
        nnz_full[seg * pts:(seg + 1) * pts] = nnzs
        # DIVERGED > RECOVERED > OK
        status = torch.maximum(status, health.status_from_trace(fs, backoffs))
        if ckpt_dir is not None:
            if me == 0:
                ckpt.save(ckpt_dir, seg + 1, {
                    "x": x_cur[: prob.d], "fs": fs_full, "nnz": nnz_full,
                    "seg": torch.tensor(seg + 1, dtype=torch.int32),
                    "status": status})
            dist.barrier(group=fg.group)   # the step is published for all

    if z_cur is None:                      # resumed after the last segment
        z_cur = C.all_reduce(_margin(A_loc, x_cur[cols]), fg.group)
    return Result(x=x_cur[: prob.d], z=z_cur[: prob.n],
                  trace=Trace(objective=fs_full, nnz=nnz_full),
                  status=status)
