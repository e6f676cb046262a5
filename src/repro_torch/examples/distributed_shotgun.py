"""Distributed Shotgun over feature-sharded ranks (DESIGN §3) — the
multi-pod adaptation of the paper's shared-Ax multicore algorithm, plus the
Block-Shotgun kernel path (port of ``examples/distributed_shotgun.py``).

    PYTHONPATH=src python -m repro_torch.examples.distributed_shotgun                # one NCCL rank on the card
    PYTHONPATH=src python -m repro_torch.examples.distributed_shotgun --device cpu   # one gloo rank
    PYTHONPATH=src python -m repro_torch.examples.distributed_shotgun --device cpu --ranks 4

The sharded solve runs on every rank of the process group this program
makes (the ranks share the seed-0 draws, each reading its own slice); the
block solves and the scalar reference run on rank 0.
"""
from __future__ import annotations

import argparse
import json

import torch
import torch.distributed as dist

from repro_torch.core import objectives as obj
from repro_torch.core.sharded import make_feature_group, shotgun_sharded_solve
from repro_torch.core.shotgun import draw_coords, shotgun_solve
from repro_torch.core.spec import SolverSpec
from repro_torch.core.spectral import p_star
from repro_torch.data import synthetic as syn
from repro_torch.device import resolve_device
from repro_torch.examples import start_vector
from repro_torch.kernels import ops

SHARDED_ROUNDS, BLOCK_ROUNDS, ROUNDS_PER_LAUNCH = 2000, 500, 10
RESULT = "distributed_shotgun result: "


def solve(device, sharded_rounds: int | None = None,
          block_rounds: int | None = None) -> dict | None:
    """The example on the current process group (every rank calls it),
    ``SHARDED_ROUNDS`` and ``BLOCK_ROUNDS`` rounds unless given; rank 0
    prints and returns the numbers, the other ranks return None."""
    sharded_rounds = sharded_rounds or SHARDED_ROUNDS
    block_rounds = block_rounds or BLOCK_ROUNDS
    dev = torch.device(device)
    fg = make_feature_group()
    world, rank = fg.size, fg.rank
    if rank == 0:
        print(f"ranks: {world} ({dist.get_backend()}, {dev.type})")
    A, y, _ = syn.sparco(seed=0, n=1024, d=4096)
    prob = obj.make_problem(A, y, lam=0.5, device=dev)
    ps = p_star(prob.A, v0=start_vector(prob.d))
    if rank == 0:
        print(f"P* = {ps}")

    # 1. feature-sharded SPMD Shotgun: every rank updates its own
    #    coordinates; one all-reduce per round merges the shared margin z;
    #    rank r draws blk_idx[r] of one seed-0 stream over its columns
    P_local = max(1, min(ps // world, 16))
    d_local = -(-prob.d // world)
    draws = torch.randint(0, d_local, (world, sharded_rounds, P_local),
                          generator=torch.Generator().manual_seed(0),
                          dtype=torch.int32)
    res = shotgun_sharded_solve(
        prob, spec=SolverSpec(P=P_local, rounds=sharded_rounds), group=fg,
        blk_idx=draws)
    sharded_F = res.trace.objective.cpu().numpy()
    sharded_nnz = int(res.trace.nnz[-1])
    if rank:
        return None
    print(f"sharded Shotgun (P = {P_local} x {world}): "
          f"F = {float(sharded_F[-1]):.4f}, nnz = {sharded_nnz}")

    # 2. Block-Shotgun (two kernels a round: the gather #3, the scatter
    #    #4): aligned 128-coordinate blocks, one stream for 2 and 2b
    K = max(1, min(ps // ops.BLOCK, 4))
    nblk = -(-prob.d // ops.BLOCK)
    blk_idx = ops.draw_blocks(torch.Generator().manual_seed(0), block_rounds,
                              K, nblk, "cpu")
    spec = SolverSpec(P=K * ops.BLOCK, rounds=block_rounds)
    res_blk = ops.block_shotgun_solve(prob, spec=spec, blk_idx=blk_idx)
    block_F = res_blk.trace.objective.cpu().numpy()
    print(f"Block-Shotgun (K = {K} blocks of {ops.BLOCK}): "
          f"F = {float(block_F[-1]):.4f}")

    # 2b. the fused multi-round kernel (#1): one launch per 10 rounds, the
    #     margin on chip; the same trajectory as (2)
    res_fus = ops.block_shotgun_solve(
        prob, spec=SolverSpec(P=K * ops.BLOCK, rounds=block_rounds,
                              fused=True),
        blk_idx=blk_idx, rounds_per_launch=ROUNDS_PER_LAUNCH)
    fused_F = res_fus.trace.objective.cpu().numpy()
    gap = abs(float(block_F[-1]) - float(fused_F[-1])) / abs(
        float(fused_F[-1]))
    print(f"fused Block-Shotgun (R = {ROUNDS_PER_LAUNCH}/launch): "
          f"F = {float(fused_F[-1]):.4f} (block vs fused rel. gap "
          f"{gap:.2e})")

    # 3. reference: single-device scalar Shotgun, drawing from seed 1
    ref = shotgun_solve(prob, spec=SolverSpec(P=K * ops.BLOCK,
                                              rounds=block_rounds),
                        idx=draw_coords(torch.Generator().manual_seed(1),
                                        block_rounds, K * ops.BLOCK, prob.d))
    scalar_F = ref.trace.objective.cpu().numpy()
    print(f"scalar Shotgun (P = {K * ops.BLOCK}):      "
          f"F = {float(scalar_F[-1]):.4f}")
    return dict(ranks=world, p_star=ps, P_local=P_local, sharded_F=sharded_F,
                sharded_nnz=sharded_nnz, K=K, block_F=block_F,
                block_nnz=int(res_blk.trace.nnz[-1]), fused_F=fused_F,
                fused_nnz=int(res_fus.trace.nnz[-1]), block_fused_gap=gap,
                scalar_F=scalar_F, scalar_nnz=int(ref.trace.nnz[-1]))


def _rank_main(rank: int, world: int, store: str, sharded_rounds: str,
               block_rounds: str) -> None:
    """One spawned gloo rank on the CPU, running the parent's round
    counts; rank 0 ends its output with the results as one JSON line."""
    from repro_torch.dist.ranks import join_group
    join_group(rank, world, store)
    try:
        out = solve("cpu", int(sharded_rounds), int(block_rounds))
    finally:
        dist.destroy_process_group()
    if out is not None:
        print(RESULT + json.dumps({k: (v.tolist() if hasattr(v, "tolist")
                                       else v) for k, v in out.items()}))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.distributed_shotgun",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda: one NCCL rank on the card (default); cpu: "
                         "--ranks gloo ranks")
    ap.add_argument("--ranks", type=int, default=1,
                    help="gloo ranks on the CPU (one rank on the card)")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    if a.ranks < 1 or (dev.type == "cuda" and a.ranks != 1):
        ap.error("--ranks must be >= 1, and 1 on the card")
    from repro_torch.dist import ranks
    if a.ranks == 1:
        with ranks.one_rank("nccl" if dev.type == "cuda" else "gloo"):
            return solve(dev)
    out = ranks.spawn("repro_torch.examples.distributed_shotgun:_rank_main",
                      a.ranks, str(SHARDED_ROUNDS), str(BLOCK_ROUNDS))[0]
    lines = out.splitlines()
    print("\n".join(ln for ln in lines if not ln.startswith(RESULT)))
    found = [ln for ln in lines if ln.startswith(RESULT)]
    if not found:
        raise RuntimeError(f"rank 0 printed no result:\n{out[-3000:]}")
    return json.loads(found[-1][len(RESULT):])


if __name__ == "__main__":
    main()
