#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the CUDA kernels from the sources in this checkout, holds each kernel
against its plain PyTorch version at the paper's widths, then drives the
port's main path — ``block_shotgun_solve`` — on two legs:

  lint    first, every rule of ``python -m repro_torch.analyze`` over this
          checkout (each compiled instantiation's registers, spills and
          shared memory from the build's report; host syncs, cache entries
          and library reloads on repeated calls; process groups on one
          NCCL rank), held to the port's allowlist, then the
          fault-injection smoke ``repro_torch.dist.faults`` on one NCCL
          rank;
  dense   a Sparco-style Lasso (n = 16384, d = 32768, fused and two-kernel
          rounds, f32 and bf16 A) and a zeta-shaped logistic regression
          with per-block Newton and the divergence guard (n = 500,000,
          d = 2000);
  sparse  BlockedCSC problems at the shapes of LIBSVM's news20.binary
          (S1: Lasso, n = 19,996, d = 1,355,191, density 3.36e-4; fused and
          two-kernel rounds, f32 and bf16 values) and rcv1.binary (S2:
          logistic with per-block Newton and the guard, n = 20,242,
          d = 47,236, density 0.16%), never densified;
  ovf     (``--leg ovf`` runs it alone) kernel #2's overflow
          instantiation on a ``BlockedCSC.from_csc`` design of LIBSVM
          url_combined's shape (n = 2,396,130, d = 3,231,961, 277.1 M
          nonzeros, tile 64, heavy-tailed columns): against its plain
          version on the card, repeated bit for bit, timed beside its
          byte bound and the plain version, then a guarded Newton solve
          through ``block_shotgun_solve`` with its launches counted;
  sharded ``shotgun_sharded_solve`` on one NCCL rank and on two gloo
          ranks sharing the card;
  serve   the batched kernels on stacked slots at the same widths (held
          bit for bit against the unbatched kernels per slot), then
          ``SolverService.serve`` on a dense Lasso stream, an S1 stream and
          a dense stream at λ = 0.5·λ_max whose solves stop early;
  scalar  the paper's own solvers on those problems — scalar Shotgun,
          guarded Shotgun and Shooting on S1, Shotgun and the Eq. 4 form
          on the dense Lasso, Shotgun-CDN and Shooting-CDN on the logistic
          problem (torch code, no kernel) — each held against the CPU on
          the same draws, an S1 and a CDN solve profiled for host syncs;
          then the warm-started λ-path on S1 (``block_fused``, kernel #2)
          and on the dense Lasso;
  baselines the paper's competitors on the dense Lasso and the logistic
          problem (torch code, no kernel): F* by FISTA, SpaRSA, GPSR-BB,
          FPC_AS, L1_LS and IHT; SGD, parallel SGD and SMIDAS — each timed
          beside its byte bound with its idle share and gap to F*,
          profiled for host syncs inside its iterations, repeated bit for
          bit and held against the CPU; and the paper's metric, rounds to
          0.5% of F*, for the dense fused block and scalar Shotgun solves;
  lm      each model in a child process (``--leg lm`` runs
          Qwen3-4B's alone, ``--leg lm --arch A`` another family's): the
          LM serving path ``repro_torch.launch.serve`` (torch code, no
          kernel of its own) on Qwen3-4B — its published widths cut to 2
          layers held against the port on the CPU in f32 and bf16, then
          the server at full width and depth (36 layers, 8 slots of 2048
          positions, 16 prompts of 512 tokens, 64 new tokens each) twice
          with equal tokens and once under a 16-step round deadline, its
          prefill and decode step timed beside their bounds, with the host
          syncs and the device idle share of a decode step; then MiniCPM3-4B
          (MLA, 62 layers, with a deadline stream), Granite-MoE-1B (24
          layers, 1024-token prompts so that prefill takes the MoE capacity
          path) and Mamba2-2.7B (64 layers) served the same way (cut to 2
          layers against the CPU; bf16 MoE logits on the CPU's expert
          picks, whose flips are counted), Whisper-large-v3's encoder
          (1500 stub frames) and 32 decode steps at 32 + 32 layers, and
          Phi-3.5-MoE and Jamba against the CPU at the smoke size (Jamba's
          bf16 layer by layer from the CPU's inputs);
  train   last, the LM training path ``repro_torch.launch.train`` (torch
          code, no kernel of its own), one child a model (``--leg
          train`` runs Qwen3-4B's, ``--leg train --arch
          granite-moe-1b-a400m`` Granite's): Qwen3-4B's published widths
          cut to 2 layers, one train step on the card against one on the
          CPU (loss, grad norm, every grad, the parameters and the
          optimizer state after it) in f32 and bf16, then every smoke
          config with AdamW and with Adafactor; Qwen3-4B at full width and
          depth, 20 steps of 4 x 512 tokens from the loader (falling loss,
          ms a step beside its bound, tokens/s, 6·N·T over the step time,
          idle share, host syncs a step, peak memory); Granite-MoE-1B the
          same (its MoE capacity path backward at 2048 tokens), then a
          kill and resume at the smoke size whose losses must equal the
          uninterrupted run's bit for bit;
  examples the port's five example programs (``repro_torch.examples``,
          one child): ``lm_probe --full`` (Qwen3-4B at full width and
          depth warmed up 20 steps, its mean-pooled final hidden states
          probed by Shotgun-CDN on the card) and its 2-layer cut against
          the CPU; ``train_lm`` stopped and resumed; ``quickstart``,
          ``lasso_paths`` and ``distributed_shotgun`` (one NCCL rank; the
          block solves launch kernels #1, #3 and #4) at their own sizes on
          the card against the same programs on the CPU;
  shard   last, the LM sharding layer (``repro_torch.models.sharding``,
          ``launch/mesh.py``, ``specs.py``, ``dryrun.py``; torch code, no
          kernel of its own), one child a part (``--leg shard --part
          P``): the dry-run of five cells on a fake process group of 256
          ranks (16 x 16) — Qwen3-4B train_4k, prefill_32k, decode_32k,
          Phi-3.5-MoE train_4k, Jamba-1.5-Large long_500k — their
          roofline terms on the H100's data sheet and rank 0's memory, the
          argument bytes held to the specs'; Qwen3-4B at full width cut
          to 12 of its 36 layers on one NCCL rank with every leaf a
          DTensor, served (a
          512-token prefill, 8 decode steps at 8 slots x 2048) in float32
          and bf16, its first grads held leaf by leaf, and trained 3
          steps, against the plain tensors on the card; Granite-MoE-1B at
          full width cut to 6 of its 24 layers on four gloo ranks
          sharing the card as a (data=2, model=2) mesh, after a probe of
          each collective DTensor issues on card tensors under gloo (a
          missing one puts the ranks on CPU tensors, said in the output),
          held in float32 against the one-rank plain run on the card and
          timed in bf16.

The two-kernel pair #3/#4 is timed on three clocks (events, the
profiler's counted records, events behind a spin) beside cuBLAS on a
contiguous copy of the drawn blocks and on their strided views; each call
must make one device record, and its device time is printed over
cuBLAS's on the copy.

One Lasso launch of ``fused_shotgun_rounds`` prints its per-phase
breakdown (the clock of a block that runs no round end, at every barrier).

Data are drawn on the card from ``--seed``.  Any failed check raises, so the script exits non-zero; it also
exits non-zero, printing no result, without a CUDA device or without the
rest of the repository.

Output: informative lines, then a ``{"kernels": [...]}`` JSON line, the
card's name and power limit as nvidia-smi reports them, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores

# Kernel vs plain version on the same inputs.  Both accumulate in f32 (bf16
# A is upcast exactly on both sides) but sum in another order: tile partials
# and shuffle trees against cuBLAS / torch reductions over up to 5·10⁵
# terms.  Float outputs must agree to REL_TOL of their largest magnitude
# (x: of max(1, max|x|)); nnz may move by NNZ_TOL where a coordinate sits on
# the soft-threshold boundary; the health flag must agree exactly.
REL_TOL = 1e-4
NNZ_TOL = 2
# Fused vs two-kernel solve on the same draws: F traces to this rel. error.
TRACE_RTOL = 1e-4

DEVICE = "cuda"
LASSO_N, LASSO_D = 16384, 32768
ZETA_N, ZETA_D = 500_000, 2000
# Sparse leg: LIBSVM news20.binary and rcv1.binary shapes (n, d, density).
S1_N, S1_D, S1_DENSITY = 19_996, 1_355_191, 3.36e-4
S2_N, S2_D, S2_DENSITY = 20_242, 47_236, 0.0016
S1_P, S2_K = 4096, 8                 # S1 drops to the largest K under P*
S1_ROUNDS, S1_TWO_ROUNDS, S2_ROUNDS = 512, 64, 256
# Back-to-back calls per CUDA-event time of the two-kernel pair (#5, #6) and
# its cuSPARSE yardsticks, timed in alternating turns (``paired_ms``): a
# few-µs call is host-bound, so the events read the host's clock, which
# drifts by up to 2x within a run.
PAIR_ITERS = 200
# Sharded leg: rounds of the one-rank solves and of the two-rank solves
# (K per rank: dense 4, S1 half of the single-device K, so P matches).
SH_ROUND_ROUNDS, SH_LAUNCH_ROUNDS, SH_TWO_KERNEL_ROUNDS = 32, 256, 16
SH_DENSE_ROUNDS2, SH_S1_ROUNDS2 = 64, 512
ONE_RANK_BACKEND = "nccl"
# Serve leg: slots of the kernel checks (stacked, shared bf16, zeta, S1,
# S2) and the served streams (requests, repeat share, K, round budgets).
SV_STACK, SV_SHARED, SV_ZETA, SV_S1, SV_S2 = 4, 8, 4, 4, 4
SV_REQUESTS, SV_REPEAT, SV_SLOTS, SV_TOL = 12, 0.5, 4, 1e-4
SV_DENSE_K, SV_DENSE_ROUNDS, SV_SPARSE_ROUNDS = 8, 64, 128
SV_EARLY_LAM = 0.5                   # the early-stop stream's λ / λ_max
# Scalar leg: rounds of the S1 Shotgun / guarded / Shooting solves, of the
# dense Shotgun and Eq. 4 solves, of the CDN solves and its P; the path's
# λ count and rounds per λ (S1 block_fused, dense Lasso shotgun); the
# rounds held against the port on the CPU; the guarded run's P / P*.
SC_S1_ROUNDS, SC_DENSE_ROUNDS, SC_CDN_ROUNDS, SC_CDN_P = 256, 128, 64, 8
SC_PATH_LAMBDAS, SC_PATH_ROUNDS, SC_DENSE_PATH_ROUNDS = 10, 64, 32
SC_CPU_ROUNDS, SC_GUARD_FACTOR = 16, 16
# Baselines leg: FISTA's iterations for F* (``f_star``'s default); the
# iterations of SpaRSA, GPSR-BB and IHT; FPC_AS's IST sweeps, CG
# iterations and cycles; L1_LS's barrier weights (two Newton steps each);
# SGD's rates (every 4th of the paper's 14) and steps a rate, parallel
# SGD's K, SMIDAS's steps and rate; the iterations and steps held against
# the CPU and run under the profiler; the small Lasso (n, d) on which
# FPC_AS and L1_LS are held against the CPU; the certificate: no solver
# may end more than BL_CERT·|F*| below F*.
BL_FSTAR_ITERS, BL_ITERS, BL_FPC, BL_L1LS_OUTER = 4000, 200, (50, 20, 4), 12
BL_SGD_RATE_STRIDE, BL_SGD_STEPS, BL_PSGD_K = 4, 2000, 8
BL_SMIDAS_STEPS, BL_SMIDAS_ETA = 1000, 0.005
BL_CPU_ITERS, BL_CPU_STEPS, BL_PROFILE_ITERS = 3, 200, 10
BL_SMALL_N, BL_SMALL_D, BL_CERT = 1024, 2048, 1e-4
# LM leg: each model's full widths cut to 2 layers against the CPU (2 rows,
# a LM_PROMPT-token prefill, LM_DECODE per-slot decode steps; logits to
# LM_F32_TOL / LM_BF16_TOL of their largest magnitude — the bf16 tolerance is
# the reference's own decode test's); then the server: slots, positions a
# slot, new tokens, requests, and the deadline stream's evictions allowed.
LM_ARCH, LM_SMOKE = "qwen3-4b", False
LM_CPU_LAYERS, LM_PROMPT, LM_DECODE = 2, 16, 4
LM_F32_TOL, LM_BF16_TOL = 1e-4, 2e-2
LM_SLOTS, LM_MAX_LEN = 8, 2048
LM_MAX_NEW, LM_REQUESTS = 64, 16
LM_DEADLINE, LM_MAX_EVICTIONS = 16, 4
BF16_FLOPS_PER_S = 989e12    # H100 SXM dense bf16 tensor cores (data sheet)
LM_STEP_RANGE = "chip_smoke.lm_step"  # a whole ``Engine.step``, profiled
# The LM models, each in its own child (``--leg lm --arch A``), in this
# order.  Served at full width and depth with their prompt tokens and round
# deadline (None: no deadline stream — a re-prefilled context of prompt +
# generated tokens trips the reference's own errors, Mamba-2's for a
# length off its 128-token chunk, MoE's for an odd token count):
FAM_SERVED = {LM_ARCH: (512, LM_DEADLINE),
              "minicpm3-4b": (512, LM_DEADLINE),
              "granite-moe-1b-a400m": (1024, None),
              "mamba2-2.7b": (512, None)}
# Whisper-large-v3 at full width and depth (the reference's ``serve``
# refuses encoder-decoder configs): a prefill of rows of WH_PROMPT tokens
# over encoder_seq stub frames drawn from --seed into a WH_CACHE-position
# cache, then WH_STEPS greedy decode steps; run twice.
FAM_WHISPER = "whisper-large-v3"
WH_ROWS, WH_PROMPT, WH_CACHE, WH_STEPS = 2, 16, 448, 32
# Held against the CPU at the smoke size only: at full width one card does
# not hold their experts (Phi-3.5-MoE ≈ 80.5 GB, Jamba-1.5-Large ≈ 19.3 GB
# a MoE layer).
FAM_SMOKE = ("phi3.5-moe-42b-a6.6b", "jamba-1.5-large-398b")
LM_FAMILIES = (*FAM_SERVED, FAM_WHISPER, *FAM_SMOKE)
# Train leg: the models trained at full width and depth, each in its own
# child (``--leg train --arch A``; the first also runs the CPU checks), the
# rows, tokens a row, steps and learning rate of those runs; the CPU
# checks' rows and tokens; the kill-and-resume's arguments (the
# reference's tests/test_ckpt_and_fault_tolerance.py:70 run); cuBLAS's
# workspace for deterministic algorithms, set before the child's first
# cuBLAS call.
TRAIN_ARCHS = (LM_ARCH, "granite-moe-1b-a400m")
TRAIN_ROWS, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 4, 512, 20, 1e-3
TRAIN_CHECK_ROWS, TRAIN_CHECK_SEQ, TRAIN_CHECK_LR = 2, 16, 1e-3
TRAIN_RESUME = dict(smoke=True, steps=9, batch=2, seq=16, lr=1e-3,
                    save_every=3, log_every=100)
TRAIN_RANGE = "chip_smoke.train_step"   # one training step, profiled
CUBLAS_CONFIG = ":4096:8"
# Shard leg, last, one child a part (``--leg shard --part P``): the dry-run
# cells measured on a fake process group of 256 ranks (16 x 16); Qwen3-4B
# on one NCCL rank with every leaf a DTensor (slots, positions a slot, the
# prefill's tokens, decode steps; train rows, tokens a row, steps); and
# Granite-MoE-1B on four gloo ranks sharing the card as a (data=2,
# model=2) mesh (its slots, prefill tokens, decode steps; one train step
# of the train rows and tokens), held to SH4_TOL of each leaf's largest
# against the one-rank plain run on the card in float32.  The functional
# collectives DTensor issues, each probed on card tensors under gloo.
SHARD_CELLS = (("qwen3-4b", "train_4k"), ("qwen3-4b", "prefill_32k"),
               ("qwen3-4b", "decode_32k"), ("phi3.5-moe-42b-a6.6b",
                                            "train_4k"),
               ("jamba-1.5-large-398b", "long_500k"))
SHARD_PARTS = ("dryrun", "one", "four")
SH1_SLOTS, SH1_MAX_LEN, SH1_PROMPT, SH1_DECODE = 8, 2048, 512, 8
SH1_LAYERS = 12          # of Qwen3-4B's 36: the time limit's cut of depth
SH1_TRAIN_ROWS, SH1_TRAIN_SEQ, SH1_TRAIN_STEPS = 4, 512, 3
SH1_F32_TOL, SH1_BF16_TOL = 1e-5, 2e-2
SH4_ARCH, SH4_SLOTS, SH4_PROMPT, SH4_DECODE = "granite-moe-1b-a400m", 4, 256, 8
SH4_LAYERS = 6           # of Granite's 24: the time limit's cut of depth
SH4_TRAIN_ROWS, SH4_TRAIN_SEQ, SH4_TOL = 4, 512, 1e-4
SH4_COLLECTIVES = ("reduce_scatter_tensor", "all_reduce",
                   "all_to_all_single", "broadcast", "all_gather_into_tensor")
# Examples leg (``--leg examples``), one child: the example programs of
# ``repro_torch.examples`` through their ``main``.  The solver examples on
# the card against the CPU: P* equal, ρ and F traces to EX_RTOL of each
# entry, final nnz within EX_NNZ_TOL, block against fused to EX_GAP;
# train_lm for EX_TRAIN_STEPS steps saving every EX_SAVE_EVERY, stopped
# after EX_FAIL_AT and resumed; lm_probe's cut against the CPU:
# EX_CUT_WARMUP warm-up steps, EX_CUT_BATCHES feature batches of
# EX_CUT_ROWS rows, EX_CUT_ROUNDS CDN rounds.
EX_RTOL, EX_NNZ_TOL, EX_GAP = 1e-4, 1, 1e-5
EX_RISE = 1e-6           # a CDN round's F may rise by rounding, no more
EX_TRAIN_STEPS, EX_SAVE_EVERY, EX_FAIL_AT = 60, 25, 30
EX_CUT_WARMUP, EX_CUT_BATCHES, EX_CUT_ROWS, EX_CUT_ROUNDS = 2, 2, 4, 200
# Host syncs (none may fall inside an unguarded scalar solve's rounds or a
# baseline's iterations) are counted from the lint's one list,
# ``repro_torch.analyze.trace_checks.SYNC_CALLS`` and any ``*Synchronize``
# record (``is_sync``), by its ``syncs_of``.


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` from CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(fa, fb, iters: int, reps: int = 5) -> tuple[float, float]:
    """``time_ms`` of two calls in alternating turns (a b, b a, ...): the
    median of each over ``reps`` turns, so that a drift of the host clock
    reaches both alike."""
    ta, tb = [], []
    for rep in range(reps):
        for which in ((0, 1) if rep % 2 == 0 else (1, 0)):
            (ta, tb)[which].append(time_ms((fa, fb)[which], iters))
    return statistics.median(ta), statistics.median(tb)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(got, want, floor: float = 0.0) -> tuple[float, float]:
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    scale = max(float(want.abs().max()), floor)
    return err, err / scale if scale > 0 else err


def draws(rounds, K, nblk, g, dup=True):
    """(rounds, K) int32 block indices: K distinct per round, plus one
    duplicate draw in the middle round (multiset semantics)."""
    u = torch.rand(rounds, nblk, generator=g, device=g.device)
    idx = u.argsort(dim=-1)[:, :K].to(torch.int32)
    if dup and K > 1:
        idx[rounds // 2, -1] = idx[rounds // 2, 0]
    return idx


def device_busy(fn, kernels: tuple[str, ...] = ()):
    """Run ``fn`` under torch.profiler; return (device busy ms, span ms from
    the first device activity to the last, device events, summed device ms
    and count of the events whose names contain one of ``kernels``).  Busy
    is the union of the device intervals, so idle share = 1 - busy /
    span."""
    return busy_of(profiled_events(fn), kernels)


def profiled_events(fn):
    """The profiler's events over one call of ``fn`` (CPU and device)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.005)      # no device record at the window's edges
        fn()
        torch.cuda.synchronize()
        time.sleep(0.005)
    return prof.events()


def busy_of(all_events, kernels: tuple[str, ...] = ()):
    """``device_busy``'s five numbers from a profiler window's events."""
    # a ``record_function`` range shows on the device timeline too, as an
    # annotation spanning everything inside it: not device activity
    events = [e for e in all_events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.name.startswith("repro_torch.")]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur = 0.0, None
    for a, b in spans:
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    span = spans[-1][1] - spans[0][0] if spans else 0.0
    mine = [e.time_range.end - e.time_range.start for e in events
            if any(k in e.name for k in kernels)]
    return busy / 1e3, span / 1e3, len(spans), sum(mine) / 1e3, len(mine)


# Worst (max_abs_err, max_rel_err) of each kernel against its plain version.
WORST: dict[str, list[float]] = {}


def check(name, tag, pairs, nnz_pair=None, health_pair=None):
    """Hold a kernel's outputs against its plain version's; raise on a
    miss.  ``pairs``: (what, got, want, floor of the relative scale)."""
    worst = WORST.setdefault(name, [0.0, 0.0])
    for what, got, want, floor in pairs:
        err, rel = rel_err(got, want, floor)
        worst[0], worst[1] = max(worst[0], err), max(worst[1], rel)
        print(f"check {name} [{tag}] {what}: max_abs_err {err:.3e} "
              f"rel {rel:.3e}")
        require(rel <= REL_TOL, f"{name} [{tag}] {what}: rel err {rel:.3e}"
                f" > {REL_TOL}")
    if nnz_pair is not None:
        dn = int((nnz_pair[0] - nnz_pair[1]).abs().max())
        require(dn <= NNZ_TOL, f"{name} [{tag}] nnz differs by {dn}")
    if health_pair is not None:
        require(float(health_pair[0]) == float(health_pair[1]),
                f"{name} [{tag}] health {float(health_pair[0])} vs "
                f"{float(health_pair[1])}")


def require_repeat(fn, what):
    """Two runs of ``fn`` give bit-identical outputs."""
    a, b = fn(), fn()
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    require(all(torch.equal(u, v) for u, v in zip(a, b)),
            f"{what}: repeat not bit-identical")
    print(f"check {what}: repeat bit-identical")


def run_solve(label, ops, health, prob, spec, launches, fused_name,
              two_names, bytes_per_round, R, runs, **kw):
    """Drive ``block_shotgun_solve`` once; print time, trace and launches;
    check F, status, shapes and the launch count of the path."""
    before = dict(launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ops.block_shotgun_solve(prob, spec=spec, **kw)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    got = {k: launches[k] - before[k] for k in before}
    f = res.trace.objective.cpu()
    nnz = res.trace.nnz.cpu()
    status = int(res.status)
    gbs = spec.rounds * bytes_per_round / sec / 1e9
    print(f"solve {label}: {spec.rounds} rounds in {sec * 1e3:.2f} ms "
          f"({sec / spec.rounds * 1e3:.4f} ms/round, "
          f"{spec.rounds / sec:.1f} rounds/s, {gbs:.1f} GB/s of drawn "
          f"blocks counted once per round); status "
          f"{health.STATUS_NAMES[status]}; launches {got}")
    marks = sorted({0, 1, R - 1, len(f) // 2, len(f) - 1})
    print(f"trace {label}: " + ", ".join(
        f"F[{i}]={float(f[i]):.7g} nnz={int(nnz[i])}" for i in marks))
    require(bool(torch.all(torch.isfinite(f))), f"{label}: non-finite F")
    require(float(f[-1]) < float(f[0]), f"{label}: F did not decrease")
    require(status == health.STATUS_OK, f"{label}: status {status}")
    require(res.x.shape == (prob.d,) and res.z.shape == (prob.n,),
            f"{label}: result shapes {res.x.shape} {res.z.shape}")
    if spec.fused:
        require(got[fused_name] == spec.rounds // R,
                f"{label}: {got} != rounds/R = {spec.rounds // R}")
    else:
        require(all(got[k] == spec.rounds for k in two_names),
                f"{label}: {got} != {spec.rounds} rounds")
    runs.append(dict(label=label, ms_per_round=sec / spec.rounds * 1e3,
                     rounds_per_s=spec.rounds / sec, gb_per_s=gbs,
                     status=health.STATUS_NAMES[status]))
    return res


def trace_rel(a, b) -> float:
    """Largest |a - b| / |b| over two traces (tensors, arrays or numbers)."""
    a = torch.as_tensor(a).cpu().double()
    b = torch.as_tensor(b).cpu().double()
    return float(((a - b).abs() / b.abs()).max())


def device_ms(fn, kernels: tuple[str, ...] | None, iters: int,
              per_call: int = 1) -> float | None:
    """Device time per call of ``fn`` from the profiler over ``iters`` calls
    (after a warm-up): the summed duration of the device records whose
    names contain one of ``kernels`` (``per_call`` launches of them a call)
    or, with ``kernels=None``, of every device record in the window — all
    the call enqueues (kernels, memsets, copies), as many a call as one
    profiled call shows.  A window short of records is retried and reported
    (``repro_torch.kernels._compare.device_ms``).  For a kernel of a few
    microseconds the CUDA-event time of back-to-back calls is set by the
    host enqueue, not by the device."""
    from repro_torch.kernels import _compare
    return _compare.device_ms(fn, iters, kernels or (),
                              per_call if kernels else None)


def queued_ms(fn, iters: int) -> float:
    """Device time per call of ``fn`` from CUDA events around each call,
    enqueued behind a spin kernel so that the host's enqueue is hidden
    (``repro_torch.kernels._compare.queued_ms``): every device op of the
    call, on a clock apart from the profiler's."""
    from repro_torch.kernels import _compare
    return _compare.queued_ms(fn, iters)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--leg", choices=["lm", "train", "shard", "examples",
                                      "ovf"],
                    default=None,
                    help="run only this leg (no build) and print its JSON")
    ap.add_argument("--arch", choices=LM_FAMILIES, default=LM_ARCH,
                    help="with --leg lm or train: the model to run")
    ap.add_argument("--part", choices=SHARD_PARTS, default="dryrun",
                    help="with --leg shard: the part to run")
    args = ap.parse_args()
    if args.leg in ("train", "shard", "examples"):
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_CONFIG)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run "
              "from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    if args.leg == "lm":
        print(json.dumps(family_leg(args)))
        return 0
    if args.leg == "train":
        print(json.dumps(train_leg(args)))
        return 0
    if args.leg == "shard":
        print(json.dumps(SHARD_PART[args.part](args)))
        return 0
    if args.leg == "examples":
        print(json.dumps(examples_leg(args)))
        return 0
    if args.leg == "ovf":
        ovf_kernels, ovf_json = ovf_leg(args)
        print(json.dumps(ovf_json))
        print(json.dumps({"kernels": ovf_kernels}))
        print(nvidia_smi_line())
        return 0
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"device: {kind}; count {torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"nvidia-smi: {smi}")

    # ---- build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s wall "
          f"(nvcc {_build.build_info['seconds']:.1f} s, one nvcc per source "
          "in parallel, then the link)")
    for line in _build.build_info["ptxas"].splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")
    for prefix, grid_fn in (("batched", lib.sb_batched_grid_blocks),
                            ("batched sparse", lib.sp_batched_grid_blocks)):
        for a16 in (0, 1):
            for code, name in enumerate(("lasso", "logistic", "lasso_newton",
                                         "logistic_newton")):
                blocks = grid_fn(a16, code)
                require(blocks > 0, f"{prefix} cooperative grid for {name}: "
                        f"{blocks}")
                print(f"{prefix} grid: {'bf16' if a16 else 'f32'} {name}: "
                      f"{blocks} blocks x 256 threads")
    for prefix, grid_fn in (("fused", lib.sb_fused_grid_blocks),
                            ("fused sparse", lib.sp_fused_grid_blocks)):
        for a16 in (0, 1):
            for code, name in enumerate(("lasso", "logistic", "lasso_newton",
                                         "logistic_newton", "delta lasso",
                                         "delta logistic",
                                         "delta lasso_newton",
                                         "delta logistic_newton")):
                blocks = grid_fn(a16, code)
                require(blocks > 0, f"{prefix} cooperative grid for {name}: "
                        f"{blocks}")
                print(f"{prefix} grid: {'bf16' if a16 else 'f32'} {name}: "
                      f"{blocks} blocks x 256 threads")

    lint_json = lint_leg()
    dense_kernels, dense_json, dense_data = dense_leg(args)
    sparse_kernels, sparse_json, sparse_data = sparse_leg(args)
    ovf_kernels, ovf_json = ovf_leg(args)
    sharded_kernels, sharded_json = sharded_leg(args, dense_data, sparse_data,
                                                dense_json, sparse_json)
    serve_kernels, serve_json = serve_leg(args, dense_data, sparse_data)
    scalar_json, scalar_data = scalar_leg(args, dense_data, sparse_data)
    baselines_json = baselines_leg(args, dense_data, scalar_data)
    del dense_data, sparse_data, scalar_data
    release_card("the LM legs")
    lm_json = lm_leg_child(args)
    train_json = train_leg_child(args)
    examples_json = examples_leg_child(args)
    shard_json = shard_leg_child(args)

    # ---- report -----------------------------------------------------------
    print(json.dumps({**lint_json, **dense_json, **sparse_json, **ovf_json,
                      **sharded_json, **serve_json, **scalar_json,
                      **baselines_json, **lm_json, **train_json,
                      **examples_json, **shard_json}))
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(json.dumps({"kernels": dense_kernels + sparse_kernels
                      + ovf_kernels + sharded_kernels + serve_kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def lint_leg() -> dict:
    """The lint leg, after the build: every compiled instantiation's
    registers, spills and static shared memory from the build's saved
    report, then ``python -m repro_torch.analyze --all`` over this checkout
    with the port's allowlist (SL101 reads that report and compiles nothing
    again; SL102 and SL103 probe the card), then the fault-injection smoke
    ``python -m repro_torch.dist.faults`` on one NCCL rank.  Both run in
    child processes: SL102 opens many profiler windows, after which this
    process's profiler returned no device records to the dense leg.
    Raises on any finding not on the allowlist, on any stale allowlist
    entry and on a smoke that misses 0.5% of F* or whose faults were not
    met and repaired (its fault-free twin's F, its no-retry twin's guard
    trip)."""
    import os
    import re

    from repro_torch.analyze import trace_checks
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    usage = trace_checks.parse_ptxas(_build.build_info["ptxas"])
    kernels = {n: u for n, u in usage.items() if u.registers >= 0}
    require(kernels, "lint: the build's report lists no kernel")
    for name, u in sorted(kernels.items()):
        print(f"lint instantiation {name}: {u.registers} registers, "
              f"{u.spill_stores} B spill stores, {u.spill_loads} B spill "
              f"loads, {u.smem} B static shared memory")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

    def child(module, *argv):
        out = subprocess.run([sys.executable, "-m", module, *argv], env=env,
                             capture_output=True, text=True, timeout=600)
        lines = [ln for ln in (out.stdout + out.stderr).splitlines()
                 if not ln.startswith("USDT")]
        return out.returncode, lines

    rc, lines = child("repro_torch.analyze", "--all")
    for ln in lines:
        if "SL" in ln or ln.startswith(("note:", "repro_torch lint:")):
            print(f"lint: {ln}")
    summary = [ln for ln in lines if ln.startswith("repro_torch lint:")]
    require(rc == 0 and summary, f"lint: exit {rc}: {lines[-20:]}")
    counts = re.search(r"(\d+) finding\(s\), (\d+) allowlisted, (\d+) stale",
                       summary[0])
    t1 = time.perf_counter()
    rc, lines = child("repro_torch.dist.faults")
    for ln in lines:
        print(f"fault smoke: {ln}")
    smoke = [re.search(r"ranks=(\d+) F\*=(\S+) F=(\S+) gap=(\S+)% "
                       r"status=(\w+)", ln) for ln in lines]
    smoke = [m for m in smoke if m]
    require(rc == 0 and smoke, f"fault smoke: exit {rc}: {lines[-20:]}")
    t2 = time.perf_counter()
    print(f"lint leg: {t2 - t0:.1f} s (rules {t1 - t0:.1f} s, fault smoke "
          f"{t2 - t1:.1f} s, each in a child process)")
    ranks, fstar, f, gap, status = smoke[0].groups()
    return {"lint": dict(instantiations=len(kernels),
                         spilling=sum(1 for u in kernels.values()
                                      if u.spill_stores or u.spill_loads),
                         findings=int(counts.group(1)),
                         vetted=int(counts.group(2)),
                         stale=int(counts.group(3)), seconds=t1 - t0),
            "fault_smoke": dict(ranks=int(ranks), fstar=float(fstar),
                                f=float(f), gap_pct=float(gap),
                                status=status, seconds=t2 - t1)}


def kernel_entry(name, source, replaces, launches, t, shape):
    b, by = t["bound"]
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=WORST[name][0],
                max_rel_err=WORST[name][1], ms=t["ms"],
                plain_ms=t["plain_ms"], bound_ms=b, bound_by=by,
                library_ms=t.get("library_ms"), device_ms=t.get("device_ms"),
                queued_ms=t.get("queued_ms"),
                library_device_ms=t.get("library_device_ms"), shape=shape)


def dense_leg(args):
    """The dense leg: kernels #1, #3, #4 against their plain versions, their
    times, and the dense main path."""
    from repro_torch.core import health
    from repro_torch.core import objectives as obj
    from repro_torch.core.health import GuardConfig
    from repro_torch.core.spec import SolverSpec
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import _compare, ops
    from repro_torch.kernels import shotgun_block as sb

    dev = torch.device(DEVICE)
    # ---- data on the card -------------------------------------------------
    t0 = time.perf_counter()
    A, y, _ = syn.sparco_on_device(args.seed, n=LASSO_N, d=LASSO_D,
                                   device=dev)
    lasso = obj.make_problem(A, y, 1.0, device=dev)
    del A
    lasso = lasso._replace(lam=0.1 * obj.lambda_max(lasso.A, lasso.y,
                                                     "lasso"))
    A, y, _ = syn.logistic_data_on_device(args.seed + 1, n=ZETA_N, d=ZETA_D,
                                          device=dev)
    zeta = obj.make_problem(A, y, 1.0, loss="logistic", device=dev)
    del A
    zeta = zeta._replace(lam=0.1 * obj.lambda_max(zeta.A, zeta.y,
                                                   "logistic"))
    La, Ly, Lm = ops.pad_problem(lasso.A, lasso.y)
    Za, Zy, Zm = ops.pad_problem(zeta.A, zeta.y)
    torch.cuda.synchronize()
    print(f"data: lasso A {tuple(La.shape)} lam {float(lasso.lam):.6g}; "
          f"zeta A {tuple(Za.shape)} lam {float(zeta.lam):.6g}; "
          f"{time.perf_counter() - t0:.1f} s")
    La16, Za16 = La.to(torch.bfloat16), Za.to(torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(args.seed + 2)
    R = 8

    # ---- each kernel against its plain version at these widths -----------
    cases = [("lasso", La, Ly, Lm, lasso, 8), ("zeta", Za, Zy, Zm, zeta, 2)]
    for tag, A, yv, m, prob, K in cases:
        nblk = A.shape[1] // sb.BLOCK
        idx = draws(1, K, nblk, g)[0]
        idx[-1] = idx[0]                                  # duplicate block
        r = torch.randn(A.shape[0], generator=g, device=dev) * m
        dl = torch.randn(K, sb.BLOCK, generator=g, device=dev) * 0.01
        for store, AA in (("f32", A), ("bf16", La16 if tag == "lasso" else Za16)):
            t = f"{tag} {store} K={K}"
            check("gather_block_matvec", t, [(
                "g", sb.gather_block_matvec(AA, r, idx),
                sb.gather_block_matvec_plain(AA, r, idx), 0.0)])
            check("scatter_block_update", t, [(
                "z", sb.scatter_block_update(AA, r, idx, dl),
                sb.scatter_block_update_plain(AA, r, idx, dl), 0.0)])
            require_repeat(lambda: sb.gather_block_matvec(AA, r, idx),
                           f"gather_block_matvec [{t}]")
            require_repeat(lambda: sb.scatter_block_update(AA, r, idx, dl),
                           f"scatter_block_update [{t}]")

    fused_cases = [("lasso", "lasso", 0), ("logistic", "zeta", 1),
                   ("logistic_newton", "zeta", 1)]
    for loss, tag, ci in fused_cases:
        _, A, yv, m, prob, K = cases[ci]
        nblk = A.shape[1] // sb.BLOCK
        idx = draws(R, K, nblk, g)
        x0 = torch.randn(A.shape[1], generator=g, device=dev) * 0.01
        for store, AA in (("f32", A), ("bf16", La16 if tag == "lasso" else Za16)):
            z0 = AA.float() @ x0
            for k_eff in (None, K - 1):
                t = f"{loss} {tag} {store} K={K} R={R} k_eff={k_eff}"
                fargs = (AA, z0, x0, idx, prob.lam, prob.beta, yv, m)
                got = sb.fused_shotgun_rounds(*fargs, loss=loss, k_eff=k_eff)
                want = sb.fused_shotgun_rounds_plain(*fargs, loss=loss,
                                                     k_eff=k_eff)
                check("fused_shotgun_rounds", t,
                      [("x", got[0], want[0], 1.0), ("z", got[1], want[1], 0.0),
                       ("f", got[2], want[2], 0.0)],
                      nnz_pair=(got[3], want[3]), health_pair=(got[4], want[4]))
                require_repeat(lambda: sb.fused_shotgun_rounds(
                    *fargs, loss=loss, k_eff=k_eff),
                    f"fused_shotgun_rounds [{t}]")

    # ---- kernel times at the main path's shapes ---------------------------
    def kernel_times(A, yv, m, prob, K, loss, iters):
        n, d = A.shape
        ab = A.element_size()
        nblk = d // sb.BLOCK
        idx = draws(R, K, nblk, g, dup=False)
        x0 = torch.zeros(d, device=dev)
        z0 = torch.zeros(n, device=dev)
        r = torch.randn(n, generator=g, device=dev) * m
        dl = torch.randn(K, sb.BLOCK, generator=g, device=dev) * 0.01
        fargs = (A, z0, x0, idx, prob.lam, prob.beta, yv, m)
        newton = 1 if sb.resolve_loss(loss).newton else 0
        out = {}
        blk_bytes = K * n * sb.BLOCK * ab
        fused = lambda: sb.fused_shotgun_rounds(*fargs, loss=loss)  # noqa: E731
        out["fused_shotgun_rounds"] = dict(
            ms=time_ms(fused, iters),
            device_ms=device_ms(fused, ("fused_rounds_kernel",), iters),
            plain_ms=time_ms(lambda: sb.fused_shotgun_rounds_plain(
                *fargs, loss=loss), max(2, iters // 4), warmup=1),
            bound=bound(R * blk_bytes + 4 * (4 * n + 2 * d) + 8 * R,
                        R * (4 + 3 * newton) * K * n * sb.BLOCK))
        # the two-kernel pair against cuBLAS: on a contiguous (n, K·128)
        # copy of the drawn blocks, gathered outside any timing (the
        # library column), and as K calls on the strided block views the
        # kernels read (no copy); timed, checked, never used by the port
        i0 = idx[0].clone()
        views = [A[:, b * sb.BLOCK:(b + 1) * sb.BLOCK] for b in i0.tolist()]
        Ac = torch.cat(views, dim=1)
        d_flat = dl.reshape(-1)
        gather = lambda: sb.gather_block_matvec(A, r, i0)  # noqa: E731
        scatter = lambda: sb.scatter_block_update(A, z0, i0, dl)  # noqa: E731
        lib_mv = lambda: torch.mv(Ac.t(), r)  # noqa: E731
        lib_addmv = lambda: torch.addmv(z0, Ac, d_flat)  # noqa: E731

        def strided_mv():
            return torch.stack([torch.mv(v.t(), r) for v in views])

        def strided_addmv():
            z = z0
            for v, dk in zip(views, dl):
                z = torch.addmv(z, v, dk)
            return z

        for what, got, want in (
                ("cuBLAS mv on the copy", lib_mv().reshape(K, sb.BLOCK),
                 gather()),
                ("K cuBLAS mv on the strided blocks", strided_mv(), gather()),
                ("cuBLAS addmv on the copy", lib_addmv(), scatter()),
                ("K cuBLAS addmv on the strided blocks", strided_addmv(),
                 scatter())):
            err, rel = rel_err(got, want)
            print(f"check yardstick [{loss} n={n} d={d} K={K}] {what} "
                  f"against the kernel: max_abs_err {err:.3e} rel {rel:.3e}")
            require(rel <= REL_TOL, f"yardstick {what}: rel err {rel:.3e}")
        g_ms, mv_ms = paired_ms(gather, lib_mv, PAIR_ITERS)
        s_ms, addmv_ms = paired_ms(scatter, lib_addmv, PAIR_ITERS)
        out["gather_block_matvec"] = dict(
            ms=g_ms,
            plain_ms=time_ms(lambda: sb.gather_block_matvec_plain(
                A, r, i0), iters),
            library_ms=mv_ms,
            bound=bound(blk_bytes + 4 * n + 4 * K + 4 * K * sb.BLOCK,
                        2 * K * n * sb.BLOCK))
        out["scatter_block_update"] = dict(
            ms=s_ms,
            plain_ms=time_ms(lambda: sb.scatter_block_update_plain(
                A, z0, i0, dl), iters),
            library_ms=addmv_ms,
            bound=bound(blk_bytes + 8 * n + 4 * K + 4 * K * sb.BLOCK,
                        2 * K * n * sb.BLOCK))
        # every device op of a call, its records counted (one a call: the
        # launch and nothing else); the same calls queued behind a spin;
        # the yardsticks on the profiler's clock, and the kernel's device
        # time over cuBLAS's on the copy
        for name, fn, lib, strided in (
                ("gather_block_matvec", gather, lib_mv, strided_mv),
                ("scatter_block_update", scatter, lib_addmv,
                 strided_addmv)):
            t = out[name]
            recs = _compare.records_per_call(fn)
            print(f"check {name} [{loss} n={n} d={d} K={K}]: {recs} device "
                  f"record(s) a call")
            require(recs == 1, f"{name} [{loss} n={n} d={d} K={K}]: {recs} "
                    f"device records a call, not one")
            t["device_ms"] = device_ms(fn, None, PAIR_ITERS)
            t["queued_ms"] = queued_ms(fn, PAIR_ITERS)
            t["library_device_ms"] = device_ms(lib, None, PAIR_ITERS)
            t["strided_ms"] = time_ms(strided, iters)
            t["strided_device_ms"] = device_ms(strided, None, iters)
            if t["device_ms"] and t["library_device_ms"]:
                t["device_over_library"] = (t["device_ms"]
                                            / t["library_device_ms"])
                print(f"ratio {name} [{loss} n={n} d={d} K={K}]: device "
                      f"{t['device_ms']:.4f} ms over cuBLAS on the copy "
                      f"{t['library_device_ms']:.4f} ms = "
                      f"{t['device_over_library']:.3f}")
        return out

    t_lasso = kernel_times(La, Ly, Lm, lasso, 8, "lasso", 20)
    t_zeta = kernel_times(Za, Zy, Zm, zeta, 2, "logistic_newton", 10)
    lasso_shape = f"lasso f32 n={La.shape[0]} d={La.shape[1]} K=8"
    print_times(((lasso_shape + f" R={R}", t_lasso),
                 (f"zeta f32 n={Za.shape[0]} d={Za.shape[1]} K=2 R={R} "
                  "logistic_newton", t_zeta)))

    # ---- #1's phases ------------------------------------------------------
    pidx = draws(R, 8, La.shape[1] // sb.BLOCK, g, dup=False)
    pz, px = torch.zeros(La.shape[0], device=dev), torch.zeros(La.shape[1],
                                                                device=dev)
    phases = dense_phases(
        lambda st: sb.fused_shotgun_rounds(La, pz, px, pidx, lasso.lam, 1.0,
                                           Ly, Lm, loss="lasso", stamps=st),
        t_lasso["fused_shotgun_rounds"]["device_ms"]
        or t_lasso["fused_shotgun_rounds"]["ms"], R, dev)
    print(f"phases fused_shotgun_rounds [{lasso_shape} R={R}]: " + "; ".join(
        f"{k[:-3]} {v * 1e3:.2f} us" for k, v in phases.items()
        if k not in ("launch_ms",)))

    # ---- the main path (dense leg) ----------------------------------------
    runs = []

    def solve(label, prob, spec, **kw):
        K = max(1, -(-spec.P // sb.BLOCK))
        rows = prob.n + (-prob.n) % sb.TILE_N
        return run_solve(label, ops, health, prob, spec, sb.LAUNCHES,
                         "fused_shotgun_rounds",
                         ("gather_block_matvec", "scatter_block_update"),
                         K * rows * sb.BLOCK * prob.A.element_size(), R, runs,
                         **kw)

    lasso_idx = draws(256, 8, LASSO_D // sb.BLOCK, g, dup=False)
    spec = SolverSpec(loss="lasso", P=1024, rounds=256, fused=True)
    zeta_spec = SolverSpec(loss="logistic", P=256, rounds=64, fused=True,
                           newton=True, guard=GuardConfig())
    sb.reset_launches()
    fused = solve("lasso fused f32", lasso, spec, blk_idx=lasso_idx)
    two = solve("lasso two-kernel f32", lasso,
                SolverSpec(loss="lasso", P=1024, rounds=32),
                blk_idx=lasso_idx[:32])
    solve("lasso fused bf16", lasso._replace(A=lasso.A.to(torch.bfloat16)),
          spec, blk_idx=lasso_idx)
    solve("zeta logistic newton guarded fused f32", zeta, zeta_spec,
          generator=torch.Generator(device=dev).manual_seed(args.seed + 3))
    counts = {k: sb.LAUNCHES[k] for k in (
        "fused_shotgun_rounds", "gather_block_matvec", "scatter_block_update")}
    print(f"main path launches (dense leg): {counts}")
    require(all(v > 0 for v in counts.values()),
            f"a kernel of the dense leg never launched: {counts}")

    # Fused and two-kernel rounds on the same draws follow one trajectory.
    rel = trace_rel(fused.trace.objective[:32], two.trace.objective)
    print(f"check fused vs two-kernel F trace (32 rounds, same draws): "
          f"max rel {rel:.3e}")
    require(rel <= TRACE_RTOL, f"fused vs two-kernel trace rel {rel:.3e}")

    # Device busy share over a fused solve (profiler; outside the counts).
    for label, prob, spec_, kw in (
            ("lasso fused f32", lasso, spec, dict(blk_idx=lasso_idx)),
            ("zeta logistic newton guarded fused f32", zeta, zeta_spec,
             dict(generator=torch.Generator(device=dev).manual_seed(1)))):
        print_busy(label, lambda: ops.block_shotgun_solve(prob, spec=spec_,
                                                          **kw))
    # Who sets the pace of the two-kernel solve: its host ms/round beside
    # #3 + #4's device ms/round and the device's idle share (a profiled
    # rerun of the same solve).
    two_spec = SolverSpec(loss="lasso", P=1024, rounds=32)
    busy, span, n_ev, kms, kn = device_busy(
        lambda: ops.block_shotgun_solve(lasso, spec=two_spec,
                                        blk_idx=lasso_idx[:32]),
        ("gather_chunk_kernel", "scatter_task_kernel"))
    require(n_ev > 0 and kn > 0,
            "lasso two-kernel f32: the profiler saw no #3/#4 launch")
    host = next(r["ms_per_round"] for r in runs
                if r["label"] == "lasso two-kernel f32")
    two_pace = dict(host_ms_per_round=host,
                    kernels_device_ms_per_round=kms / two_spec.rounds,
                    busy_ms_per_round=busy / two_spec.rounds,
                    idle_share=1 - busy / span, kernel_records=kn)
    print(f"pace lasso two-kernel f32: host {host:.4f} ms/round; #3 + #4 "
          f"{kms / two_spec.rounds:.4f} ms/round of device time ({kn} "
          f"records of {2 * two_spec.rounds} launches); device busy "
          f"{busy / two_spec.rounds:.4f} ms/round; idle share "
          f"{1 - busy / span:.3f}")

    # A small problem solved on the card and by the plain versions on the CPU.
    A, y, _ = syn.sparco(seed=args.seed, n=1000, d=700)
    small_spec = SolverSpec(loss="lasso", P=256, rounds=16, fused=True)
    small_idx = draws(16, 2, 6, g, dup=False).cpu()
    on_card = ops.block_shotgun_solve(obj.make_problem(A, y, 5.0, device=dev),
                                      spec=small_spec, blk_idx=small_idx)
    on_cpu = ops.block_shotgun_solve(obj.make_problem(A, y, 5.0, device="cpu"),
                                     spec=small_spec, blk_idx=small_idx)
    rel = trace_rel(on_card.trace.objective, on_cpu.trace.objective)
    print(f"check small solve card vs CPU plain: F trace max rel {rel:.3e}")
    require(rel <= TRACE_RTOL, f"small solve card vs CPU rel {rel:.3e}")

    src = "src/repro_torch/csrc/shotgun_block.cu"
    kernels = [
        kernel_entry("fused_shotgun_rounds", src,
                     "src/repro/kernels/shotgun_block.py:535",
                     counts["fused_shotgun_rounds"],
                     t_lasso["fused_shotgun_rounds"], lasso_shape + f" R={R}"),
        kernel_entry("gather_block_matvec", src,
                     "src/repro/kernels/shotgun_block.py:81",
                     counts["gather_block_matvec"],
                     t_lasso["gather_block_matvec"], lasso_shape),
        kernel_entry("scatter_block_update", src,
                     "src/repro/kernels/shotgun_block.py:127",
                     counts["scatter_block_update"],
                     t_lasso["scatter_block_update"], lasso_shape),
    ]
    extra = {"zeta_kernel_times": {
        k: {**{a: b for a, b in v.items() if a != "bound"},
            "bound_ms": v["bound"][0], "bound_by": v["bound"][1]}
        for k, v in t_zeta.items()},
        "lasso_kernel_times": {
        k: {**{a: b for a, b in v.items() if a != "bound"},
            "bound_ms": v["bound"][0], "bound_by": v["bound"][1]}
        for k, v in t_lasso.items()},
        "dense_phases": phases, "dense_solves": runs,
        "dense_two_kernel_pace": two_pace}
    data = dict(lasso=lasso, zeta=zeta, lasso_fused=fused, La=La, Ly=Ly,
                Lm=Lm, Za=Za, Zy=Zy,
                Zm=Zm, La16=La16, Za16=Za16, lasso_idx=lasso_idx)
    return kernels, extra, data


def print_times(groups):
    for tag, tt in groups:
        for name, v in tt.items():
            b, by = v["bound"]
            lib = v.get("library_ms")
            dms = v.get("device_ms")
            ldms = v.get("library_device_ms")
            qms = v.get("queued_ms")
            print(f"time {name} [{tag}]: {v['ms']:.4f} ms; plain "
                  f"{v['plain_ms']:.4f} ms; bound {b:.4f} ms ({by}); "
                  f"{100 * b / v['ms']:.1f}% of bound"
                  + ("" if dms is None else
                     f"; device {dms:.4f} ms ({100 * b / dms:.1f}% of bound;"
                     f" host enqueue {v['ms'] - dms:.4f} ms)")
                  + ("" if qms is None else
                     f"; call behind a spin {qms:.4f} ms")
                  + ("" if lib is None else f"; library {lib:.4f} ms")
                  + ("" if ldms is None else
                     f", device {ldms:.4f} ms (host enqueue "
                     f"{lib - ldms:.4f} ms)")
                  + ("" if "strided_ms" not in v else
                     f"; K library calls on the strided blocks "
                     f"{v['strided_ms']:.4f} ms"
                     + ("" if v["strided_device_ms"] is None else
                        f", device {v['strided_device_ms']:.4f} ms")))


def print_busy(label, fn):
    """Print the device idle share over ``fn``; return it (None when the
    profiler saw no device activity)."""
    busy, span, n_ev, *_ = device_busy(fn)
    if n_ev:
        print(f"profile {label}: device busy {busy:.3f} ms of a "
              f"{span:.3f} ms span ({n_ev} device events); idle share "
              f"{1 - busy / span:.3f}")
        return 1 - busy / span
    print(f"profile {label}: not measured (the profiler saw no device "
          "activity)")
    return None


def drawn_csr(S, idx):
    """CSR copies of the drawn blocks, A_B (n, K·128) and A_Bᵀ, for the
    cuSPARSE yardstick (built outside any timing)."""
    idx = idx.long()
    K = idx.shape[0]
    rows = S.rows[idx].long()
    vals = S.vals[idx].float()
    cols = torch.arange(K * S.block, device=rows.device).reshape(
        K, 1, S.block).expand(rows.shape)
    keep = vals != 0
    r, c, v = rows[keep], cols[keep], vals[keep]
    shape = (S.n, K * S.block)
    a = torch.sparse_coo_tensor(torch.stack([r, c]), v, shape).coalesce()
    at = torch.sparse_coo_tensor(torch.stack([c, r]), v,
                                 shape[::-1]).coalesce()
    return a.to_sparse_csr(), at.to_sparse_csr()


def dense_phases(launch, ms: float, R: int, dev) -> dict:
    """Phase breakdown of one fused dense launch: ``launch(stamps)`` runs it
    with the clock of the grid's last block (which runs no round end)
    stamped after each barrier; the cycles are scaled to the launch's
    device time ``ms`` (the last round end, after the last barrier, is
    outside the stamps)."""
    stamps = torch.zeros(2 + 3 * R, dtype=torch.int64, device=dev)
    launch(stamps)
    torch.cuda.synchronize()
    st = stamps.cpu().double()
    cyc = st[1:] - st[:-1]
    per_cycle = ms / float(st[-1] - st[0])
    rounds = cyc[1:].reshape(R, 3).mean(0) * per_cycle
    names = ["gather (beside the round end)", "reduce",
             "scatter + x update"]
    out = {"launch_ms": ms, "launch_start_ms": float(cyc[0]) * per_cycle,
           "round_ms": float(rounds.sum())}
    out.update({f"{n}_ms": float(v) for n, v in zip(names, rounds)})
    return out


SPARSE_PHASES = ("A_gather_delta_xpartial_ms",
                 "BC_rowrange_sums_xupdate_finish_ms")
OVF_PHASES = ("A_gather_segments_xpartial_ms", "A2_segment_sums_delta_ms",
              "BC_row_items_xupdate_finish_ms")


def sparse_phases(launch, ms: float | None, R: int, dev,
                  reps: int = 5, phases=SPARSE_PHASES) -> dict:
    """Phase breakdown of a fused sparse launch: ``launch(stamps)`` runs it
    with the grid's last block's SM clock stamped at each barrier (one a
    phase of ``phases`` a round: A, then BC; the OVF launch's A, A2, BC)
    and the card's ns timer at launch start and end.  Of ``reps`` stamped
    launches the one of median ns span is broken down, its cycles turned
    into ms by its own ns per cycle, so the phases need no other clock.
    ``ms`` (the profiler's device time per launch, or None) is set beside
    the stamped span, and the SM clock the stamps imply beside the card's
    maximum: three clocks that must agree."""
    per = len(phases)
    runs = []
    for _ in range(reps):
        stamps = torch.zeros(per * R + 6, dtype=torch.int64, device=dev)
        launch(stamps)
        torch.cuda.synchronize()
        runs.append(stamps.cpu())
    runs.sort(key=lambda t: int(t[-1] - t[-2]))
    spans = [float(t[-1] - t[-2]) / 1e6 for t in runs]
    st = runs[reps // 2].double()
    clk = st[:per * R + 4]
    cyc = clk[1:] - clk[:-1]
    span = spans[reps // 2]
    per_cycle = span / float(clk[-1] - clk[0])
    rounds = cyc[1:1 + per * R].reshape(R, per)
    return {
        "profiler_ms": ms, "stamped_ms": span, "stamped_ms_min": spans[0],
        "stamped_ms_max": spans[-1], "launch_cycles": float(clk[-1] - clk[0]),
        "sm_ghz": 1e-6 / per_cycle, "sm_ghz_max": sm_clock_max_ghz(),
        "launch_start_ms": float(cyc[0]) * per_cycle,
        "round_ms": float(rounds.sum(1).mean()) * per_cycle,
        **{name: float(rounds[:, i].mean()) * per_cycle
           for i, name in enumerate(phases)},
        "final_A_xpartial_only_ms": float(cyc[1 + per * R]) * per_cycle,
        "final_finish_only_ms": float(cyc[2 + per * R]) * per_cycle}


def print_sparse_phases(label: str, p: dict) -> None:
    """The phase line of a fused sparse launch and its three clocks, which
    must agree, each within 2% (the ns timer's grain and the spread between
    launches): the SM clock the stamps imply at most the card's maximum,
    and the profiler's record no shorter than the stamped span it holds."""
    print(f"phases {label}: " + "; ".join(
        f"{k} {'n/a' if v is None else f'{v:.4f}'}" for k, v in p.items()))
    prof = p["profiler_ms"]
    print(f"clocks {label}: stamped span {p['stamped_ms']:.4f} ms "
          f"({p['stamped_ms_min']:.4f}-{p['stamped_ms_max']:.4f} over the "
          f"stamped launches); profiler "
          + ("n/a" if prof is None else
             f"{prof:.4f} ms ({prof / p['stamped_ms']:.3f} of the span)")
          + f"; SM clock from the stamps {p['sm_ghz']:.3f} GHz (max "
          + ("n/a" if p["sm_ghz_max"] is None else
             f"{p['sm_ghz_max']:.3f}") + ")")
    require(p["sm_ghz_max"] is None or p["sm_ghz"] <= 1.02 * p["sm_ghz_max"],
            f"{label}: the stamps imply an SM clock of {p['sm_ghz']:.3f} GHz")
    require(prof is None or prof >= 0.98 * p["stamped_ms"],
            f"{label}: profiler {prof} ms below the stamped span "
            f"{p['stamped_ms']:.4f} ms")


def sm_clock_max_ghz() -> float | None:
    """The card's maximum SM clock from nvidia-smi, in GHz (None when it
    cannot be read)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60,
                             check=True)
        return float(out.stdout.split()[0]) / 1e3
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def sparse_leg(args):
    """The sparse leg: kernels #2, #5, #6 against their plain versions at
    S1 and S2, their times and phase breakdown, and the sparse main path."""
    from repro_torch.core import health
    from repro_torch.core import objectives as obj
    from repro_torch.core import spectral
    from repro_torch.core.health import GuardConfig
    from repro_torch.core.spec import SolverSpec
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import ops
    from repro_torch.kernels import shotgun_sparse as ss

    dev = torch.device(DEVICE)
    B = 128
    R = 8
    g = torch.Generator(device=dev).manual_seed(args.seed + 20)

    # ---- data on the card, never densified --------------------------------
    t0 = time.perf_counter()
    S, y, _ = syn.large_sparse_bcsc_on_device(
        args.seed + 10, n=S1_N, d=S1_D, density=S1_DENSITY, device=dev)
    s1 = obj.make_problem(S, y, 1.0, device=dev)
    s1 = s1._replace(lam=0.1 * obj.lambda_max(s1.A, s1.y, "lasso"))
    S, y, _ = syn.logistic_bcsc_on_device(
        args.seed + 11, n=S2_N, d=S2_D, density=S2_DENSITY, device=dev)
    s2 = obj.make_problem(S, y, 1.0, loss="logistic", device=dev)
    s2 = s2._replace(lam=0.1 * obj.lambda_max(s2.A, s2.y, "logistic"))
    del S
    torch.cuda.synchronize()
    print(f"data (sparse): {time.perf_counter() - t0:.1f} s")
    K_of, pstar_of = {}, {}
    for tag, prob, want_K in (("S1", s1, S1_P // B), ("S2", s2, S2_K)):
        A = prob.A
        t0 = time.perf_counter()
        rho = float(spectral.spectral_radius(
            A, torch.Generator(device=dev).manual_seed(args.seed + 12)))
        pstar = int(math.ceil(A.d / max(rho, 1.0) - 0.01))
        K = want_K
        if tag == "S1" and K * B >= pstar:
            K = max(1, (pstar - 1) // B)             # largest K under P*
        K_of[tag], pstar_of[tag] = K, pstar
        nbytes = A.rows.numel() * 4 + A.vals.numel() * A.vals.element_size()
        print(f"problem {tag} ({prob.loss}): n {A.n} d {A.d} d_pad {A.d_pad} "
              f"nblk {A.nblk} tile {A.tile} nnz {int(A.nnz)} (density "
              f"{int(A.nnz) / (A.n * A.d):.3e}); rows+vals {nbytes / 1e6:.1f}"
              f" MB f32; lam {float(prob.lam):.6g}; rho {rho:.4f}; "
              f"P* = d/rho = {A.d / rho:.1f}; K {K} (P {K * B}); "
              f"{time.perf_counter() - t0:.1f} s")
        require(K * B < pstar, f"{tag}: P = {K * B} not below P* = {pstar}")
    s1_16 = s1._replace(A=s1.A.astype(torch.bfloat16))
    s2_16 = s2._replace(A=s2.A.astype(torch.bfloat16))
    for prob in (s1, s1_16, s2, s2_16):                # build the layouts
        prob.A.scatter_order()
        prob.A.range_starts()
    K1, K2 = K_of["S1"], K_of["S2"]

    # ---- each kernel against its plain version at S1 and S2 ---------------
    for tag, probs, K, losses in (
            ("S1", (("f32", s1), ("bf16", s1_16)), K1, ("lasso",)),
            ("S2", (("f32", s2), ("bf16", s2_16)), K2,
             ("logistic", "logistic_newton"))):
        for store, prob in probs:
            A = prob.A
            od = A.scatter_order()
            sk = dict(order=od, rstart=A.range_starts())
            idx = draws(1, K, A.nblk, g)[0]
            idx[-1] = idx[0]                              # duplicate block
            r = torch.randn(A.n, generator=g, device=dev)
            dl = torch.randn(K, B, generator=g, device=dev) * 0.01
            t = f"{tag} {store} K={K}"
            check("sparse_gather_block_matvec", t, [(
                "g", ss.sparse_gather_block_matvec(A.rows, A.vals, r, idx),
                ss.sparse_gather_block_matvec_plain(A.rows, A.vals, r, idx),
                0.0)])
            check("sparse_scatter_block_update", t, [(
                "z", ss.sparse_scatter_block_update(A.rows, A.vals, r, idx,
                                                    dl, **sk),
                ss.sparse_scatter_block_update_plain(A.rows, A.vals, r, idx,
                                                     dl, **sk), 0.0)])
            require_repeat(lambda: ss.sparse_gather_block_matvec(
                A.rows, A.vals, r, idx), f"sparse_gather_block_matvec [{t}]")
            require_repeat(lambda: ss.sparse_scatter_block_update(
                A.rows, A.vals, r, idx, dl, **sk),
                f"sparse_scatter_block_update [{t}]")
            # a non-finite δ in a column with a padding slot reaches row 0
            cols = torch.nonzero(od.zmask[idx[0]])
            if len(cols):
                dn = dl.clone()
                dn[0, int(cols[0])] = float("inf")
                got = ss.sparse_scatter_block_update(A.rows, A.vals, r, idx,
                                                     dn, **sk)
                want = ss.sparse_scatter_block_update_plain(
                    A.rows, A.vals, r, idx, dn, **sk)
                require(bool(torch.isnan(got[0])) and torch.equal(
                    torch.isnan(got), torch.isnan(want)),
                    f"sparse_scatter_block_update [{t}]: NaN through "
                    "padding")
                print(f"check sparse_scatter_block_update [{t}]: NaN "
                      f"through padding reaches row 0")
            for loss in losses:
                idx = draws(R, K, A.nblk, g)
                x0 = torch.randn(A.d_pad, generator=g, device=dev) * 0.01
                x0[A.d:] = 0.0
                z0 = A.matvec(x0)
                for k_eff in (None, K - 1):
                    t = f"{loss} {tag} {store} K={K} R={R} k_eff={k_eff}"
                    fargs = (A.rows, A.vals, z0, x0, idx, prob.lam,
                             prob.beta, prob.y)
                    got = ss.fused_sparse_shotgun_rounds(
                        *fargs, loss=loss, k_eff=k_eff, **sk)
                    want = ss.fused_sparse_shotgun_rounds_plain(
                        *fargs, loss=loss, k_eff=k_eff)
                    check("fused_sparse_shotgun_rounds", t,
                          [("x", got[0], want[0], 1.0),
                           ("z", got[1], want[1], 0.0),
                           ("f", got[2], want[2], 0.0)],
                          nnz_pair=(got[3], want[3]),
                          health_pair=(got[4], want[4]))
                    require_repeat(lambda: ss.fused_sparse_shotgun_rounds(
                        *fargs, loss=loss, k_eff=k_eff, **sk),
                        f"fused_sparse_shotgun_rounds [{t}]")

    # ---- kernel times and the fused launch's phases -----------------------
    def kernel_times(prob, K, loss, iters):
        A = prob.A
        n, d_pad, tile = A.n, A.d_pad, A.tile
        vb = A.vals.element_size()
        od = A.scatter_order()
        sk = dict(order=od, rstart=A.range_starts())
        idx = draws(R, K, A.nblk, g, dup=False)
        x0 = torch.zeros(d_pad, device=dev)
        z0 = torch.zeros(n, device=dev)
        r = torch.randn(n, generator=g, device=dev)
        dl = torch.randn(K, B, generator=g, device=dev) * 0.01
        fargs = (A.rows, A.vals, z0, x0, idx, prob.lam, prob.beta, prob.y)
        newton = 1 if ss.resolve_loss(loss).newton else 0
        slots = K * tile * B
        tiles = slots * (4 + vb)
        a_csr, at_csr = drawn_csr(A, idx[0])
        out = {}
        out["fused_sparse_shotgun_rounds"] = dict(
            ms=time_ms(lambda: ss.fused_sparse_shotgun_rounds(
                *fargs, loss=loss, **sk), iters),
            plain_ms=time_ms(lambda: ss.fused_sparse_shotgun_rounds_plain(
                *fargs, loss=loss), max(2, iters // 4), warmup=1),
            bound=bound(R * tiles + 4 * (3 * n + 2 * d_pad) + 8 * R,
                        R * ((4 + 3 * newton) * slots + (K + 10) * n
                             + 2 * d_pad)))
        i0, rows, vals, rs = idx[0].clone(), A.rows, A.vals, sk["rstart"]
        gather = lambda: ss.sparse_gather_block_matvec(rows, vals, r, i0)
        scatter = lambda: ss.sparse_scatter_block_update(
            rows, vals, z0, i0, dl, order=od, rstart=rs)
        d_flat = dl.reshape(-1)
        lib_mv = lambda: torch.mv(at_csr, r)
        lib_addmv = lambda: torch.addmv(z0, a_csr, d_flat)
        g_ms, mv_ms = paired_ms(gather, lib_mv, PAIR_ITERS)
        s_ms, addmv_ms = paired_ms(scatter, lib_addmv, PAIR_ITERS)
        out["sparse_gather_block_matvec"] = dict(
            ms=g_ms,
            plain_ms=time_ms(lambda: ss.sparse_gather_block_matvec_plain(
                rows, vals, r, i0), iters),
            library_ms=mv_ms,
            bound=bound(tiles + 4 * n + 512 * K, 2 * slots))
        out["sparse_scatter_block_update"] = dict(
            ms=s_ms,
            plain_ms=time_ms(lambda: ss.sparse_scatter_block_update_plain(
                rows, vals, z0, i0, dl, **sk), max(2, iters // 4), warmup=1),
            library_ms=addmv_ms,
            bound=bound(tiles + 8 * n + 512 * K, 2 * slots + K * n))
        out["fused_sparse_shotgun_rounds"]["device_ms"] = device_ms(
            lambda: ss.fused_sparse_shotgun_rounds(*fargs, loss=loss, **sk),
            ("fused_sparse_kernel",), iters)
        # the two-kernel pair and its cuSPARSE yardsticks on one clock:
        # every device op in a window of that call alone
        for name, fn, lib in (
                ("sparse_gather_block_matvec", gather, lib_mv),
                ("sparse_scatter_block_update", scatter, lib_addmv)):
            out[name]["device_ms"] = device_ms(fn, None, PAIR_ITERS)
            out[name]["library_device_ms"] = device_ms(lib, None, PAIR_ITERS)
        t = out["fused_sparse_shotgun_rounds"]
        t["queued_ms"] = queued_ms(
            lambda: ss.fused_sparse_shotgun_rounds(*fargs, loss=loss, **sk),
            iters)
        out["phases"] = sparse_phases(
            lambda st: ss.fused_sparse_shotgun_rounds(
                *fargs, loss=loss, **sk, stamps=st),
            t["device_ms"], R, dev)
        return out

    t_s1 = kernel_times(s1, K1, "lasso", 20)
    t_s2 = kernel_times(s2, K2, "logistic_newton", 20)
    ph = {"S1": t_s1.pop("phases"), "S2": t_s2.pop("phases")}
    print_times(((f"S1 lasso f32 K={K1} R={R}", t_s1),
                 (f"S2 f32 K={K2} R={R} logistic_newton", t_s2)))
    for tag, p in ph.items():
        print_sparse_phases(f"fused_sparse_shotgun_rounds [{tag}]", p)

    # ---- the main path (sparse leg) ---------------------------------------
    runs = []

    def solve(label, prob, spec, **kw):
        K = max(1, -(-spec.P // B))
        return run_solve(label, ops, health, prob, spec, ss.LAUNCHES,
                         "fused_sparse_shotgun_rounds",
                         ("sparse_gather_block_matvec",
                          "sparse_scatter_block_update"),
                         K * prob.A.tile * B * (4 + prob.A.vals.element_size()),
                         R, runs, **kw)

    s1_idx = draws(S1_ROUNDS, K1, s1.A.nblk, g, dup=False)
    s1_spec = SolverSpec(loss="lasso", P=K1 * B, rounds=S1_ROUNDS, fused=True)
    s2_spec = SolverSpec(loss="logistic", P=K2 * B, rounds=S2_ROUNDS,
                         fused=True, newton=True, guard=GuardConfig())
    ss.reset_launches()
    fused = solve("S1 lasso fused f32", s1, s1_spec, blk_idx=s1_idx)
    two = solve("S1 lasso two-kernel f32", s1,
                SolverSpec(loss="lasso", P=K1 * B, rounds=S1_TWO_ROUNDS),
                blk_idx=s1_idx[:S1_TWO_ROUNDS])
    solve("S1 lasso fused bf16", s1_16, s1_spec, blk_idx=s1_idx)
    solve("S2 logistic newton guarded fused f32", s2, s2_spec,
          generator=torch.Generator(device=dev).manual_seed(args.seed + 13))
    counts = {k: ss.LAUNCHES[k] for k in (
        "fused_sparse_shotgun_rounds", "sparse_gather_block_matvec",
        "sparse_scatter_block_update")}
    print(f"main path launches (sparse leg): {counts}")
    require(all(v > 0 for v in counts.values()),
            f"a kernel of the sparse leg never launched: {counts}")

    rel = trace_rel(fused.trace.objective[:S1_TWO_ROUNDS],
                    two.trace.objective)
    print(f"check sparse fused vs two-kernel F trace ({S1_TWO_ROUNDS} rounds, "
          f"same draws): max rel {rel:.3e}")
    require(rel <= TRACE_RTOL, f"sparse fused vs two-kernel rel {rel:.3e}")

    # Who sets the pace of a fused solve: its host ms/round beside the
    # fused kernel's device ms/round and the device's idle share over a
    # profiled rerun of the same solve.
    pace = {}
    for label, prob, spec_, kw in (
            ("S1 lasso fused f32", s1, s1_spec, dict(blk_idx=s1_idx)),
            ("S2 logistic newton guarded fused f32", s2, s2_spec,
             dict(generator=torch.Generator(device=dev).manual_seed(1)))):
        busy, span, n_ev, kms, kn = device_busy(
            lambda: ops.block_shotgun_solve(prob, spec=spec_, **kw),
            ("fused_sparse_kernel",))
        require(n_ev > 0 and kn > 0,
                f"{label}: the profiler saw no fused launch")
        host = next(r["ms_per_round"] for r in runs if r["label"] == label)
        dev_round = kms / kn / R          # mean device ms a recorded launch
        pace[label] = dict(host_ms_per_round=host,
                           device_ms_per_round=dev_round,
                           idle_share=1 - busy / span)
        print(f"profile {label}: device busy {busy:.3f} ms of a {span:.3f} "
              f"ms span ({n_ev} device events); idle share "
              f"{1 - busy / span:.3f}")
        print(f"pace {label}: host {host:.4f} ms/round; fused kernel "
              f"{dev_round:.4f} ms/round of device time ({kn} of "
              f"{spec_.rounds // R} launches recorded); idle share "
              f"{1 - busy / span:.3f}")

    # A small problem solved sparse and dense on the card: one trajectory.
    Ad, y, _ = syn.large_sparse(seed=args.seed, n=2000, d=3000, density=0.01)
    Sd, _, _ = syn.large_sparse(seed=args.seed, n=2000, d=3000, density=0.01,
                                layout="bcsc")
    small_idx = draws(16, 2, Sd.nblk, g, dup=False).cpu()
    for fused_ in (True, False):
        spec_ = SolverSpec(loss="lasso", P=2 * B, rounds=16, fused=fused_)
        rd = ops.block_shotgun_solve(obj.make_problem(Ad, y, 1.0, device=dev),
                                     spec=spec_, blk_idx=small_idx)
        rs = ops.block_shotgun_solve(obj.make_problem(Sd, y, 1.0, device=dev),
                                     spec=spec_, blk_idx=small_idx)
        rel = trace_rel(rs.trace.objective, rd.trace.objective)
        print(f"check small problem sparse vs dense on the card "
              f"({'fused' if fused_ else 'two-kernel'}, same draws): F trace "
              f"max rel {rel:.3e}")
        require(rel <= TRACE_RTOL, f"small sparse vs dense rel {rel:.3e}")

    src = "src/repro_torch/csrc/shotgun_sparse.cu"
    shape = (f"S1 lasso f32 n={S1_N} d={S1_D} tile={s1.A.tile} K={K1}")
    kernels = [
        kernel_entry("fused_sparse_shotgun_rounds", src,
                     "src/repro/kernels/shotgun_sparse.py:389",
                     counts["fused_sparse_shotgun_rounds"],
                     t_s1["fused_sparse_shotgun_rounds"], shape + f" R={R}"),
        kernel_entry("sparse_gather_block_matvec", src,
                     "src/repro/kernels/shotgun_sparse.py:96",
                     counts["sparse_gather_block_matvec"],
                     t_s1["sparse_gather_block_matvec"], shape),
        kernel_entry("sparse_scatter_block_update", src,
                     "src/repro/kernels/shotgun_sparse.py:151",
                     counts["sparse_scatter_block_update"],
                     t_s1["sparse_scatter_block_update"], shape),
    ]
    extra = {"s2_kernel_times": {
        k: dict(ms=v["ms"], device_ms=v["device_ms"], plain_ms=v["plain_ms"],
                queued_ms=v.get("queued_ms"),
                bound_ms=v["bound"][0], bound_by=v["bound"][1],
                library_ms=v.get("library_ms"),
                library_device_ms=v.get("library_device_ms"))
        for k, v in t_s2.items()},
        "s1_device_ms": {k: v["device_ms"] for k, v in t_s1.items()},
        "sparse_phases": ph, "sparse_solves": runs, "sparse_pace": pace}
    data = dict(s1=s1, s2=s2, s1_16=s1_16, s2_16=s2_16, K1=K1, K2=K2,
                s1_idx=s1_idx, pstar=pstar_of)
    return kernels, extra, data


# ---------------------------------------------------------------------------
# The overflow leg: kernel #2's overflow instantiation at url_combined's shape
# ---------------------------------------------------------------------------

# LIBSVM url_combined (Ma, Saul, Savage & Voelker, ICML 2009): rows, columns,
# nonzeros; the tile of the url-logreg cell, its K and rounds.
URL_N, URL_D, URL_NNZ, URL_TILE = 2_396_130, 3_231_961, 277.1e6, 64
URL_K, URL_ROUNDS, URL_R = 32, 256, 32


def url_csc(seed: int, dev):
    """(col_ptr, rows, vals, n, d): url's shape under the assumed degree
    law.  Row j lies in column c with probability p_c = min(1, a / rank(c)),
    rank a seeded permutation of 1..d, ``a`` fitted by bisection so that
    n·Σ p_c = URL_NNZ; columns with p_c ≥ 1/64 draw a mask over every row,
    the others a Binomial(n, p_c) count of uniform rows (repeats kept
    once).  Values 1.0 where p_c < 0.1, N(0, 1) above."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n, d = URL_N, URL_D

    def harmonic(m):
        if m < 1000:
            return sum(1.0 / r for r in range(1, m + 1))
        return (math.log(m) + 0.5772156649015329 + 1 / (2 * m)
                - 1 / (12 * m * m))
    lo, hi = 1e-9, float(d)
    for _ in range(200):
        a = 0.5 * (lo + hi)
        m = min(d, int(a))
        lo, hi = ((a, hi) if n * (m + a * (harmonic(d) - harmonic(m)))
                  < URL_NNZ else (lo, a))
    rank = torch.randperm(d, generator=g, device=dev) + 1
    p = torch.clamp_max(a / rank.double(), 1.0)
    keys = []
    dense = torch.nonzero(p >= 1 / 64).reshape(-1)
    per = max(1, (1 << 27) // n)
    for c0 in range(0, dense.numel(), per):
        cs = dense[c0:c0 + per]
        hit = torch.nonzero(torch.rand(cs.numel(), n, generator=g,
                                       device=dev) < p[cs, None].float())
        keys.append(cs[hit[:, 0]] * n + hit[:, 1])
    sparse = torch.nonzero(p < 1 / 64).reshape(-1)
    count = torch.binomial(torch.full((sparse.numel(),), float(n),
                                      device=dev),
                           p[sparse].float(), generator=g).long()
    col = torch.repeat_interleave(sparse, count)
    keys.append(torch.unique(col * n + torch.randint(
        0, n, (col.numel(),), generator=g, device=dev)))
    key = torch.sort(torch.cat(keys))[0]
    del keys, col
    col, row = key // n, (key % n).to(torch.int32)
    col_ptr = torch.cat([col.new_zeros(1),
                         torch.cumsum(torch.bincount(col, minlength=d), 0)])
    vals = torch.where(p[col] >= 0.1, torch.randn(
        row.numel(), generator=g, device=dev), 1.0).float()
    return col_ptr, row, vals, n, d


def ovf_leg(args):
    """Kernel #2's overflow instantiation (``fused_sparse_ovf_kernel``) on a
    ``from_csc`` design of url's shape: held against its plain version on
    the same card tensors (logistic and Newton, k_eff K and K − 1, a
    duplicate draw), repeated bit for bit, timed beside its bound (the
    drawn blocks' true nonzeros × 8 B a round, spilled ones included, and
    the vectors) and the plain version, then the url-logreg cell's
    guarded Newton solve through ``block_shotgun_solve``, its launches
    counted from zero."""
    from repro_torch.core import objectives as obj
    from repro_torch.core.health import GuardConfig
    from repro_torch.core.spec import SolverSpec
    from repro_torch.data.sparse import BlockedCSC
    from repro_torch.kernels import ops
    from repro_torch.kernels import shotgun_sparse as ss

    dev = torch.device(DEVICE)
    B, R, K = 128, 8, URL_K
    name = "fused_sparse_shotgun_rounds.ovf"
    t0 = time.perf_counter()
    col_ptr, rows, vals, n, d = url_csc(args.seed + 30, dev)
    S = BlockedCSC.from_csc(col_ptr, rows, vals, n, d, tile=URL_TILE,
                            device=dev)
    nnz = int(col_ptr[-1])
    per_col = torch.nn.functional.pad(col_ptr[1:] - col_ptr[:-1],
                                      (0, S.d_pad - d))
    nnz_blk = per_col.reshape(S.nblk, B).sum(1)
    del col_ptr, rows, vals, per_col
    g = torch.Generator(device=dev).manual_seed(args.seed + 31)
    x_true = torch.zeros(S.d_pad, device=dev)
    pick = torch.randperm(d, generator=g, device=dev)[: d // 200]
    x_true[pick] = 2 * torch.randn(pick.numel(), generator=g, device=dev)
    y = torch.where(torch.rand(n, generator=g, device=dev)
                    < torch.sigmoid(S.matvec(x_true)), 1.0, -1.0)
    prob = obj.make_problem(S, y, 1.0, loss="logistic", device=dev)
    prob = prob._replace(lam=0.1 * obj.lambda_max(prob.A, prob.y,
                                                  "logistic"))
    A, o = prob.A, prob.A.ovf
    require(o is not None, "url design: no overflow store")
    od, rs = A.scatter_order(), A.range_starts()
    torch.cuda.synchronize()
    spilled = o.rows.numel()
    print(f"ovf: url design n {n} d {d} nnz {nnz}, {spilled} spilled "
          f"({spilled / nnz:.1%}), deepest column {URL_TILE + o.depth}, "
          f"{o.seg_slots} segment slots a block; tiles "
          f"{A.rows.nbytes + A.vals.nbytes} B, store {o.nbytes} B; "
          f"{time.perf_counter() - t0:.1f} s")

    sk = dict(order=od, rstart=rs, ovf=o)
    for loss in ("logistic", "logistic_newton"):
        idx = draws(R, K, A.nblk, g)
        x0 = torch.randn(A.d_pad, generator=g, device=dev) * 0.01
        x0[A.d:] = 0.0
        z0 = A.matvec(x0)
        for k_eff in (None, K - 1):
            t = f"{loss} url f32 K={K} R={R} k_eff={k_eff}"
            fargs = (A.rows, A.vals, z0, x0, idx, prob.lam, prob.beta,
                     prob.y)
            got = ss.fused_sparse_shotgun_rounds(*fargs, loss=loss,
                                                 k_eff=k_eff, **sk)
            want = ss.fused_sparse_shotgun_rounds_plain(
                *fargs, loss=loss, k_eff=k_eff, ovf=o)
            check(name, t, [("x", got[0], want[0], 1.0),
                            ("z", got[1], want[1], 0.0),
                            ("f", got[2], want[2], 0.0)],
                  nnz_pair=(got[3], want[3]),
                  health_pair=(got[4], want[4]))
            require_repeat(lambda: ss.fused_sparse_shotgun_rounds(
                *fargs, loss=loss, k_eff=k_eff, **sk), f"{name} [{t}]")

    idx = draws(R, K, A.nblk, g, dup=False)
    zero_x, zero_z = torch.zeros(A.d_pad, device=dev), torch.zeros(n,
                                                                    device=dev)
    fargs = (A.rows, A.vals, zero_z, zero_x, idx, prob.lam, prob.beta,
             prob.y)
    fused = lambda: ss.fused_sparse_shotgun_rounds(
        *fargs, loss="logistic_newton", **sk)
    drawn_nnz = int(nnz_blk[idx.long()].sum())
    t = dict(ms=time_ms(fused, 10),
             plain_ms=time_ms(lambda: ss.fused_sparse_shotgun_rounds_plain(
                 *fargs, loss="logistic_newton", ovf=o), 2, warmup=1),
             device_ms=device_ms(fused, ("fused_sparse_ovf_kernel",), 10),
             bound=bound(drawn_nnz * 8 + 4 * (3 * n + 2 * A.d_pad) + 8 * R,
                         R * ((K + 10) * n + 2 * A.d_pad)
                         + 7 * drawn_nnz))
    print(f"time {name} [logistic_newton url K={K} R={R}]: {t['ms']:.4f} "
          f"ms, device {t['device_ms']:.4f} ms, bound {t['bound'][0]:.4f} "
          f"ms ({t['bound'][1]}; {drawn_nnz} drawn nonzeros), plain "
          f"{t['plain_ms']:.4f} ms")
    stamped = lambda st: ss.fused_sparse_shotgun_rounds(  # noqa: E731
        *fargs, loss="logistic_newton", **sk, stamps=st)
    print_sparse_phases(f"{name} [logistic_newton url K={K} R={R}]",
                        sparse_phases(stamped, t["device_ms"], R, dev,
                                      phases=OVF_PHASES))

    spec = SolverSpec(loss="logistic", P=K * B, rounds=URL_ROUNDS,
                      fused=True, newton=True,
                      guard=GuardConfig(factor=10.0, p_min=1))
    gen = torch.Generator(device=dev).manual_seed(args.seed + 32)
    ops.block_shotgun_solve(prob, gen, spec=spec, rounds_per_launch=URL_R)
    ss.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ops.block_shotgun_solve(prob, gen, spec=spec,
                                  rounds_per_launch=URL_R)
    torch.cuda.synchronize()
    solve_ms = (time.perf_counter() - t0) * 1e3
    launches = ss.LAUNCHES["fused_sparse_shotgun_rounds"]
    f = res.trace.objective
    f0 = float(obj.objective(torch.zeros(A.d, device=dev), prob))
    print(f"ovf main path: guarded Newton solve of {URL_ROUNDS} rounds, "
          f"{launches} launches, {solve_ms:.2f} ms, F {f0:.6g} -> "
          f"{float(f[-1]):.6g}")
    require(launches == URL_ROUNDS // URL_R,
            f"{name}: {launches} launches, want {URL_ROUNDS // URL_R}")
    require(bool(torch.isfinite(f).all()) and float(f[-1]) < f0,
            f"{name}: the solve did not descend")
    shape = (f"url logistic_newton f32 n={n} d={d} nnz={nnz} "
             f"tile={URL_TILE} K={K} R={R}")
    entry = kernel_entry(name, "src/repro_torch/csrc/shotgun_sparse.cu",
                         "src/repro/kernels/shotgun_sparse.py:389", launches,
                         t, shape)
    peak = torch.cuda.max_memory_allocated()
    return [entry], {"ovf": dict(solve_ms=solve_ms, spilled=spilled,
                                 nnz=nnz, peak_bytes=peak)}


# ---------------------------------------------------------------------------
# The sharded leg: kernels #7 and #8, shotgun_sharded_solve on one NCCL rank
# and on two gloo ranks sharing the card
# ---------------------------------------------------------------------------

def _solve_stats(label, fn, rounds, runs, sync, decrease=True):
    """Run a solve under the host clock; print and record ms/round; check
    a finite F trace (decreasing with ``decrease``), status OK."""
    sync()
    t0 = time.perf_counter()
    res = fn()
    sync()
    sec = time.perf_counter() - t0
    f = res.trace.objective.cpu()
    print(f"solve {label}: {rounds} rounds in {sec * 1e3:.2f} ms "
          f"({sec / rounds * 1e3:.4f} ms/round); status {int(res.status)}; "
          f"F[0]={float(f[0]):.7g} F[-1]={float(f[-1]):.7g}")
    require(bool(torch.all(torch.isfinite(f))), f"{label}: non-finite F")
    require(not decrease or float(f[-1]) < float(f[0]),
            f"{label}: F did not decrease")
    require(int(res.status) == 0, f"{label}: status {int(res.status)}")
    runs.append(dict(label=label, ms_per_round=sec / rounds * 1e3,
                     rounds=rounds))
    return res


def _host_loop(prob, engine, shards, K, R, idx, trace_every):
    """The sharded schedule (merge="launch", synchronous) on one process:
    every shard's engine.run against the same merged z, then z += Σ Δz.
    Returns the F trace.  idx (shards, rounds, K)."""
    from repro_torch.core import objectives as obj
    from repro_torch.core import sharded as sh
    from repro_torch.core.engines import make_engine
    from repro_torch.data.sparse import pad_feature_blocks
    from repro_torch.kernels import ops
    if engine == "sparse_fused":
        A = pad_feature_blocks(prob.A, shards)
        nb = A.nblk // shards
        parts = [A.col_blocks(s * nb, (s + 1) * nb) for s in range(shards)]
        y = prob.y
        mask = torch.ones_like(y)
        d_local = nb * A.block
    else:
        A, y, mask = ops.pad_problem(prob.A, prob.y)
        A = sh.pad_features(A, shards * 128)
        d_local = A.shape[1] // shards
        parts = [A[:, s * d_local:(s + 1) * d_local].contiguous()
                 for s in range(shards)]
        mask = mask.float()
    eng = make_engine(engine, loss=prob.loss, K=K)
    p_eff = torch.tensor(K, dtype=torch.int32, device=y.device)
    x_l = [torch.zeros(d_local, device=y.device) for _ in range(shards)]
    z = torch.zeros(y.shape[0], device=y.device)
    fs = []
    for m in range(idx.shape[1] // R):
        dz = []
        for s in range(shards):
            x_l[s], d, h = eng.run(parts[s], y, mask, prob.lam, prob.beta, z,
                                   x_l[s], idx[s, m * R:(m + 1) * R], p_eff)
            dz.append(d)
        z = z + sum(dz[1:], dz[0])
        if (m + 1) % trace_every == 0:
            fs.append(obj.masked_data_loss(z, y, mask, prob.loss)
                      + prob.lam * sum(torch.sum(torch.abs(v)) for v in x_l))
    return torch.stack(fs)


def _two_rank_main(rank, cfg):
    """One of two gloo ranks on the card (spawned): the dense Lasso and S1
    solves through shotgun_sharded_solve, a bf16 wire, and on rank 0 the
    same schedule rerun through the port's engines on one process."""
    sys.path.insert(0, cfg["src"])
    import torch.distributed as dist
    from repro_torch.core import objectives as obj
    from repro_torch.core import sharded as sh
    from repro_torch.core.spec import SolverSpec
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import shotgun_block as sb
    from repro_torch.kernels import shotgun_sparse as ss

    dev = torch.device(cfg["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    # a rank that waits for a collective the other never makes fails
    # within minutes instead of gloo's default half hour
    dist.init_process_group("gloo", store=dist.FileStore(cfg["store"], 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=240))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # The same problems as the parent's legs, drawn on the card from the
    # same seeds; every rank checks that it holds what the other holds.
    A, y, _ = syn.sparco_on_device(cfg["seed"], n=cfg["lasso_n"],
                                   d=cfg["lasso_d"], device=dev)
    lasso = obj.make_problem(A, y, 1.0, device=dev)
    del A
    lasso = lasso._replace(lam=0.1 * obj.lambda_max(lasso.A, lasso.y,
                                                     "lasso"))
    S, y, _ = syn.large_sparse_bcsc_on_device(
        cfg["seed"] + 10, n=cfg["s1_n"], d=cfg["s1_d"],
        density=cfg["s1_density"], device=dev)
    s1 = obj.make_problem(S, y, 1.0, device=dev)
    s1 = s1._replace(lam=0.1 * obj.lambda_max(s1.A, s1.y, "lasso"))
    del S
    mine = torch.stack([lasso.A.sum(), lasso.lam, s1.A.vals.float().sum(),
                        s1.lam]).cpu()
    both = [torch.zeros_like(mine) for _ in range(2)]
    dist.all_gather(both, mine)
    require(torch.equal(both[0], both[1]),
            f"rank {rank}: the ranks drew different problems {both}")

    g = torch.Generator(device=dev).manual_seed(cfg["seed"] + 40)
    R = 8
    cells = (("dense", lasso, "fused", cfg["dense_k"], cfg["dense_rounds"],
              (-(-lasso.d // 128)) // 2),
             ("S1", s1, "sparse_fused", cfg["s1_k"], cfg["s1_rounds"],
              s1.A.nblk // 2))
    sb.reset_launches()
    ss.reset_launches()
    out = {"runs": []}
    idx_of, f_of = {}, {}
    for tag, prob, engine, K, rounds, nblk_local in cells:
        idx = torch.stack([draws(rounds, K, nblk_local, g, dup=False)
                           for _ in range(2)])
        idx_of[tag] = idx
        spec = SolverSpec(loss="lasso", rounds=rounds, merge="launch")
        kw = dict(spec=spec, engine=engine, K=K, rounds_per_launch=R,
                  trace_every=1, blk_idx=idx)
        res = _solve_stats(f"{tag} {engine} merge=launch R={R} K={K}/rank "
                           f"2 gloo ranks [rank {rank}]",
                           lambda: sh.shotgun_sharded_solve(prob, **kw),
                           rounds, out["runs"], sync)
        f_of[tag] = res.trace.objective
        require(res.x.shape == (prob.d,) and res.z.shape == (prob.n,),
                f"{tag}: result shapes {res.x.shape} {res.z.shape}")
        if tag == "dense":
            wire = sh.shotgun_sharded_solve(prob, compression="bf16", **kw)
            f16, f32 = (float(wire.trace.objective[-1]),
                        float(res.trace.objective[-1]))
            rel = abs(f16 - f32) / abs(f32)
            print(f"check {tag} bf16 wire vs f32 wire [rank {rank}]: final F "
                  f"{f16:.7g} vs {f32:.7g}, rel {rel:.3e}")
            require(rel <= 0.01, f"bf16 wire final F rel {rel:.3e} > 1%")
            out["bf16_wire_rel"] = rel
        if dev.type == "cuda":
            # every rank runs the solve (its collectives need both); rank 0
            # reports what its profiler saw of its own device work
            busy, span, n_ev, *_ = device_busy(
                lambda: sh.shotgun_sharded_solve(prob, **kw))
            if rank == 0:
                out[f"{tag}_idle_share"] = (1 - busy / span) if n_ev else None
                print(f"profile {tag} 2 gloo ranks [rank 0's own device "
                      "work]: " + (f"busy {busy:.3f} ms of {span:.3f} ms; "
                                   f"idle share {1 - busy / span:.3f}"
                                   if n_ev else "not measured"))
        dist.barrier()
    out["launches"] = {**sb.LAUNCHES, **ss.LAUNCHES}
    dist.destroy_process_group()
    if rank == 0:
        for tag, prob, engine, K, rounds, _ in cells:
            f_ref = _host_loop(prob, engine, 2, K, R, idx_of[tag], 1)
            rel = trace_rel(f_of[tag], f_ref)
            print(f"check {tag} 2 gloo ranks vs the engines' host loop on "
                  f"one process: F trace max rel {rel:.3e}")
            require(rel <= 1e-5, f"{tag}: 2-rank trace vs host loop rel "
                    f"{rel:.3e} > 1e-5")
            out[f"{tag}_vs_host_loop_rel"] = rel
        with open(cfg["out"], "w") as fh:
            json.dump(out, fh)


def sharded_leg(args, dd, sd, dense_json, sparse_json):
    """The sharded leg: kernels #7 and #8 against their plain versions at
    the dense and sparse widths, their times, then the main path —
    shotgun_sharded_solve on a one-rank NCCL group and on two gloo ranks
    sharing the card."""
    import os
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch.core import sharded as sh
    from repro_torch.core.health import GuardConfig
    from repro_torch.core.spec import SolverSpec
    from repro_torch.kernels import ops
    from repro_torch.kernels import shotgun_block as sb
    from repro_torch.kernels import shotgun_sparse as ss

    dev = torch.device(DEVICE)
    B, R = 128, 8
    g = torch.Generator(device=dev).manual_seed(args.seed + 30)
    lasso, zeta = dd["lasso"], dd["zeta"]
    s1, s2, K1, K2 = sd["s1"], sd["s2"], sd["K1"], sd["K2"]

    # ---- #7 against its plain version at the dense widths -----------------
    cases = [("lasso", "lasso", dd["La"], dd["La16"], dd["Ly"], dd["Lm"],
              lasso, 8),
             ("logistic_newton", "zeta", dd["Za"], dd["Za16"], dd["Zy"],
              dd["Zm"], zeta, 2)]
    for loss, tag, A32, A16, yv, m, prob, K in cases:
        nblk = A32.shape[1] // B
        idx = draws(R, K, nblk, g)
        x0 = torch.randn(A32.shape[1], generator=g, device=dev) * 0.01
        for store, A in (("f32", A32), ("bf16", A16)):
            z0 = A.float() @ x0
            for k_eff in (None, K - 1):
                t = f"{loss} {tag} {store} K={K} R={R} k_eff={k_eff}"
                fargs = (A, z0, x0, idx, prob.lam, prob.beta, yv, m)
                got = sb.fused_shotgun_delta_rounds(*fargs, loss=loss,
                                                    k_eff=k_eff)
                want = sb.fused_shotgun_delta_rounds_plain(*fargs, loss=loss,
                                                           k_eff=k_eff)
                check("fused_shotgun_delta_rounds", t,
                      [("x", got[0], want[0], 1.0),
                       ("dz", got[1], want[1], 0.0)],
                      health_pair=(got[2], want[2]))
                require(float(got[2]) == 0.0, f"#7 [{t}] health tripped")
                require_repeat(lambda: sb.fused_shotgun_delta_rounds(
                    *fargs, loss=loss, k_eff=k_eff),
                    f"fused_shotgun_delta_rounds [{t}]")
            xn = x0.clone()
            xn[int(idx[0, 0]) * B + 7] = float("nan")
            nargs = (A, z0, xn, idx, prob.lam, prob.beta, yv, m)
            h = sb.fused_shotgun_delta_rounds(*nargs, loss=loss)[2]
            hp = sb.fused_shotgun_delta_rounds_plain(*nargs, loss=loss)[2]
            require(float(h) == float(hp) == 1.0,
                    f"#7 [{tag} {store}] NaN iterate: health {float(h)} "
                    f"plain {float(hp)}")
            print(f"check fused_shotgun_delta_rounds [{tag} {store}]: a NaN "
                  "iterate trips health")

    # ---- #8 against its plain version at S1 and S2 ------------------------
    for tag, probs, K, loss in (("S1", (("f32", s1), ("bf16", sd["s1_16"])),
                                 K1, "lasso"),
                                ("S2", (("f32", s2), ("bf16", sd["s2_16"])),
                                 K2, "logistic_newton")):
        for store, prob in probs:
            A = prob.A
            od, rs = A.scatter_order(), A.range_starts()
            idx = draws(R, K, A.nblk, g)
            x0 = torch.randn(A.d_pad, generator=g, device=dev) * 0.01
            x0[A.d:] = 0.0
            z0 = A.matvec(x0)
            for k_eff in (None, K - 1):
                t = f"{loss} {tag} {store} K={K} R={R} k_eff={k_eff}"
                fargs = (A.rows, A.vals, z0, x0, idx, prob.lam, prob.beta,
                         prob.y)
                got = ss.fused_sparse_shotgun_delta_rounds(
                    *fargs, loss=loss, k_eff=k_eff, order=od, rstart=rs)
                want = ss.fused_sparse_shotgun_delta_rounds_plain(
                    *fargs, loss=loss, k_eff=k_eff)
                check("fused_sparse_shotgun_delta_rounds", t,
                      [("x", got[0], want[0], 1.0),
                       ("dz", got[1], want[1], 0.0)],
                      health_pair=(got[2], want[2]))
                require(float(got[2]) == 0.0, f"#8 [{t}] health tripped")
                require_repeat(lambda: ss.fused_sparse_shotgun_delta_rounds(
                    *fargs, loss=loss, k_eff=k_eff, order=od, rstart=rs),
                    f"fused_sparse_shotgun_delta_rounds [{t}]")
            # a NaN iterate in a column with padding slots reaches dz[0]
            b, c = map(int, torch.nonzero(od.zmask)[0])
            xn = x0.clone()
            xn[b * B + c] = float("nan")
            one = torch.full((1, 1), b, dtype=torch.int32, device=dev)
            nargs = (A.rows, A.vals, z0, xn, one, prob.lam, prob.beta,
                     prob.y)
            _, dz, h = ss.fused_sparse_shotgun_delta_rounds(
                *nargs, loss=loss, order=od, rstart=rs)
            hp = ss.fused_sparse_shotgun_delta_rounds_plain(*nargs,
                                                            loss=loss)[2]
            require(float(h) == float(hp) == 1.0
                    and bool(torch.isnan(dz[0])),
                    f"#8 [{tag} {store}] NaN iterate: health {float(h)}")
            print(f"check fused_sparse_shotgun_delta_rounds [{tag} {store}]:"
                  " a NaN iterate reaches dz[0] and trips health")

    # ---- kernel times at the main path's shapes ---------------------------
    def dense_times(A, yv, m, prob, K, loss, iters):
        n, d = A.shape
        idx = draws(R, K, d // B, g, dup=False)
        x0, z0 = torch.zeros(d, device=dev), torch.zeros(n, device=dev)
        fargs = (A, z0, x0, idx, prob.lam, prob.beta, yv, m)
        newton = 1 if sb.resolve_loss(loss).newton else 0
        fn = lambda: sb.fused_shotgun_delta_rounds(*fargs, loss=loss)  # noqa: E731
        return dict(
            ms=time_ms(fn, iters),
            device_ms=device_ms(fn, ("fused_rounds_kernel",), iters),
            plain_ms=time_ms(lambda: sb.fused_shotgun_delta_rounds_plain(
                *fargs, loss=loss), max(2, iters // 4), warmup=1),
            bound=bound(R * K * n * B * A.element_size()
                        + 4 * (4 * n + 2 * d) + 4 * R * K,
                        R * (4 + 3 * newton) * K * n * B))

    def sparse_times(prob, K, loss, iters):
        A = prob.A
        n, d_pad, tile = A.n, A.d_pad, A.tile
        od, rs = A.scatter_order(), A.range_starts()
        idx = draws(R, K, A.nblk, g, dup=False)
        x0, z0 = torch.zeros(d_pad, device=dev), torch.zeros(n, device=dev)
        fargs = (A.rows, A.vals, z0, x0, idx, prob.lam, prob.beta, prob.y)
        newton = 1 if ss.resolve_loss(loss).newton else 0
        slots = K * tile * B
        fn = lambda: ss.fused_sparse_shotgun_delta_rounds(  # noqa: E731
            *fargs, loss=loss, order=od, rstart=rs)
        return dict(
            ms=time_ms(fn, iters),
            device_ms=device_ms(fn, ("fused_sparse_kernel",), iters),
            queued_ms=queued_ms(fn, iters),
            plain_ms=time_ms(lambda: ss.fused_sparse_shotgun_delta_rounds_plain(
                *fargs, loss=loss), max(2, iters // 4), warmup=1),
            bound=bound(R * slots * (4 + A.vals.element_size())
                        + 4 * (3 * n + 2 * d_pad) + 4 * R * K,
                        R * ((4 + 3 * newton) * slots + (K + 10) * n)))

    t7 = {"lasso": dense_times(dd["La"], dd["Ly"], dd["Lm"], lasso, 8,
                               "lasso", 20),
          "zeta": dense_times(dd["Za"], dd["Zy"], dd["Zm"], zeta, 2,
                              "logistic_newton", 10)}
    t8 = {"S1": sparse_times(s1, K1, "lasso", 20),
          "S2": sparse_times(s2, K2, "logistic_newton", 20)}
    print_times([(f"{k} R={R}", {"fused_shotgun_delta_rounds": v})
                 for k, v in t7.items()]
                + [(f"{k} R={R}", {"fused_sparse_shotgun_delta_rounds": v})
                   for k, v in t8.items()])

    # ---- the main path: one NCCL rank, then two gloo ranks ----------------
    runs = []

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    lasso_idx = dd["lasso_idx"]
    K = lasso_idx.shape[1]
    # the single-device fused solve that merge="round" on one rank follows
    ref = ops.block_shotgun_solve(
        lasso, spec=SolverSpec(loss="lasso", P=K * B, rounds=SH_ROUND_ROUNDS,
                               fused=True),
        blk_idx=lasso_idx[:SH_ROUND_ROUNDS])
    sb.reset_launches()
    ss.reset_launches()
    dist.init_process_group(ONE_RANK_BACKEND, store=dist.FileStore(
        os.path.join(tmp, "store1"), 1), rank=0, world_size=1)
    dist.all_reduce(torch.zeros(1, device=dev))   # set up the communicator
    sync()
    rnd = _solve_stats(
        "lasso fused merge=round 1 rank", lambda: sh.shotgun_sharded_solve(
            lasso, spec=SolverSpec(loss="lasso", rounds=SH_ROUND_ROUNDS,
                                   merge="round"),
            engine="fused", K=K, blk_idx=lasso_idx[None, :SH_ROUND_ROUNDS]),
        SH_ROUND_ROUNDS, runs, sync)
    rel = trace_rel(rnd.trace.objective, ref.trace.objective)
    print(f"check merge=round on 1 rank vs block_shotgun_solve(fused=True), "
          f"same draws: F trace max rel {rel:.3e}")
    require(rel <= TRACE_RTOL, f"merge=round vs fused solve rel {rel:.3e}")
    n_launch = min(SH_LAUNCH_ROUNDS, lasso_idx.shape[0])
    kw = dict(engine="fused", K=K, rounds_per_launch=R,
              blk_idx=lasso_idx[None, :n_launch])
    sync_res = _solve_stats(
        f"lasso fused merge=launch R={R} 1 rank",
        lambda: sh.shotgun_sharded_solve(lasso, spec=SolverSpec(
            loss="lasso", rounds=n_launch, merge="launch"), **kw),
        n_launch, runs, sync)
    pipe = _solve_stats(
        f"lasso fused merge=launch R={R} pipeline 1 rank",
        lambda: sh.shotgun_sharded_solve(lasso, spec=SolverSpec(
            loss="lasso", rounds=n_launch, merge="launch", pipeline=True),
            **kw),
        n_launch, runs, sync)
    require(torch.equal(pipe.x, sync_res.x),
            "pipelined x differs from synchronous x on one rank")
    thin = _solve_stats(
        f"lasso fused merge=launch R={R} trace_every=4 1 rank",
        lambda: sh.shotgun_sharded_solve(lasso, spec=SolverSpec(
            loss="lasso", rounds=n_launch, merge="launch"), trace_every=4,
            **kw),
        n_launch, runs, sync, decrease=False)
    require(torch.equal(thin.x, sync_res.x)
            and torch.equal(thin.trace.objective,
                            sync_res.trace.objective[3::4]),
            "trace_every=4 changed the trajectory")
    zrel = rel_err(pipe.z, sync_res.z)[1]
    print(f"check pipeline vs synchronous on 1 rank: x bit-identical, z rel "
          f"{zrel:.3e}")
    require(zrel <= 1e-5, f"pipelined z rel {zrel:.3e}")
    s1_idx = sd["s1_idx"]
    s1_run = _solve_stats(
        f"S1 sparse_fused merge=launch R={R} K={K1} 1 rank",
        lambda: sh.shotgun_sharded_solve(
            s1, spec=SolverSpec(loss="lasso", rounds=s1_idx.shape[0],
                                merge="launch"),
            engine="sparse_fused", K=K1, rounds_per_launch=R,
            blk_idx=s1_idx[None]),
        s1_idx.shape[0], runs, sync)
    _solve_stats(
        f"S2 sparse_fused newton guarded merge=launch R={R} K={K2} 1 rank",
        lambda: sh.shotgun_sharded_solve(
            s2, spec=SolverSpec(loss="logistic", rounds=S2_ROUNDS,
                                merge="launch", fused=True, newton=True,
                                guard=GuardConfig()),
            engine="sparse_fused", K=K2, rounds_per_launch=R,
            seed=args.seed + 31),
        S2_ROUNDS, runs, sync)
    for engine, prob, KK, idx in (("block", lasso, K, lasso_idx),
                                  ("sparse_block", s1, K1, s1_idx)):
        _solve_stats(
            f"{engine} merge=round 1 rank", lambda: sh.shotgun_sharded_solve(
                prob, spec=SolverSpec(loss="lasso",
                                      rounds=SH_TWO_KERNEL_ROUNDS,
                                      merge="round"),
                engine=engine, K=KK,
                blk_idx=idx[None, :SH_TWO_KERNEL_ROUNDS]),
            SH_TWO_KERNEL_ROUNDS, runs, sync)
    one_rank_counts = {**sb.LAUNCHES, **ss.LAUNCHES}
    idle = {}
    for label, prob, eng, KK, idx in (
            ("lasso fused merge=launch 1 rank", lasso, "fused", K,
             lasso_idx[:n_launch]),
            ("S1 sparse_fused merge=launch 1 rank", s1, "sparse_fused", K1,
             s1_idx)):
        idle[label] = print_busy(label, lambda: sh.shotgun_sharded_solve(
            prob, spec=SolverSpec(loss="lasso", rounds=idx.shape[0],
                                  merge="launch"),
            engine=eng, K=KK, rounds_per_launch=R, blk_idx=idx[None]))
    dist.destroy_process_group()

    cfg = dict(src=str(ROOT / "src"), device=DEVICE, seed=args.seed,
               store=os.path.join(tmp, "store2"),
               out=os.path.join(tmp, "two_ranks.json"),
               lasso_n=LASSO_N, lasso_d=LASSO_D, s1_n=S1_N, s1_d=S1_D,
               s1_density=S1_DENSITY, dense_k=K // 2, s1_k=max(1, K1 // 2),
               dense_rounds=SH_DENSE_ROUNDS2, s1_rounds=SH_S1_ROUNDS2)
    t0 = time.perf_counter()
    mp.spawn(_two_rank_main, args=(cfg,), nprocs=2, join=True)
    print(f"two gloo ranks: spawned, solved, joined in "
          f"{time.perf_counter() - t0:.1f} s")
    with open(cfg["out"]) as fh:
        two = json.load(fh)
    path = ("fused_shotgun_delta_rounds", "fused_sparse_shotgun_delta_rounds",
            "gather_block_matvec", "scatter_block_update",
            "sparse_gather_block_matvec", "sparse_scatter_block_update")
    counts = {k: one_rank_counts[k] + two["launches"][k] for k in path}
    print(f"main path launches (sharded leg; one rank + rank 0 of two): "
          f"{counts}")
    require(all(v > 0 for v in counts.values()),
            f"a kernel of the sharded leg never launched: {counts}")

    single = {r["label"]: r["ms_per_round"] for r in
              dense_json["dense_solves"] + sparse_json["sparse_solves"]}
    print(f"time per round, single-device fused solve at the same size: "
          f"lasso {single.get('lasso fused f32', float('nan')):.4f} ms "
          f"(K=8), S1 {single.get('S1 lasso fused f32', float('nan')):.4f}"
          f" ms (K={K1})")

    kernels = [
        kernel_entry("fused_shotgun_delta_rounds",
                     "src/repro_torch/csrc/shotgun_block.cu",
                     "src/repro/kernels/shotgun_block.py:572",
                     counts["fused_shotgun_delta_rounds"], t7["lasso"],
                     f"lasso f32 n={LASSO_N} d={LASSO_D} K=8 R={R}"),
        kernel_entry("fused_sparse_shotgun_delta_rounds",
                     "src/repro_torch/csrc/shotgun_sparse.cu",
                     "src/repro/kernels/shotgun_sparse.py:420",
                     counts["fused_sparse_shotgun_delta_rounds"], t8["S1"],
                     f"S1 lasso f32 n={S1_N} d={S1_D} K={K1} R={R}"),
    ]
    extra = {"sharded": {
        "kernel_times": {
            k: dict(ms=v["ms"], device_ms=v["device_ms"],
                    queued_ms=v.get("queued_ms"),
                    plain_ms=v["plain_ms"], bound_ms=v["bound"][0],
                    bound_by=v["bound"][1])
            for k, v in {**{f"#7 {a}": b for a, b in t7.items()},
                         **{f"#8 {a}": b for a, b in t8.items()}}.items()},
        "one_rank_backend": ONE_RANK_BACKEND, "one_rank_solves": runs,
        "one_rank_idle_share": idle, "two_gloo_ranks": two,
        "single_device_ms_per_round": single}}
    return kernels, extra


# ---------------------------------------------------------------------------
# The serve leg: kernels #9 and #10, SolverService on a dense and an S1
# stream
# ---------------------------------------------------------------------------

def distinct_blocks(idx, k_eff, shared: bool) -> int:
    """Σ over rounds of the distinct live drawn blocks of all slots: a block
    of a shared design drawn by two slots in one round is read once."""
    idx, k_eff = idx.cpu(), k_eff.cpu()
    S, R, _ = idx.shape
    total = 0
    for t in range(R):
        total += len({(0 if shared else s, int(b)) for s in range(S)
                      for b in idx[s, t, : int(k_eff[s])]})
    return total


def _check_batched(name, tag, got, want, x0, z0, frozen=()):
    """A batched kernel against its plain version; health per slot exact;
    a frozen slot's x and z equal its inputs."""
    check(name, tag, [("x", got[0], want[0], 1.0), ("z", got[1], want[1], 0.0),
                      ("f", got[2], want[2], 0.0)], nnz_pair=(got[3], want[3]))
    require(torch.equal(got[4], want[4]), f"{name} [{tag}] health "
            f"{got[4].tolist()} vs {want[4].tolist()}")
    for s in frozen:
        require(torch.equal(got[0][s], x0[s]) and torch.equal(got[1][s], z0[s]),
                f"{name} [{tag}] frozen slot {s} moved")


def _bit_identical(name, tag, got, one_of):
    """Every slot of a batched launch equals the unbatched kernel run alone
    on that slot's state and draws, in x, z, f, nnz and health."""
    for s in range(got[0].shape[0]):
        one = one_of(s)
        require(all(torch.equal(a[s], b) for a, b in zip(got, one)),
                f"{name} [{tag}] slot {s} differs from the unbatched kernel")
    print(f"check {name} [{tag}]: all {got[0].shape[0]} slots bit-identical "
          "to the unbatched kernel on their state")


def serve_leg(args, dd, sd):
    """The serve leg: kernels #9 and #10 against their plain versions and,
    slot by slot, bit for bit against #1 and #2 at full width; their times
    against S unbatched launches; then the serving path —
    ``SolverService.serve`` on a dense Lasso stream and an S1 stream, each
    held against ``solve_queue_sequential``."""
    from repro_torch.core import batched as cb
    from repro_torch.core import objectives as obj
    from repro_torch.data import synthetic as syn
    from repro_torch.data.sparse import ScatterOrder, bcsc_matvec
    from repro_torch.kernels import batched as kb
    from repro_torch.kernels import shotgun_block as sb
    from repro_torch.kernels import shotgun_sparse as ss
    from repro_torch.launch import solver_serve as svm

    dev = torch.device(DEVICE)
    B, R = 128, 8
    inf = float("inf")
    g = torch.Generator(device=dev).manual_seed(args.seed + 50)
    K1, K2 = sd["K1"], sd["K2"]
    dname, sname = ("batched_fused_shotgun_rounds",
                    "batched_fused_sparse_shotgun_rounds")

    def ladder(lam, S):
        return lam * (1.0 + 0.5 * torch.arange(S, dtype=torch.float32,
                                                device=dev))

    def full(S, v):
        return torch.full((S,), float(v), device=dev)

    def slot_draws(S, K, nblk, dup=True):
        return torch.stack([draws(R, K, nblk, g, dup=dup) for _ in range(S)])

    # ---- #9 against its plain version and #1, slot by slot ----------------
    def dense_case(tag, A, y, mask, lam, beta, K, k_eff, guard, loss, shared,
                   frozen=()):
        S, d = y.shape[0], A.shape[-1]
        x0 = torch.randn(S, d, generator=g, device=dev) * 0.01
        z0 = torch.stack([(A if shared else A[s]).float() @ x0[s]
                          for s in range(S)])
        idx = slot_draws(S, K, d // B)
        fargs = (A, z0, x0, idx, lam, beta, y, mask, k_eff, guard)
        got = kb.batched_fused_shotgun_rounds(*fargs, loss=loss,
                                              shared_design=shared)
        want = kb.batched_fused_shotgun_rounds_plain(*fargs, loss=loss,
                                                     shared_design=shared)
        _check_batched(dname, tag, got, want, x0, z0, frozen)
        _bit_identical(dname, tag, got, lambda s: sb.fused_shotgun_rounds(
            A if shared else A[s], z0[s], x0[s], idx[s], lam[s], beta[s],
            y[s], mask[s], loss=loss, k_eff=k_eff[s], guard_f=guard[s]))
        return got

    def dense_times(A, y, mask, lam, beta, K, loss, shared, iters):
        S, n = y.shape
        d = A.shape[-1]
        idx = slot_draws(S, K, d // B, dup=False)
        k_eff, guard = full(S, K), full(S, inf)
        x0, z0 = torch.zeros(S, d, device=dev), torch.zeros(S, n, device=dev)
        fargs = (A, z0, x0, idx, lam, beta, y, mask, k_eff, guard)
        fn = lambda: kb.batched_fused_shotgun_rounds(  # noqa: E731
            *fargs, loss=loss, shared_design=shared)
        one = lambda: [sb.fused_shotgun_rounds(  # noqa: E731
            A if shared else A[s], z0[s], x0[s], idx[s], lam[s], beta[s],
            y[s], mask[s], loss=loss) for s in range(S)]
        newton = 1 if sb.resolve_loss(loss).newton else 0
        blocks = distinct_blocks(idx, k_eff, shared)
        kern = ("fused_rounds_kernel",)
        return dict(
            ms=time_ms(fn, iters), device_ms=device_ms(fn, kern, iters),
            unbatched_ms=time_ms(one, iters),
            unbatched_device_ms=device_ms(one, kern, iters, per_call=S),
            plain_ms=time_ms(lambda: kb.batched_fused_shotgun_rounds_plain(
                *fargs, loss=loss, shared_design=shared), 2, warmup=1),
            bound=bound(blocks * n * B * A.element_size()
                        + S * (4 * (4 * n + 2 * d) + 8 * R),
                        R * S * K * (4 + 3 * newton) * n * B),
            distinct_blocks=blocks)

    times = {}
    t0 = time.perf_counter()
    n, d = dd["La"].shape
    S = SV_STACK
    A = torch.empty((S, n, d), device=dev)
    y = torch.empty((S, n), device=dev)
    A[0], y[0] = dd["La"], dd["Ly"]
    for s in range(1, S):
        As, ys, _ = syn.sparco_on_device(args.seed + 100 + s, n=LASSO_N,
                                         d=LASSO_D, device=dev)
        p = obj.make_problem(As, ys, 1.0, device=dev)
        del As
        A[s], y[s] = p.A, p.y
        if s == 1:
            dense_design1 = p       # the served stream's second design
        del p
    mask = torch.ones((S, n), device=dev)
    torch.cuda.synchronize()
    print(f"data (serve): {S} stacked Lasso designs {tuple(A.shape)} f32 "
          f"({A.numel() * 4 / 2**30:.2f} GiB); {time.perf_counter() - t0:.1f} s")
    lam = ladder(dd["lasso"].lam, S)
    k_eff = full(S, SV_DENSE_K)
    k_eff[2], k_eff[3] = SV_DENSE_K // 2, 0
    dense_case(f"lasso f32 stacked S={S} K={SV_DENSE_K} k_eff="
               f"{k_eff.int().tolist()}", A, y, mask, lam, full(S, 1.0),
               SV_DENSE_K, k_eff, full(S, inf), "lasso", False, frozen=(3,))
    times["lasso stacked"] = dense_times(A, y, mask, lam, full(S, 1.0),
                                         SV_DENSE_K, "lasso", False, 10)
    del A
    S = SV_SHARED
    A16 = dd["La16"]
    y8, m8 = dd["Ly"].expand(S, -1).contiguous(), torch.ones((S, n), device=dev)
    k_eff = full(S, SV_DENSE_K)
    k_eff[S - 1] = 0
    dense_case(f"lasso bf16 shared S={S} K={SV_DENSE_K}", A16, y8, m8,
               ladder(dd["lasso"].lam, S), full(S, 1.0), SV_DENSE_K, k_eff,
               full(S, inf), "lasso", True, frozen=(S - 1,))
    times["lasso bf16 shared"] = dense_times(
        A16, y8, m8, ladder(dd["lasso"].lam, S), full(S, 1.0), SV_DENSE_K,
        "lasso", True, 10)
    del y8, m8
    S = SV_ZETA
    Za = dd["Za"]
    yz, mz = (dd["Zy"].expand(S, -1).contiguous(),
              dd["Zm"].float().expand(S, -1).contiguous())
    guard = full(S, inf)
    guard[1] = 0.0                                    # trips on slot 1 only
    got = dense_case(f"zeta logistic_newton f32 shared S={S} K=2 guard on "
                     "slot 1", Za, yz, mz, ladder(dd["zeta"].lam, S),
                     full(S, 0.25), 2, full(S, 2), guard, "logistic_newton",
                     True)
    require(got[4].tolist() == [0.0, 1.0, 0.0, 0.0],
            f"zeta guard: health {got[4].tolist()}")
    times["zeta shared"] = dense_times(Za, yz, mz, ladder(dd["zeta"].lam, S),
                                       full(S, 0.25), 2, "logistic_newton",
                                       True, 4)
    del yz, mz

    # ---- #10 against its plain version and #2, slot by slot ---------------
    def sparse_case(tag, rows, vals, order, rstart, y, lam, beta, K, k_eff,
                    guard, loss, shared, d, frozen=()):
        S = y.shape[0]
        d_pad = rows.shape[-3] * B
        x0 = torch.randn(S, d_pad, generator=g, device=dev) * 0.01
        x0[:, d:] = 0.0
        z0 = torch.stack([bcsc_matvec(rows if shared else rows[s],
                                      vals if shared else vals[s], x0[s],
                                      y.shape[1]) for s in range(S)])
        idx = slot_draws(S, K, rows.shape[-3])
        fargs = (rows, vals, z0, x0, idx, lam, beta, y, k_eff, guard)
        got = kb.batched_fused_sparse_shotgun_rounds(
            *fargs, loss=loss, shared_design=shared, order=order,
            rstart=rstart)
        want = kb.batched_fused_sparse_shotgun_rounds_plain(
            *fargs, loss=loss, shared_design=shared)
        _check_batched(sname, tag, got, want, x0, z0, frozen)
        _bit_identical(sname, tag, got, lambda s: ss.fused_sparse_shotgun_rounds(
            rows if shared else rows[s], vals if shared else vals[s], z0[s],
            x0[s], idx[s], lam[s], beta[s], y[s], loss=loss, k_eff=k_eff[s],
            guard_f=guard[s], order=order if shared else ScatterOrder(
                *(t[s] for t in order)),
            rstart=rstart if shared else rstart[s]))

    def sparse_times(rows, vals, order, rstart, y, lam, beta, K, loss, shared,
                     iters):
        S, n = y.shape
        nblk, tile = rows.shape[-3], rows.shape[-2]
        d_pad = nblk * B
        idx = slot_draws(S, K, nblk, dup=False)
        k_eff, guard = full(S, K), full(S, inf)
        x0 = torch.zeros(S, d_pad, device=dev)
        z0 = torch.zeros(S, n, device=dev)
        fargs = (rows, vals, z0, x0, idx, lam, beta, y, k_eff, guard)
        fn = lambda: kb.batched_fused_sparse_shotgun_rounds(  # noqa: E731
            *fargs, loss=loss, shared_design=shared, order=order,
            rstart=rstart)
        orders = [order if shared else ScatterOrder(*(t[s] for t in order))
                  for s in range(S)]
        one = lambda: [ss.fused_sparse_shotgun_rounds(  # noqa: E731
            rows if shared else rows[s], vals if shared else vals[s], z0[s],
            x0[s], idx[s], lam[s], beta[s], y[s], loss=loss,
            order=orders[s], rstart=rstart if shared else rstart[s])
            for s in range(S)]
        newton = 1 if ss.resolve_loss(loss).newton else 0
        blocks = distinct_blocks(idx, k_eff, shared)
        slots = K * tile * B
        kern = ("fused_sparse_kernel",)
        ms, dms = time_ms(fn, iters), device_ms(fn, kern, iters)
        return dict(
            ms=ms, device_ms=dms, queued_ms=queued_ms(fn, iters),
            phases=sparse_phases(
                lambda st: kb.batched_fused_sparse_shotgun_rounds(
                    *fargs, loss=loss, shared_design=shared, order=order,
                    rstart=rstart, stamps=st), dms, R, dev),
            unbatched_ms=time_ms(one, iters),
            unbatched_device_ms=device_ms(one, kern, iters, per_call=S),
            plain_ms=time_ms(lambda: kb.batched_fused_sparse_shotgun_rounds_plain(
                *fargs, loss=loss, shared_design=shared), 2, warmup=1),
            bound=bound(blocks * tile * B * (4 + vals.element_size())
                        + S * (4 * (3 * n + 2 * d_pad) + 8 * R),
                        R * S * ((4 + 3 * newton) * slots + (K + 10) * n
                                 + 2 * d_pad)),
            distinct_blocks=blocks)

    t0 = time.perf_counter()
    s1 = sd["s1"]
    probs = [s1]
    for s in range(1, SV_S1):
        Sm, ys, _ = syn.large_sparse_bcsc_on_device(
            args.seed + 110 + s, n=S1_N, d=S1_D, density=S1_DENSITY,
            device=dev)
        probs.append(obj.make_problem(Sm, ys, 1.0, device=dev))
        del Sm
    sparse_design1 = probs[1]._replace(lam=s1.lam)
    meta, st = cb.stack_problems(probs)
    torch.cuda.synchronize()
    print(f"data (serve): {SV_S1} stacked S1 designs, tiles "
          f"{[p.A.tile for p in probs]} -> canvas tile {meta.tile}; rows+vals "
          f"{(st.rows.numel() * 4 + st.vals.numel() * 4) / 2**30:.2f} GiB; "
          f"{time.perf_counter() - t0:.1f} s")
    del probs
    S = SV_S1
    k_eff = full(S, K1)
    k_eff[2], k_eff[3] = K1 // 2, 0
    sparse_case(f"S1 lasso f32 stacked S={S} K={K1} k_eff="
                f"{k_eff.int().tolist()} tile={meta.tile}", st.rows, st.vals,
                st.order, st.rstart, st.y, ladder(s1.lam, S), full(S, 1.0),
                K1, k_eff, full(S, inf), "lasso", False, S1_D, frozen=(3,))
    times["S1 stacked"] = sparse_times(st.rows, st.vals, st.order, st.rstart,
                                       st.y, ladder(s1.lam, S), full(S, 1.0),
                                       K1, "lasso", False, 20)
    del st
    s2 = sd["s2"]
    S = SV_S2
    y2 = s2.y.expand(S, -1).contiguous()
    od2, rs2 = s2.A.scatter_order(), s2.A.range_starts()
    sparse_case(f"S2 logistic_newton f32 shared S={S} K={K2}", s2.A.rows,
                s2.A.vals, od2, rs2, y2, ladder(s2.lam, S), full(S, 0.25), K2,
                full(S, K2), full(S, inf), "logistic_newton", True, S2_D)
    times["S2 shared"] = sparse_times(s2.A.rows, s2.A.vals, od2, rs2, y2,
                                      ladder(s2.lam, S), full(S, 0.25), K2,
                                      "logistic_newton", True, 20)
    for tag, t in times.items():
        name = sname if tag.startswith("S") else dname
        print_times(((tag + f" R={R}", {name: t}),))
        if "phases" in t:
            print_sparse_phases(f"{name} [{tag}]", t["phases"])
        ub, ubd = t["unbatched_ms"], t["unbatched_device_ms"]
        print(f"time {name} [{tag}]: the same slots as unbatched launches "
              f"{ub:.4f} ms" + ("" if ubd is None else f", device {ubd:.4f} ms")
              + f"; batched / unbatched {t['ms'] / ub:.3f}"
              + ("" if ubd is None or t["device_ms"] is None else
                 f" (device {t['device_ms'] / ubd:.3f})")
              + f"; distinct drawn blocks {t['distinct_blocks']}")

    # ---- the main path: SolverService on dense and S1 streams -------------
    def stream(designs, seed, solo=False):
        """The reference's stream rule (``make_stream``) over these designs,
        λ ladder from design 0's λ; ``solo`` gives every request its own id
        (no cache sharing)."""
        reqs = svm.stream_over(designs, requests=SV_REQUESTS,
                               repeat_frac=SV_REPEAT,
                               lam=float(designs[0].lam), seed=seed)
        if solo:
            for r in reqs:
                r.problem_id = ("solo", r.rid)
        return reqs

    def serve_stream(tag, designs, K, max_rounds, wrapper, kern, seed,
                     early=False):
        # the stream's canvas covers every design (admission never grows it)
        metas = [cb.batch_meta_of(p) for p in designs]
        meta = metas[0]._replace(tile=max(m.tile for m in metas))
        kw = dict(K=K, max_rounds=max_rounds, rounds_per_launch=R,
                  tol=SV_TOL, device=dev)
        reqs = stream(designs, seed)
        torch.cuda.synchronize()
        kb.reset_launches()
        t0 = time.perf_counter()
        svc = svm.SolverService(meta, slots=SV_SLOTS, **kw)
        done = {r.rid: r for r in svc.serve(reqs)}
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        # the main path's own launches: this serve and nothing after it
        counts = dict(kb.LAUNCHES)
        require(counts[wrapper] == svc.launch_count
                and sum(counts.values()) == svc.launch_count,
                f"serve {tag}: kernel launches {counts} != the service's "
                f"{svc.launch_count} batched launches")
        for r in done.values():
            require(r.status == "ok" and math.isfinite(r.f_final)
                    and bool(torch.all(torch.isfinite(r.x))),
                    f"serve {tag}: request {r.rid} {r.status} F {r.f_final}")
        cold = [r.rounds_used for r in done.values() if r.warm == "miss"]
        warm = [r.rounds_used for r in done.values() if r.warm != "miss"]
        cs = svc.cache.stats
        out = dict(solves_per_s=len(done) / sec, seconds=sec,
                   launches=svc.launch_count, kernel_launches=counts,
                   occupancy=svc.slot_occupancy,
                   cache=[cs.hits_exact, cs.hits_near, cs.misses],
                   cold_rounds=cold, warm_rounds=warm)
        mean = lambda v: sum(v) / max(1, len(v))  # noqa: E731
        print(f"serve {tag}: {len(done)} solves in {sec * 1e3:.1f} ms "
              f"({out['solves_per_s']:.2f} solves/s), {svc.launch_count} "
              f"batched launches of {SV_SLOTS} slots, occupancy "
              f"{svc.slot_occupancy:.3f}, cache exact/near/miss "
              f"{cs.hits_exact}/{cs.hits_near}/{cs.misses}; rounds cold "
              f"{cold} (mean {mean(cold):.1f}), warm {warm} "
              f"(mean {mean(warm):.1f})")
        if early:
            # the stream the service exists for: solves stop at the launch
            # boundary, their slots refill mid-stream, repeats start warm
            stopped = [r.rid for r in done.values()
                       if r.rounds_used < max_rounds]
            require(stopped and cold and warm and mean(warm) < mean(cold),
                    f"serve {tag}: no early stop or no warm saving (rounds "
                    f"cold {cold}, warm {warm})")
            print(f"check serve {tag}: {len(stopped)} of {len(done)} "
                  f"requests stopped before their {max_rounds}-round budget; "
                  f"warm starts took {mean(warm):.1f} rounds against "
                  f"{mean(cold):.1f} cold")
        # device idle share and device ms per launch over a second serve
        # (outside the counts: they were read above)
        svc2 = svm.SolverService(meta, slots=SV_SLOTS, **kw)
        busy, span, n_ev, kms, kn = device_busy(
            lambda: svc2.serve(stream(designs, seed)), (kern,))
        del svc2
        if n_ev and kn:
            out.update(idle_share=1 - busy / span,
                       launch_device_ms=kms / kn)
            print(f"profile serve {tag}: device busy {busy:.3f} ms of a "
                  f"{span:.3f} ms span; idle share {1 - busy / span:.3f}; "
                  f"{kn} batched launches, {kms / kn:.4f} ms of device time "
                  "each")
        else:
            print(f"profile serve {tag}: not measured (the profiler saw no "
                  "device activity)")
        # distinct ids and fresh caches: served equals the sequential queue
        served = {r.rid: r for r in svm.SolverService(
            meta, slots=SV_SLOTS, cache=cb.WarmStartCache(), **kw).serve(
                stream(designs, seed, solo=True))}
        seq = {r.rid: r for r in svm.solve_queue_sequential(
            stream(designs, seed, solo=True),
            cache=cb.WarmStartCache(), **kw)}
        for rid, a in served.items():
            b = seq[rid]
            require((a.status, a.rounds_used) == (b.status, b.rounds_used)
                    and torch.equal(a.x, b.x),
                    f"serve {tag}: request {rid} served != sequential")
        print(f"check serve {tag}: {len(served)} distinct-id requests served "
              f"on {SV_SLOTS} slots equal the sequential queue bit for bit")
        # one batched launch at the serving state, every slot live
        S = SV_SLOTS
        idx = kb.batched_draw_blocks(
            [torch.Generator(device=dev).manual_seed(seed + s)
             for s in range(S)], R, K, meta.nblk, dev)
        fn = lambda: cb.launch_rounds(meta, svc.stacked, svc.z, svc.x,  # noqa: E731
                                      idx, full(S, K))
        out.update(launch_ms=time_ms(fn, 10),
                   launch_ms_device=device_ms(fn, (kern,), 10))
        print(f"time batched launch at the serving state [{tag}]: "
              f"{out['launch_ms']:.4f} ms by CUDA events"
              + ("" if out["launch_ms_device"] is None else
                 f", {out['launch_ms_device']:.4f} ms of device time"))
        return out

    lasso = dd["lasso"]
    dense_designs = [lasso, dense_design1._replace(lam=lasso.lam)]
    dense_serve = serve_stream(
        f"dense lasso {LASSO_N}x{LASSO_D} K={SV_DENSE_K}", dense_designs,
        SV_DENSE_K, SV_DENSE_ROUNDS, dname, "fused_rounds_kernel", 7000)
    s1_serve = serve_stream(f"S1 lasso K={K1}", [s1, sparse_design1], K1,
                            SV_SPARSE_ROUNDS, sname, "fused_sparse_kernel",
                            8000)
    # λ ladder from SV_EARLY_LAM·λ_max: sparse optima reached in budget
    lam_e = SV_EARLY_LAM * obj.lambda_max(lasso.A, lasso.y, "lasso")
    early_serve = serve_stream(
        f"dense lasso {SV_EARLY_LAM}*lambda_max K={SV_DENSE_K}",
        [p._replace(lam=lam_e) for p in dense_designs], SV_DENSE_K,
        SV_DENSE_ROUNDS, dname, "fused_rounds_kernel", 9000, early=True)
    streams = (dense_serve, s1_serve, early_serve)
    counts = {k: sum(st["kernel_launches"][k] for st in streams)
              for k in kb.LAUNCHES}
    print(f"main path launches (serve leg, the served streams): {counts}")
    require(all(v > 0 for v in counts.values()),
            f"a kernel of the serve leg never launched: {counts}")

    kernels = [
        kernel_entry(dname, "src/repro_torch/csrc/shotgun_block.cu",
                     "src/repro/kernels/batched.py:41", counts[dname],
                     times["lasso stacked"],
                     f"lasso f32 S={SV_STACK} stacked n={LASSO_N} "
                     f"d={LASSO_D} K={SV_DENSE_K} R={R}"),
        kernel_entry(sname, "src/repro_torch/csrc/shotgun_sparse.cu",
                     "src/repro/kernels/batched.py:69", counts[sname],
                     times["S1 stacked"],
                     f"S1 lasso f32 S={SV_S1} stacked n={S1_N} d={S1_D} "
                     f"tile={meta.tile} K={K1} R={R}"),
    ]
    extra = {"serve": {
        "kernel_times": {k: {**{a: b for a, b in v.items() if a != "bound"},
                             "bound_ms": v["bound"][0],
                             "bound_by": v["bound"][1]}
                         for k, v in times.items()},
        "dense_stream": dense_serve, "s1_stream": s1_serve,
        "early_stop_stream": early_serve}}
    return kernels, extra


# ---------------------------------------------------------------------------
# The scalar leg: the paper's own solvers
# ---------------------------------------------------------------------------

def on_cpu(prob):
    """The same problem with its tensors on the CPU."""
    return prob._replace(A=prob.A.to("cpu"), y=prob.y.cpu(),
                         lam=prob.lam.cpu(),
                         scales=None if prob.scales is None
                         else prob.scales.cpu())


def duplicate_draws(idx) -> int:
    """Draws that repeat a coordinate already drawn in their round."""
    s = idx.sort(dim=1).values
    return int((s[:, 1:] == s[:, :-1]).sum())


def host_syncs(fn, range_name: str) -> tuple[list[str], int, int]:
    """Profile ``fn``: the names of the host-sync events (``is_sync``)
    inside the profiler range ``range_name``, how many such ranges there
    were, and the device-to-host copies anywhere in the window."""
    from repro_torch.analyze.trace_checks import syncs_of
    return syncs_of(profiled_events(fn), range_name)


def scalar_leg(args, dd, sd):
    """The scalar leg: Shotgun (Alg. 2) with and without its guard,
    Shooting (Alg. 1) and the Eq. 4 form, Shotgun-CDN and Shooting-CDN,
    and the warm-started λ-path, on the problems the earlier legs built.
    Torch code on the card, no kernel of its own; the path's block_fused
    sweeps launch #2.  Each solve prints its host ms/round and the device's
    idle share; its first rounds are held against the port on the CPU on
    the same draws."""
    from repro_torch.core import cdn, path, shotgun, spectral
    from repro_torch.core import objectives as obj
    from repro_torch.core.batched import WarmStartCache
    from repro_torch.core.health import STATUS_NAMES, STATUS_OK, \
        STATUS_RECOVERED, GuardConfig
    from repro_torch.core.spec import SolverSpec
    from repro_torch.kernels import shotgun_sparse as ss

    dev = torch.device(DEVICE)
    t_leg = time.perf_counter()
    lasso, zeta, s1 = dd["lasso"], dd["zeta"], sd["s1"]
    g = torch.Generator(device=dev).manual_seed(args.seed + 40)
    p1 = sd["pstar"]["S1"]
    pd = spectral.p_star(lasso.A, torch.Generator(device=dev).manual_seed(
        args.seed + 41))
    print(f"scalar: P* S1 {p1}, dense lasso {pd}")
    runs = []

    def solve(label, fn, rounds, ok=(STATUS_OK,), strict=True):
        """Run ``fn`` once on the host clock and once under the profiler;
        print and check its trace (F lower at the end than after the first
        round; for P = 1 no higher); return the result."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        idle = print_busy(label, fn)
        f, nnz = res.trace.objective.cpu(), res.trace.nnz.cpu()
        status = int(res.status)
        print(f"solve {label}: {rounds} rounds in {sec * 1e3:.2f} ms "
              f"({sec / rounds * 1e3:.4f} ms/round); status "
              f"{STATUS_NAMES[status]}; F {float(f[0]):.7g} -> "
              f"{float(f[-1]):.7g}; nnz {int(nnz[0])} -> {int(nnz[-1])}")
        require(bool(torch.all(torch.isfinite(f))), f"{label}: non-finite F")
        require(float(f[-1]) < float(f[0]) if strict
                else float(f[-1]) <= float(f[0]),
                f"{label}: F did not decrease")
        require(status in ok, f"{label}: status {STATUS_NAMES[status]}")
        runs.append(dict(label=label, rounds=rounds,
                         ms_per_round=sec / rounds * 1e3, idle_share=idle,
                         status=STATUS_NAMES[status]))
        return res

    def against_cpu(label, card_fn, cpu_fn):
        """The first rounds on the card and on the CPU, same draws."""
        a, b = card_fn(), cpu_fn()
        rel = trace_rel(a.trace.objective, b.trace.objective)
        dn = int((a.trace.nnz.cpu() - b.trace.nnz).abs().max())
        print(f"check {label} card vs CPU ({SC_CPU_ROUNDS} rounds, same "
              f"draws): F trace max rel {rel:.3e}; nnz max diff {dn}")
        require(rel <= TRACE_RTOL, f"{label} card vs CPU rel {rel:.3e}")
        require(dn <= NNZ_TOL, f"{label} card vs CPU nnz differs by {dn}")

    # ---- Shotgun, guarded Shotgun and Shooting on S1 ----------------------
    s1_idx = torch.randint(0, s1.d, (SC_S1_ROUNDS, p1), generator=g,
                           device=dev)
    dups = duplicate_draws(s1_idx)
    require(dups > 0, "S1 draws: no duplicate coordinate in any round")
    s1_spec = SolverSpec(loss="lasso", P=p1, rounds=SC_S1_ROUNDS)
    run_s1 = lambda: shotgun.shotgun_solve(s1, spec=s1_spec,  # noqa: E731
                                           idx=s1_idx)
    a = solve(f"S1 shotgun P={p1}", run_s1, SC_S1_ROUNDS)
    b = run_s1()
    require(all(torch.equal(u, v) for u, v in (
        (a.x, b.x), (a.z, b.z), (a.trace.objective, b.trace.objective))),
        "S1 shotgun: repeat not bit-identical")
    print(f"check S1 shotgun: repeat bit-identical ({dups} duplicate draws "
          f"over {SC_S1_ROUNDS} rounds)")
    # against the CPU: the unguarded solves only (a diverging trajectory
    # amplifies the last-bit differences of another summation order)
    s1_cpu = on_cpu(s1)
    cpu_spec = SolverSpec(loss="lasso", P=p1, rounds=SC_CPU_ROUNDS)
    c_idx = s1_idx[:SC_CPU_ROUNDS]
    against_cpu("S1 shotgun", lambda: shotgun.shotgun_solve(
        s1, spec=cpu_spec, idx=c_idx), lambda: shotgun.shotgun_solve(
        s1_cpu, spec=cpu_spec, idx=c_idx.cpu()))
    against_cpu("S1 shooting", lambda: shotgun.shooting_solve(
        s1, rounds=SC_CPU_ROUNDS, idx=c_idx[:, :1]),
        lambda: shotgun.shooting_solve(s1_cpu, rounds=SC_CPU_ROUNDS,
                                       idx=c_idx[:, :1].cpu()))
    del s1_cpu
    inside, n_range, dtoh = host_syncs(
        lambda: shotgun.shotgun_solve(
            s1, torch.Generator(device=dev).manual_seed(args.seed + 42),
            spec=s1_spec), shotgun.ROUNDS_RANGE)
    print(f"check S1 shotgun: {len(inside)} host syncs inside the rounds "
          f"({inside[:4]}), {dtoh} device-to-host copies in the solve")
    require(n_range == 1 and not inside and not dtoh,
            f"S1 shotgun: host syncs {inside}, {dtoh} copies, {n_range} "
            "round ranges")
    P_g = SC_GUARD_FACTOR * p1
    guarded = solve(
        f"S1 shotgun guarded P={P_g} ({SC_GUARD_FACTOR}*P*)",
        lambda: shotgun.shotgun_solve(
            s1, torch.Generator(device=dev).manual_seed(args.seed + 43),
            spec=SolverSpec(loss="lasso", P=P_g, rounds=SC_S1_ROUNDS,
                            guard=GuardConfig(p_min=p1))),
        SC_S1_ROUNDS, ok=(STATUS_OK, STATUS_RECOVERED))
    solve("S1 shooting", lambda: shotgun.shooting_solve(
        s1, torch.Generator(device=dev).manual_seed(args.seed + 44),
        rounds=SC_S1_ROUNDS), SC_S1_ROUNDS, strict=False)

    # ---- Shotgun and the Eq. 4 form on the dense Lasso --------------------
    d_idx = torch.randint(0, lasso.d, (SC_DENSE_ROUNDS, pd), generator=g,
                          device=dev)
    d_spec = SolverSpec(loss="lasso", P=pd, rounds=SC_DENSE_ROUNDS)
    run_d = lambda: shotgun.shotgun_solve(lasso, spec=d_spec,  # noqa: E731
                                          idx=d_idx)
    a = dense_shotgun = solve(f"dense lasso shotgun P={pd}", run_d,
                              SC_DENSE_ROUNDS)
    b = run_d()
    require(torch.equal(a.x, b.x) and torch.equal(a.z, b.z),
            "dense shotgun: repeat not bit-identical")
    print(f"check dense lasso shotgun: repeat bit-identical "
          f"({duplicate_draws(d_idx)} duplicate draws)")
    lasso_cpu = on_cpu(lasso)
    cpu_spec = SolverSpec(loss="lasso", P=pd, rounds=SC_CPU_ROUNDS)
    against_cpu("dense lasso shotgun", lambda: shotgun.shotgun_solve(
        lasso, spec=cpu_spec, idx=d_idx[:SC_CPU_ROUNDS]),
        lambda: shotgun.shotgun_solve(lasso_cpu, spec=cpu_spec,
                                      idx=d_idx[:SC_CPU_ROUNDS].cpu()))
    dup_idx = torch.randint(0, 2 * lasso.d, (SC_CPU_ROUNDS, pd), generator=g,
                            device=dev)
    kw = dict(P=pd, rounds=SC_CPU_ROUNDS)
    against_cpu("dense lasso shotgun_dup", lambda: shotgun.shotgun_dup_solve(
        obj.dup_from(lasso), idx=dup_idx, **kw),
        lambda: shotgun.shotgun_dup_solve(obj.dup_from(lasso_cpu),
                                          idx=dup_idx.cpu(), **kw))
    del lasso_cpu
    solve(f"dense lasso shotgun_dup P={pd}",
          lambda: shotgun.shotgun_dup_solve(
              obj.dup_from(lasso),
              torch.Generator(device=dev).manual_seed(args.seed + 45), P=pd,
              rounds=SC_DENSE_ROUNDS), SC_DENSE_ROUNDS)

    # ---- Shotgun-CDN and Shooting-CDN on the zeta-shaped logistic ---------
    solve(f"zeta shotgun_cdn P={SC_CDN_P} active set",
          lambda: cdn.shotgun_cdn_solve(
              zeta, torch.Generator(device=dev).manual_seed(args.seed + 46),
              P=SC_CDN_P, rounds=SC_CDN_ROUNDS), SC_CDN_ROUNDS)
    solve("zeta shooting_cdn active set", lambda: cdn.shooting_cdn_solve(
        zeta, torch.Generator(device=dev).manual_seed(args.seed + 47),
        rounds=SC_CDN_ROUNDS), SC_CDN_ROUNDS, strict=False)
    z_idx = torch.randint(0, zeta.d, (SC_CPU_ROUNDS, SC_CDN_P), generator=g,
                          device=dev)
    zeta_cpu = on_cpu(zeta)
    for P in (SC_CDN_P, 1):
        kw = dict(P=P, rounds=SC_CPU_ROUNDS, active_set=False)
        ii = z_idx[:, :P]
        against_cpu(f"zeta shotgun_cdn P={P}", lambda: cdn.shotgun_cdn_solve(
            zeta, idx=ii, **kw), lambda: cdn.shotgun_cdn_solve(
            zeta_cpu, idx=ii.cpu(), **kw))
    del zeta_cpu
    inside, n_range, dtoh = host_syncs(
        lambda: cdn.shotgun_cdn_solve(
            zeta, torch.Generator(device=dev).manual_seed(args.seed + 48),
            P=SC_CDN_P, rounds=SC_CPU_ROUNDS), shotgun.ROUNDS_RANGE)
    print(f"check zeta shotgun_cdn: {len(inside)} host syncs inside the "
          f"rounds ({inside[:4]}), {dtoh} device-to-host copies in the solve")
    require(n_range == 1 and not inside and not dtoh,
            f"zeta shotgun_cdn: host syncs {inside}, {dtoh} copies, "
            f"{n_range} round ranges")

    # ---- the λ-path: S1 block_fused with the cache, dense shotgun ---------
    K1 = sd["K1"]
    cache = WarmStartCache()
    pkw = dict(lam_target=float(s1.lam),
               spec=SolverSpec(loss="lasso", P=K1 * 128,
                               rounds=SC_PATH_ROUNDS),
               num_lambdas=SC_PATH_LAMBDAS, solver="block_fused",
               cache=cache, problem_id="S1")
    sweeps = []
    for sweep in range(2):
        hits = cache.stats.hits_exact
        torch.cuda.synchronize()
        ss.reset_launches()
        t0 = time.perf_counter()
        res = path.solve_path(s1, torch.Generator(device=dev).manual_seed(
            args.seed + 50 + sweep), **pkw)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = dict(ss.LAUNCHES)
        rounds = int(res.rounds.sum())
        print(f"path S1 block_fused sweep {sweep + 1}: {rounds} rounds "
              f"({res.rounds.tolist()} per λ) in {sec * 1e3:.1f} ms; launches "
              f"{counts}; objectives {res.objectives[0]:.7g} -> "
              f"{res.objectives[-1]:.7g}; nnz {res.nnz.tolist()}")
        require(counts["fused_sparse_shotgun_rounds"] == rounds // 8
                and sum(counts.values()) == rounds // 8,
                f"path sweep {sweep + 1}: launches {counts} != {rounds // 8}")
        require(bool(np.all(np.isfinite(res.objectives)))
                and res.nnz[-1] >= res.nnz[0],
                f"path sweep {sweep + 1}: objectives {res.objectives}, nnz "
                f"{res.nnz}")
        sweeps.append(dict(rounds=res.rounds.tolist(), seconds=sec,
                           launches=counts["fused_sparse_shotgun_rounds"],
                           exact_hits=cache.stats.hits_exact - hits))
    require(sweeps[1]["exact_hits"] == SC_PATH_LAMBDAS,
            f"path sweep 2: {sweeps[1]['exact_hits']} exact cache hits of "
            f"{SC_PATH_LAMBDAS}")
    print(f"check path S1: sweep 2 hit the cache at all {SC_PATH_LAMBDAS} "
          f"λ and took {sum(sweeps[1]['rounds'])} rounds against "
          f"{sum(sweeps[0]['rounds'])}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dres = path.solve_path(
        lasso, torch.Generator(device=dev).manual_seed(args.seed + 52),
        lam_target=float(lasso.lam),
        spec=SolverSpec(loss="lasso", P=pd, rounds=SC_DENSE_PATH_ROUNDS),
        num_lambdas=SC_PATH_LAMBDAS)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    print(f"path dense lasso shotgun: {SC_PATH_LAMBDAS} λ x "
          f"{SC_DENSE_PATH_ROUNDS} rounds in {sec * 1e3:.1f} ms; objectives "
          f"{dres.objectives[0]:.7g} -> {dres.objectives[-1]:.7g}; nnz "
          f"{dres.nnz.tolist()}")
    require(bool(np.all(np.isfinite(dres.objectives)))
            and dres.nnz[-1] >= dres.nnz[0], "dense path: objectives "
            f"{dres.objectives}, nnz {dres.nnz}")
    wall = time.perf_counter() - t_leg
    print(f"scalar leg: {wall:.1f} s wall; guarded status "
          f"{STATUS_NAMES[int(guarded.status)]}")
    return {"scalar": dict(solves=runs, s1_path=sweeps,
                           dense_path_seconds=sec, pstar_s1=p1,
                           pstar_dense=pd, wall_s=wall)}, dict(
        dense_shotgun=dense_shotgun, pstar_dense=pd)


# ---------------------------------------------------------------------------
# The baselines leg: the paper's competitors and the F* oracle
# ---------------------------------------------------------------------------

def pass_bound(prob, passes: float, cols: float) -> tuple[float, str]:
    """The least time of ``passes`` reads of the dense A and a product of A
    with ``cols`` vectors in all (f32 operations)."""
    n, d = prob.A.shape
    return bound(passes * n * d * prob.A.element_size(), 2.0 * n * d * cols)


def step_bound(prob, rows: int, steps: int, record_every: int | None):
    """The least time of one stochastic step over ``rows`` rows at once:
    each row, and the iterate of each, read once and the iterate written
    once (12·d bytes a row), with F's pass over A every ``record_every``
    steps (once over ``steps`` when None) shared out over the steps."""
    n, d = prob.A.shape
    every = steps if record_every is None else record_every
    return bound(12 * d * rows + (4 * n * d + 4 * n) / every,
                 4 * d * rows + 2 * n * d / every)


def profile_iters(label: str, fn):
    """One profiler window over ``fn``: print the device's idle share and
    the host syncs inside the baselines' ``ITERS_RANGE``; require none,
    one such range and no copy from the card; return the idle share."""
    from repro_torch.analyze.trace_checks import syncs_of
    from repro_torch.core.baselines.common import ITERS_RANGE
    events = profiled_events(fn)
    busy, span, n_ev, *_ = busy_of(events)
    inside, n_range, dtoh = syncs_of(events, ITERS_RANGE)
    idle = 1 - busy / span if n_ev else None
    print(f"profile {label}: " + (
        f"device busy {busy:.3f} ms of a {span:.3f} ms span ({n_ev} device "
        f"events); idle share {idle:.3f}" if n_ev else
        "idle share not measured (the profiler saw no device activity)")
        + f"; {len(inside)} host syncs inside the iterations "
        f"({inside[:4]}), {dtoh} device-to-host copies")
    require(n_range == 1 and not inside and not dtoh,
            f"{label}: host syncs {inside}, {dtoh} copies, {n_range} "
            "iteration ranges")
    return idle


def baselines_leg(args, dd, sc):
    """The baselines leg: F* by FISTA on the card for the dense Lasso and
    the zeta-shaped logistic problem; the five Lasso competitors (SpaRSA,
    GPSR-BB, FPC_AS, L1_LS, IHT at the sparsity Shotgun found) and the
    three logistic ones (SGD after a cut rate search, parallel SGD,
    SMIDAS), each with its host ms/iteration beside its byte bound, its
    idle share and its gap to F*; and the paper's metric, rounds to 0.5%
    of F*, for the dense leg's fused block solve and the scalar leg's
    Shotgun at P*.  Torch code on the card, no kernel of its own.  Every
    solver's iterations are profiled for host syncs, a repeat must give
    the same bits, and its first iterations are held against the port on
    the CPU (FPC_AS and L1_LS on a smaller Lasso drawn on the card)."""
    from repro_torch.core import baselines as bl
    from repro_torch.core import objectives as obj
    from repro_torch.core.baselines import common, sparsa
    from repro_torch.core.shotgun import rounds_to_tolerance
    from repro_torch.data import synthetic as syn

    dev = torch.device(DEVICE)
    t_leg = time.perf_counter()
    lasso, zeta = dd["lasso"], dd["zeta"]
    g = torch.Generator(device=dev).manual_seed(args.seed + 60)
    runs, fstar, lips = [], {}, {}

    def gen(k):
        return torch.Generator(device=dev).manual_seed(args.seed + 61 + k)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def run(label, fn, short, iters, unit, bound_of, f_star):
        """Time ``fn`` on the host clock, profile ``short``, run ``short``
        twice for the bits, print and check against F*."""
        res, sec = timed(fn)
        f = res.objective.cpu()
        idle = profile_iters(label, short)
        a, b = short(), short()
        require(torch.equal(a.x, b.x) and torch.equal(a.objective,
                                                      b.objective),
                f"{label}: repeat not bit-identical")
        ms = sec / iters * 1e3
        bnd, by = bound_of(res)
        gap = (0.0 if f_star is None
               else (float(f[-1]) - f_star) / abs(f_star))
        print(f"solve {label}: {iters} {unit}s in {sec * 1e3:.2f} ms "
              f"({ms:.4f} ms/{unit}; bound {bnd:.4f} ms ({by}), "
              f"{100 * bnd / ms:.1f}% of bound); F {float(f[0]):.7g} -> "
              f"{float(f[-1]):.7g}; gap to F* {gap:.3e}; repeat "
              "bit-identical")
        require(bool(torch.all(torch.isfinite(f))), f"{label}: non-finite F")
        if f_star is not None:
            require(float(f.min()) >= f_star - BL_CERT * abs(f_star),
                    f"{label}: F {float(f.min()):.9g} below F* "
                    f"{f_star:.9g} by more than {BL_CERT}·|F*|: F* is not "
                    "certified")
        runs.append(dict(label=label, iters=iters, unit=unit, ms=ms,
                         bound_ms=bnd, bound_by=by, idle_share=idle,
                         final_f=float(f[-1]), gap=gap))
        return res

    # ---- F*: FISTA on the card (f_star is its last F) ---------------------
    for tag, prob in (("lasso", lasso), ("zeta", zeta)):
        L, sec_l = timed(lambda: common.lipschitz(prob))
        lips[tag] = L
        res = run(f"{tag} FISTA", lambda: bl.fista_solve(
            prob, BL_FSTAR_ITERS, L=L), lambda: bl.fista_solve(
            prob, BL_PROFILE_ITERS, L=L), BL_FSTAR_ITERS, "iteration",
            lambda r: pass_bound(prob, 3, 3), None)
        f = res.objective.cpu()
        fstar[tag] = float(f[-1])
        decrease = (float(f[-101]) - fstar[tag]) / abs(fstar[tag])
        print(f"F* {tag}: {fstar[tag]:.9g} (the last F of {BL_FSTAR_ITERS} "
              f"FISTA iterations, as f_star gives it; L {float(L):.7g} in "
              f"{sec_l * 1e3:.1f} ms); last 100 iterations' relative "
              f"decrease {decrease:.3e}")
        require(bool(torch.all(f[1:] <= f[:-1])),
                f"{tag} FISTA: the monotone restart let F rise")
        runs[-1].update(fstar=fstar[tag], last100=decrease)

    # ---- the five Lasso competitors ---------------------------------------
    Fl, Ll = fstar["lasso"], lips["lasso"]
    run("lasso SpaRSA", lambda: bl.sparsa_solve(lasso, BL_ITERS),
        lambda: bl.sparsa_solve(lasso, BL_PROFILE_ITERS), BL_ITERS,
        "iteration",
        lambda r: pass_bound(lasso, 3, 2 + sparsa.MAX_TRIES + 1), Fl)
    run("lasso GPSR-BB", lambda: bl.gpsr_bb_solve(lasso, BL_ITERS),
        lambda: bl.gpsr_bb_solve(lasso, BL_PROFILE_ITERS), BL_ITERS,
        "iteration", lambda r: pass_bound(lasso, 3, 3), Fl)
    ist, sub, cycles = BL_FPC
    # the reference's CG stops early: count the passes this data needs
    run(f"lasso FPC_AS ({ist} IST sweeps, CG <= {sub})",
        lambda: bl.fpc_as_solve(lasso, ist, sub, cycles, L=Ll),
        lambda: bl.fpc_as_solve(lasso, 2, 3, 2, L=Ll), cycles, "cycle",
        lambda r: pass_bound(
            lasso, (cycles * (2 * ist + 3) + 2 * int(r.inner["cg"].sum())
                    + 2) / cycles,
            (cycles * (2 * ist + 3) + 2 * int(r.inner["cg"].sum()) + 2)
            / cycles), Fl)
    steps = 2 * BL_L1LS_OUTER
    l1 = run(f"lasso L1_LS ({BL_L1LS_OUTER} barrier weights)",
             lambda: bl.l1_ls_solve(lasso, outer=BL_L1LS_OUTER),
             lambda: bl.l1_ls_solve(lasso, outer=1, newton_per_t=1,
                                    cg_iters=4), steps, "Newton step",
             lambda r: pass_bound(
                 lasso, (4 * steps + 2 * int(r.inner["cg"].sum())
                         + BL_L1LS_OUTER) / steps + 1,
                 (4 * steps + 2 * int(r.inner["cg"].sum()) + BL_L1LS_OUTER)
                 / steps + 31), Fl)
    print(f"inner L1_LS: CG iterations {l1.inner['cg'].tolist()}; "
          f"halvings {l1.inner['halvings'].tolist()}")
    s_iht = int(sc["dense_shotgun"].trace.nnz[-1])
    run(f"lasso IHT s={s_iht}", lambda: bl.iht_solve(lasso, s_iht, BL_ITERS),
        lambda: bl.iht_solve(lasso, s_iht, BL_PROFILE_ITERS), BL_ITERS,
        "iteration", lambda r: pass_bound(lasso, 3, 3), Fl)

    # ---- the three logistic competitors -----------------------------------
    Fz = fstar["zeta"]
    rates = np.geomspace(1e-4, 1.0, 14)[::BL_SGD_RATE_STRIDE]
    (best, rate), sec = timed(lambda: bl.sgd_rate_search(
        zeta, gen(0), BL_SGD_STEPS, rates))
    print(f"rate search zeta SGD: {len(rates)} of the 14 rates "
          f"({', '.join(f'{r:.4g}' for r in rates)}) x {BL_SGD_STEPS} steps "
          f"in {sec * 1e3:.1f} ms; best rate {rate:.4g}, F "
          f"{float(best.objective[-1]):.7g}")
    run(f"zeta SGD eta={rate:.4g}", lambda: bl.sgd_solve(
        zeta, gen(1), rate, BL_SGD_STEPS), lambda: bl.sgd_solve(
        zeta, gen(2), rate, 100), BL_SGD_STEPS, "step",
        lambda r: step_bound(zeta, 1, BL_SGD_STEPS, 100), Fz)
    run(f"zeta parallel SGD K={BL_PSGD_K} eta={rate:.4g}",
        lambda: bl.parallel_sgd_solve(zeta, gen(3), rate, BL_SGD_STEPS,
                                      K=BL_PSGD_K),
        lambda: bl.parallel_sgd_solve(zeta, gen(4), rate, 20, K=BL_PSGD_K),
        BL_SGD_STEPS, "step",
        lambda r: step_bound(zeta, BL_PSGD_K, BL_SGD_STEPS, None), Fz)
    run(f"zeta SMIDAS eta={BL_SMIDAS_ETA}", lambda: bl.smidas_solve(
        zeta, gen(5), BL_SMIDAS_ETA, BL_SMIDAS_STEPS), lambda: bl.smidas_solve(
        zeta, gen(6), BL_SMIDAS_ETA, 100), BL_SMIDAS_STEPS, "step",
        lambda r: step_bound(zeta, 1, BL_SMIDAS_STEPS, 100), Fz)

    # ---- the paper's metric: rounds to 0.5% of F* on the dense Lasso ------
    metric = {}
    for label, trace in (
            ("dense leg fused block solve K=8", dd["lasso_fused"].trace),
            (f"scalar leg Shotgun P*={sc['pstar_dense']}",
             sc["dense_shotgun"].trace)):
        f = trace.objective.cpu()
        r = int(rounds_to_tolerance(f, Fl))
        reached = r < len(f)
        print(f"paper metric {label}: " + (
            f"within 0.5% of F* after {r + 1} rounds" if reached else
            f"not reached in {len(f)} rounds") + f"; final gap "
            f"{(float(f[-1]) - Fl) / abs(Fl):.3e}")
        require(float(f.min()) >= Fl - BL_CERT * abs(Fl),
                f"{label}: F {float(f.min()):.9g} below F* {Fl:.9g}: F* is "
                "not certified")
        metric[label] = dict(rounds=r + 1 if reached else None,
                             of=len(f), final_gap=(float(f[-1]) - Fl)
                             / abs(Fl))

    # ---- the first iterations against the port on the CPU -----------------
    def against_cpu(label, card_fn, cpu_fn, f_rtol=TRACE_RTOL, full=True):
        """F (the trace, or the last F when not ``full``) and x on the
        card and on the CPU."""
        a, b = card_fn(), cpu_fn()
        rel = (trace_rel(a.objective, b.objective) if full
               else trace_rel(a.objective[-1:], b.objective[-1:]))
        err = float((a.x.cpu() - b.x).abs().max())
        tol = 1e-5 * max(1.0, float(b.x.abs().max()))
        what = "F trace" if full else "final F"
        print(f"check {label} card vs CPU: {what} max rel {rel:.3e}; x max "
              f"abs err {err:.3e}" + ("" if full else " (not held)"))
        require(rel <= f_rtol, f"{label} card vs CPU rel {rel:.3e}")
        require(not full or err <= tol, f"{label} card vs CPU x err {err:.3e}")
        return a, b

    lasso_cpu = on_cpu(lasso)
    Lc = Ll.cpu()
    it = BL_CPU_ITERS
    for label, fn in (
            ("lasso FISTA", lambda p, L: bl.fista_solve(p, it, L=L)),
            ("lasso SpaRSA", lambda p, L: bl.sparsa_solve(p, it)),
            ("lasso GPSR-BB", lambda p, L: bl.gpsr_bb_solve(p, it)),
            (f"lasso IHT s={s_iht}", lambda p, L: bl.iht_solve(p, s_iht, it))):
        against_cpu(f"{label} ({it} iterations, full width)",
                    lambda: fn(lasso, Ll), lambda: fn(lasso_cpu, Lc))
    del lasso_cpu
    zeta_cpu = on_cpu(zeta)
    st, K = BL_CPU_STEPS, BL_PSGD_K
    idx = torch.randint(0, zeta.n, (st,), generator=g, device=dev)
    pidx = torch.randint(0, zeta.n // K, (K, st), generator=g, device=dev)
    for label, fn, ii in (
            (f"zeta SGD eta={rate:.4g}", lambda p, i: bl.sgd_solve(
                p, None, rate, st, idx=i), idx),
            (f"zeta parallel SGD K={K}", lambda p, i: bl.parallel_sgd_solve(
                p, None, rate, st, K=K, idx=i), pidx),
            # SMIDAS's link lifts rounding in a tiny θ_j to a visible x_j:
            # its first 100 steps, F every 20
            (f"zeta SMIDAS eta={BL_SMIDAS_ETA}", lambda p, i: bl.smidas_solve(
                p, None, BL_SMIDAS_ETA, 100, 20, idx=i[:100]), idx)):
        against_cpu(f"{label} (its first steps, full width, same draws)",
                    lambda: fn(zeta, ii), lambda: fn(zeta_cpu, ii.cpu()))
    del zeta_cpu
    A, y, _ = syn.sparco_on_device(args.seed + 70, n=BL_SMALL_N,
                                   d=BL_SMALL_D, device=dev)
    small = obj.make_problem(A, y, 1.0, device=dev)
    small = small._replace(lam=0.1 * obj.lambda_max(small.A, small.y,
                                                     "lasso"))
    small_cpu = on_cpu(small)
    Ls = common.lipschitz(small)
    for label, fn in (
            ("FPC_AS", lambda p, L: bl.fpc_as_solve(p, L=L)),
            ("L1_LS", lambda p, L: bl.l1_ls_solve(p))):
        a, b = against_cpu(
            f"small lasso {BL_SMALL_N}x{BL_SMALL_D} {label} (defaults; a "
            "smaller Lasso drawn on the card: CG is slow on the CPU at full "
            "width)", lambda: fn(small, Ls), lambda: fn(small_cpu, Ls.cpu()),
            f_rtol=1e-3, full=False)
        for k in a.inner:
            same = int((a.inner[k].cpu() == b.inner[k]).sum())
            print(f"check small lasso {label} card vs CPU: {k} equal at "
                  f"{same} of {a.inner[k].numel()}")

    wall = time.perf_counter() - t_leg
    print(f"baselines leg: {wall:.1f} s wall")
    return {"baselines": dict(solves=runs, fstar=fstar, paper_metric=metric,
                              iht_s=s_iht, sgd_rate=rate, wall_s=wall)}



def release_card(before: str) -> None:
    """Return this process's cached device memory to the card before
    child processes that need the card (a full-width train step takes
    ≈ 66 GiB), and print what it still holds."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"device memory before {before}: this process holds "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved; "
          f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB free")


def _leg_start(leg: str, *argv: str, seed: int,
               deterministic: bool = False) -> subprocess.Popen:
    """``chip_smoke.py --leg leg *argv --seed seed`` as a child process,
    its output piped; ``deterministic`` puts cuBLAS's deterministic
    workspace in its environment."""
    env = (dict(os.environ, CUBLAS_WORKSPACE_CONFIG=CUBLAS_CONFIG)
           if deterministic else None)
    return subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()), "--leg", leg,
         *argv, "--seed", str(seed)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)


def _leg_result(label: str, proc: subprocess.Popen, timeout: float) -> dict:
    """Wait for the child ``proc`` (killed if it outlives ``timeout``),
    echo its lines but the last, each after ``label``, raise if it failed;
    returns its last line's JSON."""
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines = stdout.splitlines()
    for ln in lines[:-1]:
        print(f"{label}: {ln}")
    require(proc.returncode == 0 and lines,
            f"{label}: exit {proc.returncode}: {stderr[-3000:]}")
    return json.loads(lines[-1])


def _leg_child(label: str, leg: str, *argv: str, seed: int, timeout: float,
               deterministic: bool = False) -> dict:
    """``_leg_start`` then ``_leg_result``: one child run to its end."""
    return _leg_result(label, _leg_start(leg, *argv, seed=seed,
                                         deterministic=deterministic),
                       timeout)


def lm_leg_child(args) -> dict:
    """The LM leg, one child process a model (``chip_smoke.py --leg lm
    --arch A`` for each of ``LM_FAMILIES``), so that each frees the card
    for the next (MiniCPM3-4B holds ≈ 10 GiB of its own, apart from what
    the earlier legs' process keeps cached).  Echoes each child's lines,
    raises if one failed, returns {"lm": {arch: its JSON}}."""
    return {"lm": {arch: _leg_child(f"lm {arch}", "lm", "--arch", arch,
                                    seed=args.seed, timeout=600)
                   for arch in LM_FAMILIES}}


def lm_logits(cfg, params, toks, dev, frames=None):
    """Logits of a ``LM_PROMPT``-token prefill of ``toks`` (over the
    encoder frames ``frames``, for an encoder-decoder config) and of
    ``LM_DECODE`` per-slot decode steps on the tokens after it (rows at
    positions P + t and P + t - 3), as one float32 CPU tensor."""
    from repro_torch.models import model as M
    toks = torch.as_tensor(toks, dtype=torch.int64, device=dev)
    b, P = toks.shape[0], LM_PROMPT
    batch = {"tokens": toks[:, :P]}
    if frames is not None:
        batch["enc_frames"] = torch.as_tensor(frames, device=dev)
    logits, cache = M.forward(cfg, params, batch,
                              make_cache_len=P + LM_DECODE)
    outs = [logits]
    for t in range(LM_DECODE):
        pos = torch.tensor([[P + t], [P + t - 3]], device=dev)[:b]
        lg, cache = M.decode_step(cfg, params, toks[:, P + t:P + t + 1],
                                  cache, pos)
        outs.append(lg)
    return torch.cat(outs, 1).float().cpu()


def lm_bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def family_costs(cfg, params, rows: int, smax: int, prompt: int) -> dict:
    """Bytes and FLOPs of the reference's computation for one prefill of
    ``prompt`` tokens (one row; Whisper: ``rows`` rows and its encoder)
    into an ``smax``-position cache, and for one decode step of ``rows``
    rows at ``smax`` positions.  Counted: every weight read once (the
    encoder's at prefill only), each product's FLOPs (an MoE decode runs
    every expert for every token; an MoE prefill on the capacity path runs
    each expert over its g·cap buffer rows), attention over all S_max
    positions as the reference masks but computes them, MLA's expansion of
    the whole cached latent through ``wukv`` (written and read, with the
    key it concatenates), Mamba-2's float32 state and conv windows read
    and written, and Whisper's cross K/V recomputed over the encoder
    frames at every step (written and read).  Not counted: the MoE
    reference's one-hot dispatch and combine contractions, which the port
    replaces by index moves, norms and other elementwise work."""
    from repro_torch.models import mamba2 as m2
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_lib
    wb = torch.finfo(cfg.compute_dtype).bits // 8
    cb = torch.finfo(cfg.cache_dtype).bits // 8
    d, H = cfg.d_model, cfg.num_heads
    blocks = sum(t.numel() for t in M.leaves(params["blocks"]))
    block_bytes = sum(t.numel() * t.element_size()
                      for t in M.leaves(params["blocks"]))
    head = params.get("head", params["embed"])
    head_n, head_bytes = head.numel(), head.numel() * head.element_size()
    experts = sum(sum(p["moe"][n].numel() for n in ("wi", "wg", "wo"))
                  for p in params["blocks"] if "moe" in p)
    moe_layers = sum(1 for p in params["blocks"] if "moe" in p)
    t = prompt * (rows if cfg.is_encdec else 1)
    pre_flops = 2 * t * (blocks - experts + head_n)
    if experts:
        e, k = cfg.num_experts, cfg.moe_top_k
        if t <= 4 * e or t < 2 * moe_lib.GROUP_SIZE:
            pre_flops += 2 * t * experts
        else:
            g = max(1, t // moe_lib.GROUP_SIZE)
            tg = t // g
            cap = min(max(8, int(tg * k * cfg.moe_capacity_factor / e)), tg)
            pre_flops += 2 * g * cap * experts
    dec_flops = 2 * rows * (blocks + head_n)
    pre_bytes = block_bytes + head_bytes
    dec_bytes = block_bytes + head_bytes + rows * d * wb
    attn_layers = sum(1 for p in params["blocks"] if "attn" in p)
    mamba_layers = cfg.num_layers - attn_layers
    if cfg.attn_kind == "mla":
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        kvr = cfg.kv_lora_rank
        expand = 2 * smax * kvr * H * (dn + dv)
        attend = 2 * H * smax * (dn + dr + dv)
        pre_flops += attn_layers * (expand + prompt * attend)
        dec_flops += attn_layers * rows * (expand + attend)
        latent = smax * (kvr + dr) * cb
        temps = 2 * smax * H * (2 * dn + dr + dv) * wb
        pre_bytes += attn_layers * (latent + temps)
        dec_bytes += attn_layers * rows * (latent + temps)
    else:
        kv = 2 * smax * cfg.num_kv_heads * cfg.head_dim
        r = rows if cfg.is_encdec else 1
        pre_flops += attn_layers * r * 4 * H * prompt * smax * cfg.head_dim
        dec_flops += attn_layers * rows * 4 * H * smax * cfg.head_dim
        pre_bytes += attn_layers * r * kv * cb
        dec_bytes += attn_layers * rows * kv * cb
    if mamba_layers:
        d_inner, heads, conv_dim = m2.mamba_dims(cfg)
        n, hd, chunk = cfg.ssm_state, cfg.mamba_head_dim, min(128, prompt)
        pre_flops += mamba_layers * 2 * prompt * (
            chunk * n + heads * chunk * hd + 2 * heads * hd * n)
        state = (heads * hd * n + (m2.CONV_W - 1) * conv_dim) * 4
        pre_bytes += mamba_layers * state
        dec_bytes += mamba_layers * rows * 2 * state
    if cfg.is_encdec:
        E, dh = cfg.encoder_seq, cfg.head_dim
        enc = params["encoder"]
        enc_n = sum(x.numel() for x in M.leaves(enc))
        pre_flops += rows * E * (2 * enc_n + 4 * cfg.encoder_layers * H * E
                                 * dh)
        pre_bytes += sum(x.numel() * x.element_size() for x in M.leaves(enc))
        kv_proj, per_query = 2 * 2 * E * d * H * dh, 4 * H * E * dh
        pre_flops += attn_layers * rows * (kv_proj + prompt * per_query)
        dec_flops += attn_layers * rows * (kv_proj + per_query)
        cross_bytes = E * d * wb + 2 * 2 * E * H * dh * wb
        pre_bytes += attn_layers * rows * cross_bytes
        dec_bytes += attn_layers * rows * cross_bytes
    return dict(pre_bytes=pre_bytes, pre_flops=pre_flops,
                dec_bytes=dec_bytes, dec_flops=dec_flops,
                moe_layers=moe_layers, mamba_layers=mamba_layers)


def train_costs(cfg, params, rows: int, seq: int) -> dict:
    """FLOPs of one train step of ``rows`` x ``seq`` tokens as the
    reference computes it, and the optimizer's bytes.  Counted: every
    product of the forward (attention over all seq x seq positions, as the
    reference masks but computes them; an MoE layer on the capacity path
    each expert over its g·cap buffer rows, on the dense path every expert
    for every token; Mamba-2's SSD as ``family_costs`` counts it), again
    for the remat's recompute of each group, twice for the backward, the
    head's product three times (it is not recomputed); the optimizer's
    float32 reads and writes (AdamW: p, g, m, v read, p, m, v written;
    Adafactor: p and g read, p written, its statistics not counted).  Not
    counted: norms, softmax, the loss and other elementwise work.  ``n``:
    the parameters a token's products touch (the embedding table left out;
    an MoE layer's top-k of its experts), for 6·n·tokens.  Decoder-only
    configurations."""
    from repro_torch.models import mamba2 as m2
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_lib
    if cfg.is_encdec:
        raise ValueError("train_costs counts decoder-only configurations")
    t, H = rows * seq, cfg.num_heads
    blocks = sum(x.numel() for x in M.leaves(params["blocks"]))
    experts = sum(sum(p["moe"][n].numel() for n in ("wi", "wg", "wo"))
                  for p in params["blocks"] if "moe" in p)
    head = params.get("head", params["embed"])
    layers = 2 * t * (blocks - experts)
    if experts:
        e, k = cfg.num_experts, cfg.moe_top_k
        if t <= 4 * e or t < 2 * moe_lib.GROUP_SIZE:
            layers += 2 * t * experts
        else:
            g = max(1, t // moe_lib.GROUP_SIZE)
            cap = min(max(8, int((t // g) * k * cfg.moe_capacity_factor
                                 / e)), t // g)
            layers += 2 * g * cap * experts
    attn_layers = sum(1 for p in params["blocks"] if "attn" in p)
    if cfg.attn_kind == "mla":
        per = cfg.qk_nope_dim + cfg.qk_rope_dim + cfg.v_head_dim
        layers += attn_layers * 2 * rows * H * seq * seq * per
    else:
        layers += attn_layers * 4 * rows * H * seq * seq * cfg.head_dim
    mamba_layers = cfg.num_layers - attn_layers
    if mamba_layers:
        _, heads, _ = m2.mamba_dims(cfg)
        n, hd, chunk = cfg.ssm_state, cfg.mamba_head_dim, min(128, seq)
        layers += mamba_layers * rows * 2 * seq * (
            chunk * n + heads * chunk * hd + 2 * heads * hd * n)
    head_flops = 2 * t * head.numel()
    flops = (4 if cfg.remat else 3) * layers + 3 * head_flops
    total = sum(x.numel() for x in M.leaves(params))
    opt_bytes = (7 if cfg.optimizer == "adamw" else 3) * 4 * total
    active = total - params["embed"].numel() - experts
    if experts:
        active += experts * cfg.moe_top_k // cfg.num_experts
    return dict(flops=flops, opt_bytes=opt_bytes, params=total,
                active=active, tokens=t)


class Routes:
    """Records the expert picks of every ``models.moe._route`` call, or
    replays recorded picks: the router's float32 probabilities and gates
    are computed as ``_route`` computes them, the top-k choice is taken
    from the record.  A top-k is discontinuous — at a near-tie a pick
    flips with the last bit of a bf16 product, which cuBLAS and the CPU's
    BLAS round apart — so the bf16 check holds the card to the CPU's
    picks, and counts separately the picks it makes otherwise."""

    def __init__(self, replay=None):
        self.calls, self.replay = [], replay

    def __enter__(self):
        from repro_torch.models import moe
        self.real, moe._route = moe._route, self.route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._route = self.real

    def route(self, p, xt, cfg):
        logits = torch.matmul(xt.float(), p["router"].float())
        probs = torch.softmax(logits, dim=-1)
        if self.replay is None:
            vals, idx = torch.topk(probs, cfg.moe_top_k, dim=-1)
        else:
            idx = self.replay[len(self.calls)][1].to(xt.device)
            vals = torch.gather(probs, -1, idx)
        self.calls.append((probs.cpu(), idx.cpu()))
        vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
        return vals, idx


class LayerIO:
    """Records the input and output hidden states of every
    ``models.model._apply_layer`` call (on the host), or runs each call on
    a recorded input in place of its own (``feed``): the bf16 check of the
    16-layer Jamba smoke model runs each layer on the card from the CPU's
    input, as a last-bit difference in one bf16 product moves its logits
    by up to half the largest on the CPU alone."""

    def __init__(self, feed=None):
        self.ins, self.outs, self.feed = [], [], feed

    def __enter__(self):
        from repro_torch.models import model as M
        self.real, M._apply_layer = M._apply_layer, self.apply
        return self

    def __exit__(self, *exc):
        from repro_torch.models import model as M
        M._apply_layer = self.real

    def apply(self, cfg, spec, p, h, *args, **kw):
        if self.feed is not None:
            h = self.feed[len(self.outs)].to(h.device, h.dtype)
        self.ins.append(h.cpu())
        out = self.real(cfg, spec, p, h, *args, **kw)
        self.outs.append(out[0].float().cpu())
        return out


def first_flips(cpu_calls, card_calls) -> tuple[int, int, float]:
    """(picks that differ over all calls, tokens flipped at the first call
    where any differs, the largest relative gap on the CPU between a
    flipped token's k-th and (k+1)-th probability there)."""
    differ, first, gap = 0, 0, 0.0
    for (probs, want), (_, got) in zip(cpu_calls, card_calls):
        same = (torch.sort(want, -1).values == torch.sort(got, -1).values)
        bad = ~same.all(-1)
        differ += int((~same).sum())
        if first == 0 and bool(bad.any()):
            first = int(bad.sum())
            k = want.shape[-1]
            top = torch.topk(probs[bad], k + 1, dim=-1).values
            gap = float(((top[..., k - 1] - top[..., k]) / top[..., k - 1])
                        .max())
    return differ, first, gap


def family_checks(arch, cut, args, dev) -> dict:
    """``cut`` (published widths cut to 2 layers, or the smoke config)
    drawn on the card from --seed and copied to the host: the card's
    prefill and per-slot decode logits against the CPU's on the same
    weights and tokens, in f32 to ``LM_F32_TOL`` and bf16 to
    ``LM_BF16_TOL``.  An MoE config's bf16 logits are compared with the
    card on the CPU's expert picks (``Routes``); its own picks may differ
    from the CPU's only at near-ties: at the first layer where any
    differs, each flipped token's k-th and (k+1)-th CPU probabilities lie
    within ``LM_BF16_TOL`` of each other."""
    import dataclasses

    from repro_torch.models import model as M
    params = M.init(cut, torch.Generator(dev).manual_seed(args.seed))
    host = M.to_device(params, "cpu")
    rng = np.random.default_rng(args.seed)
    toks = rng.integers(1, cut.vocab_size, (2, LM_PROMPT + LM_DECODE))
    frames = (rng.standard_normal((2, cut.encoder_seq, cut.d_model),
                                  dtype=np.float32) if cut.is_encdec
              else None)
    moe = any(s.ffn == "moe" for s in cut.pattern)
    by_layer = arch in FAM_SMOKE
    checks = {}
    for tag, dtype, tol in (("f32", torch.float32, LM_F32_TOL),
                            ("bf16", torch.bfloat16, LM_BF16_TOL)):
        cfg = dataclasses.replace(cut, compute_dtype=dtype, cache_dtype=dtype)
        t0 = time.perf_counter()
        with Routes() as free:
            got = lm_logits(cfg, M.cast_weights(params, dtype), toks, dev,
                            frames)
        t1 = time.perf_counter()
        with Routes() as cpu, LayerIO() as layers:
            want = lm_logits(cfg, M.cast_weights(host, dtype), toks, "cpu",
                             frames)
        t2 = time.perf_counter()
        free_err = float((got - want).abs().max() / want.abs().max())
        differ, first, gap = first_flips(cpu.calls, free.calls)
        picks = sum(i.numel() for _, i in cpu.calls)
        route = ""
        if moe:
            route = (f"; expert picks: {differ} of {picks} differ from the "
                     f"CPU's, {first} tokens first (CPU gap <= {gap:.2e})")
        layer_err = None
        if moe and dtype == torch.bfloat16:
            feed = layers.ins if by_layer else None
            with Routes(replay=cpu.calls), LayerIO(feed=feed) as fed:
                got = lm_logits(cfg, M.cast_weights(params, dtype), toks,
                                dev, frames)
            route += ", logits on the CPU's picks"
            if by_layer:
                layer_err = max(float((a - b).abs().max() / b.abs().max())
                                for a, b in zip(fed.outs, layers.outs))
                route += (f", each layer from the CPU's input: max |diff| / "
                          f"max |output| {layer_err:.3e} (free-running "
                          f"logits {free_err:.3e}, not required)")
                require(layer_err <= tol, f"{arch} {tag} by layer: "
                        f"{layer_err:.3e} > {tol:g}")
            require(gap <= tol, f"{arch} {tag}: an expert pick flipped at a "
                    f"CPU probability gap of {gap:.2e}")
        elif moe:
            require(differ == 0, f"{arch} {tag}: {differ} expert picks "
                    "differ from the CPU's")
        err = float((got - want).abs().max() / want.abs().max())
        same = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        enc = (f", {cut.encoder_layers} encoder layers over "
               f"{cut.encoder_seq} frames" if cut.is_encdec else "")
        print(f"check {arch} d_model {cut.d_model}, {cut.num_layers} "
              f"layers{enc}, {tag}: prefill {LM_PROMPT} + {LM_DECODE} "
              f"per-slot decode steps, 2 rows, card vs CPU: max |diff| / "
              f"max |logit| {err:.3e} (tol {tol:g}), argmax equal at "
              f"{same:.4f} of positions{route} (card {t1 - t0:.2f} s, CPU "
              f"{t2 - t1:.2f} s)")
        require(math.isfinite(err) and err <= tol,
                f"{arch} {tag} card vs CPU: {err:.3e} > {tol:g}")
        checks[tag] = dict(rel_err=err, argmax_equal=same)
        if layer_err is not None:
            checks[tag]["layer_err"] = layer_err
        if moe:
            checks[tag].update(picks=picks, picks_differ=differ,
                               first_flipped=first, flip_gap=gap,
                               free_err=free_err)
    return checks


def profile_step(fn, label, smi):
    """One profiled call of ``fn`` (a decode step and its host read, inside
    ``LM_STEP_RANGE``): its host syncs, those inside ``DECODE_RANGE`` (none
    allowed; at most one in the step) and the device's idle share."""
    from repro_torch.analyze.trace_checks import syncs_of
    from repro_torch.launch import serve as S

    def one_step():
        with torch.profiler.record_function(LM_STEP_RANGE):
            fn()

    events = profiled_events(one_step)
    inside, ranges, dtoh = syncs_of(events, S.DECODE_RANGE)
    step_syncs, _, _ = syncs_of(events, LM_STEP_RANGE)
    busy, span, n_dev, _, _ = busy_of(events)
    idle = 1.0 - busy / span if span else float("nan")
    require(ranges == 1 and not inside,
            f"{label}: host syncs inside the decode range: {inside}")
    require(len(step_syncs) <= 1, f"{label}: host syncs in a step: "
            f"{step_syncs}")
    print(f"{label} decode step profiled: {len(step_syncs)} host syncs in "
          f"the step ({step_syncs}), {len(inside)} inside "
          f"{S.DECODE_RANGE}, {dtoh} device-to-host copies, {n_dev} device "
          f"records, device busy {busy:.3f} ms of a {span:.3f} ms span "
          f"(idle share {idle:.4f}) [{smi}]")
    return dict(host_syncs_per_step=len(step_syncs),
                syncs_in_decode_range=len(inside), decode_busy_ms=busy,
                decode_span_ms=span, idle_share=idle, device_records=n_dev)


def print_bounds(arch, costs, prefill_ms, decode_ms, rows, prompt, smi):
    pre_bound, pre_by = lm_bound(costs["pre_bytes"], costs["pre_flops"])
    dec_bound, dec_by = lm_bound(costs["dec_bytes"], costs["dec_flops"])
    print(f"{arch} prefill of a {prompt}-token prompt: {prefill_ms:.3f} ms "
          f"(bound {pre_bound:.3f} ms by {pre_by}: {costs['pre_bytes']} "
          f"bytes, {costs['pre_flops'] / 1e12:.4f} TFLOP; "
          f"{pre_bound / prefill_ms:.3f} of bound) [{smi}]")
    print(f"{arch} decode step ({rows} rows): {decode_ms:.3f} ms (bound "
          f"{dec_bound:.3f} ms by {dec_by}: {costs['dec_bytes']} bytes at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, {costs['dec_flops'] / 1e12:.4f}"
          f" TFLOP at {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s; "
          f"{dec_bound / decode_ms:.3f} of bound) [{smi}]")
    return dict(prefill_bound_ms=pre_bound, prefill_bound_by=pre_by,
                decode_bound_ms=dec_bound, decode_bound_by=dec_by)


def family_leg(args) -> dict:
    """One LM model (``args.arch``), in its own process.

    1. The card against the CPU: the published widths cut to 2 layers
       (Whisper: 2 encoder and 2 decoder layers over its 1500 frames), or
       the smoke config for ``FAM_SMOKE``, in f32 and bf16.
    2. ``FAM_SERVED`` (Qwen3-4B first): ``serve`` at full width and depth
       on weights drawn once (bf16, leaf by leaf): the stream and its
       repeat (equal tokens required), the deadline stream where there is
       one; slot ages, and a refill into a used slot against a fresh
       engine; one decode step of full slots profiled for host syncs and
       the idle share; prefill and decode times (the repeat's, on the host
       clock: each ends in a host read) beside their bounds.
    3. Whisper: its encoder and a prefill, then ``WH_STEPS`` greedy decode
       steps at full width and depth, twice with equal tokens, one step
       profiled, times beside their bounds."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    t_leg = time.perf_counter()
    arch = args.arch
    dev = torch.device(DEVICE)
    card = dev.type == "cuda"
    smi = nvidia_smi_line() if card else "cpu"
    mod = ARCHS[arch]
    if arch in FAM_SMOKE:
        checks = family_checks(arch, mod.smoke_config(), args, dev)
        wall = time.perf_counter() - t_leg
        print(f"{arch} leg: {wall:.1f} s wall (smoke size only)")
        return dict(arch=arch, cpu_check=checks, wall_s=wall)
    full = mod.smoke_config() if LM_SMOKE else mod.CONFIG
    cut = dataclasses.replace(full, num_layers=LM_CPU_LAYERS)
    if full.is_encdec:
        cut = dataclasses.replace(cut, encoder_layers=LM_CPU_LAYERS)
    checks = family_checks(arch, cut, args, dev)
    if card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(args.seed)
    weights = M.init(full, gen, weight_dtype=full.compute_dtype)
    if card:
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    wbytes = sum(t.numel() * t.element_size() for t in M.leaves(weights))
    enc = f" + {full.encoder_layers} encoder" if full.is_encdec else ""
    route = ("bmm(out_dtype=float32)" if card and L._bmm_out_dtype()
             else "float32 copies")
    print(f"{arch}: {full.num_layers}{enc} layers built in {build_s:.3f} s, "
          f"{wbytes} weight bytes; attention logits from bf16 operands by "
          f"{route} [{smi}]")
    out = dict(arch=arch, layers=full.num_layers, cpu_check=checks,
               build_s=build_s, weight_bytes=wbytes)
    if full.is_encdec:
        out.update(whisper_run(full, weights, gen, args, dev, smi))
    else:
        out.update(served_run(arch, full, weights, args, dev, smi))
    out["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30 if card
                       else float("nan"))
    out["wall_s"] = time.perf_counter() - t_leg
    print(f"{arch} leg: {out['wall_s']:.1f} s wall, peak device memory "
          f"{out['peak_gib']:.2f} GiB [{smi}]")
    return out


def served_run(arch, full, weights, args, dev, smi) -> dict:
    """Step 2 of ``family_leg``."""
    from repro_torch.launch import serve as S
    prompt_len, deadline = FAM_SERVED[arch]
    kw = dict(requests=LM_REQUESTS, batch=LM_SLOTS, max_new=LM_MAX_NEW,
              prompt_len=prompt_len, max_len=LM_MAX_LEN, seed=args.seed,
              smoke=LM_SMOKE, quiet=True, params=weights, device=dev)
    streams = [("first", {}), ("repeat", {})]
    if deadline is not None:
        streams.append(("deadline", dict(max_rounds=deadline,
                                         max_evictions=LM_MAX_EVICTIONS)))
    runs = {}
    for label, extra in streams:
        st = {}
        reqs = S.serve(arch, stats=st, **kw, **extra)
        rids = sorted(r.rid for r in reqs)
        require(rids == list(range(LM_REQUESTS)),
                f"{arch} {label}: rids finished {rids}")
        for r in reqs:
            require(r.done and 1 <= len(r.out) <= LM_MAX_NEW
                    and all(0 <= x < full.padded_vocab for x in r.out),
                    f"{arch} {label}: request {r.rid} gave {len(r.out)} "
                    f"tokens {r.out[:8]}")
        runs[label] = ({r.rid: r.out for r in reqs}, st,
                       sum(r.evictions for r in reqs))
        print(f"{arch} serve {label}: {len(reqs)} requests of {prompt_len} "
              f"tokens, {st['tokens']} tokens, {st['decode_steps']} decode "
              f"steps, {st['prefills']} prefills, evictions "
              f"{runs[label][2]}, {st['wall_s']:.3f} s "
              f"({st['tokens'] / st['wall_s']:.1f} tokens/s) [{smi}]")
    require(runs["repeat"][0] == runs["first"][0],
            f"{arch}: the repeated stream's tokens differ from the first's")
    out = {}
    if deadline is not None:
        require(runs["deadline"][2] > 0, f"{arch}: the deadline evicted "
                "nothing")
        out["deadline_streams_equal"] = sum(
            runs["deadline"][0][i] == runs["first"][0][i]
            for i in range(LM_REQUESTS))
        out["evictions"] = runs["deadline"][2]
        print(f"{arch} serve deadline vs first: "
              f"{out['deadline_streams_equal']} of {LM_REQUESTS} token "
              "streams equal (not required in bf16)")

    rng = np.random.default_rng(args.seed + 1)
    prompts = [rng.integers(1, full.vocab_size, prompt_len, dtype=np.int32)
               for _ in range(LM_SLOTS + 1)]
    eng = S.Engine(full, batch=LM_SLOTS, max_len=LM_MAX_LEN, params=weights,
                   device=dev)
    eng.admit(S.Request(0, prompts[0], LM_MAX_NEW), 0)
    for expect in (1, 2, 3):
        eng.step()
        require(eng.age[0] == expect and eng.age[1] == 0,
                f"{arch} ages after {expect} steps: {eng.age}")
    late = S.Request(1, prompts[1], 6)
    eng.admit(late, 0)
    require(eng.age[0] == 0, f"{arch}: refilled slot's age {eng.age[0]}")
    while not late.done:
        eng.step()
    fresh = S.Engine(full, batch=LM_SLOTS, max_len=LM_MAX_LEN,
                     params=weights, device=dev)
    alone = S.Request(1, prompts[1], 6)
    fresh.admit(alone, 0)
    while not alone.done:
        fresh.step()
    require(late.out == alone.out, f"{arch}: refill into a used slot gave "
            f"{late.out}, a fresh engine {alone.out}")
    del fresh
    print(f"{arch} serve engine: ages count decode steps and reset on "
          "refill; a refill into a used slot (every cache leaf spliced) "
          "gives the fresh engine's tokens")
    for i in range(LM_SLOTS):
        eng.admit(S.Request(10 + i, prompts[i], 10 ** 6), i)
    eng.step()
    out.update(profile_step(eng.step, f"{arch} serve", smi))
    del eng

    rep = runs["repeat"][1]
    prefill_ms = rep["prefill_s"] / rep["prefills"] * 1e3
    decode_ms = rep["step_s"] / rep["steps"] * 1e3
    costs = family_costs(full, weights, LM_SLOTS, LM_MAX_LEN, prompt_len)
    out.update(print_bounds(arch, costs, prefill_ms, decode_ms, LM_SLOTS,
                            prompt_len, smi))
    out.update(prefill_ms=prefill_ms, decode_ms=decode_ms,
               tokens_per_s=rep["tokens"] / rep["wall_s"],
               decode_steps=rep["decode_steps"], prompt_len=prompt_len,
               decode_bytes=costs["dec_bytes"], decode_flops=costs["dec_flops"])
    print(f"{arch}: {out['tokens_per_s']:.1f} tokens/s over the repeat "
          f"stream [{smi}]")
    return out


def whisper_run(full, weights, gen, args, dev, smi) -> dict:
    """Step 3 of ``family_leg``."""
    from repro_torch.launch import serve as S
    from repro_torch.models import model as M
    card = dev.type == "cuda"
    frames = torch.randn(WH_ROWS, full.encoder_seq, full.d_model,
                         generator=gen, device=dev)
    toks = torch.as_tensor(np.random.default_rng(args.seed).integers(
        1, full.vocab_size, (WH_ROWS, WH_PROMPT)), device=dev)
    state = {}

    def sync():
        if card:
            torch.cuda.synchronize()

    def prefill():
        logits, state["cache"] = M.forward(
            full, weights, {"tokens": toks, "enc_frames": frames},
            make_cache_len=WH_CACHE)
        state["nxt"] = torch.argmax(logits[:, -1], -1)
        state["pos"] = WH_PROMPT

    def step():
        with torch.profiler.record_function(S.DECODE_RANGE):
            logits, state["cache"] = M.decode_step(
                full, weights, state["nxt"][:, None], state["cache"],
                state["pos"])
            state["nxt"] = torch.argmax(logits[:, -1], -1)
        state["pos"] += 1
        return state["nxt"].tolist()

    runs = []
    for label in ("first", "repeat"):
        sync()
        t0 = time.perf_counter()
        prefill()
        sync()
        t1 = time.perf_counter()
        toks_out = [step() for _ in range(WH_STEPS)]
        t2 = time.perf_counter()
        runs.append((toks_out, t1 - t0, t2 - t1))
        require(all(0 <= x < full.padded_vocab for row in toks_out
                    for x in row), f"whisper {label}: tokens {toks_out[:2]}")
        print(f"whisper {label}: encoder + prefill of {WH_ROWS} rows x "
              f"{WH_PROMPT} tokens over {full.encoder_seq} frames "
              f"{(t1 - t0) * 1e3:.3f} ms, {WH_STEPS} decode steps "
              f"{(t2 - t1) * 1e3:.3f} ms [{smi}]")
    require(runs[0][0] == runs[1][0],
            "whisper: the repeat's tokens differ from the first's")
    prefill()
    step()
    out = profile_step(step, "whisper", smi)
    del state["cache"]
    _, prefill_s, decode_s = runs[1]
    prefill_ms, decode_ms = prefill_s * 1e3, decode_s / WH_STEPS * 1e3
    costs = family_costs(full, weights, WH_ROWS, WH_CACHE, WH_PROMPT)
    out.update(print_bounds("whisper", costs, prefill_ms, decode_ms, WH_ROWS,
                            WH_PROMPT, smi))
    out.update(prefill_ms=prefill_ms, decode_ms=decode_ms,
               tokens_per_s=WH_ROWS * WH_STEPS / decode_s,
               decode_steps=WH_STEPS, prompt_len=WH_PROMPT,
               decode_bytes=costs["dec_bytes"], decode_flops=costs["dec_flops"])
    print(f"whisper: {out['tokens_per_s']:.1f} tokens/s over "
          f"{WH_STEPS} decode steps of {WH_ROWS} rows [{smi}]")
    return out


# ---------------------------------------------------------------------------
# The train leg
# ---------------------------------------------------------------------------

def train_leg_child(args) -> dict:
    """The train leg, one child process a model of ``TRAIN_ARCHS``
    (``chip_smoke.py --leg train --arch A``), with cuBLAS's deterministic
    workspace in its environment.  Echoes each child's lines, raises if
    one failed, returns {"train": {arch: its JSON}}."""
    return {"train": {arch: _leg_child(f"train {arch}", "train", "--arch",
                                       arch, seed=args.seed, timeout=900,
                                       deterministic=True)
                      for arch in TRAIN_ARCHS}}


def _rel(got, want) -> float:
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    scale = float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    return err / scale if scale > 0 else err


def train_check(cfg, label, tol, args, dev) -> dict:
    """One train step of ``cfg`` on the card against the CPU from the same
    state (drawn on the card from --seed, copied to the host) and the same
    loader batch: the loss, the grad norm and every grad leaf to ``tol``
    of its largest magnitude; then the parameters and the optimizer state
    after the card's step against the CPU's optimizer applied to the
    card's grads (the same bits the card's step computes, with
    deterministic algorithms on), the first moments and parameters to
    ``tol``, the statistics of squared grads to 2·tol.  (Applied to its
    own grads, the CPU's first step would move an element whose grad is
    near zero by up to lr either way: it divides each grad by statistics
    of its own size.)"""
    from repro_torch import tree as T
    from repro_torch.data.loader import LoaderConfig, TokenLoader
    from repro_torch.launch import train as TR
    from repro_torch.models import model as M
    from repro_torch.models import steps as TS
    from repro_torch.optim import adafactor, adamw
    t0 = time.perf_counter()
    state = TS.init_train_state(cfg, torch.Generator(dev).manual_seed(
        args.seed))
    host = T.map_tree(lambda x: x.to("cpu", copy=True), state)
    loader = TokenLoader(LoaderConfig(cfg.vocab_size, TRAIN_CHECK_ROWS,
                                      TRAIN_CHECK_SEQ, seed=args.seed),
                         device=dev)
    batch = loader.batch_at(0)
    if cfg.is_encdec:
        batch["enc_frames"] = TR.enc_frames(cfg, TRAIN_CHECK_ROWS,
                                            args.seed, 0, dev)
    hbatch = {k: v.cpu() for k, v in batch.items()}
    _, grads_c = TS.loss_and_grads(cfg, state.params, batch)
    loss_h, grads_h = TS.loss_and_grads(cfg, host.params, hbatch)
    grads_c = [g.cpu() for g in grads_c]
    grad_err = max(_rel(a, b) for a, b in zip(grads_c, grads_h))
    norm_h = adamw.global_norm(grads_h)
    del grads_h
    state, m_c = TS.make_train_step(cfg, lr=TRAIN_CHECK_LR)(state, batch)
    loss_err = _rel(m_c["loss"], loss_h)
    norm_err = _rel(m_c["grad_norm"], norm_h)
    if cfg.optimizer == "adafactor":
        opt, _ = adafactor.apply(
            grads_c, host.opt, T.leaves(host.params), TRAIN_CHECK_LR,
            groups=adafactor.layout(host.params, M.ref_layout(cfg)))
    else:
        opt, _ = adamw.apply(grads_c, host.opt, T.leaves(host.params),
                             TRAIN_CHECK_LR)
    first = ("mu",) if cfg.optimizer == "adamw" else ()
    mom_err = sq_err = 0.0
    for name in opt._fields[:-1]:
        for a, b in zip(T.leaves(getattr(state.opt, name)),
                        T.leaves(getattr(opt, name))):
            if name in first:
                mom_err = max(mom_err, _rel(a, b))
            else:
                sq_err = max(sq_err, _rel(a, b))
    par_err = max(_rel(a, b) for a, b in zip(T.leaves(state.params),
                                             T.leaves(host.params)))
    ok = (max(loss_err, norm_err, grad_err, mom_err, par_err) <= tol
          and sq_err <= 2 * tol and int(state.step) == 1
          and int(opt.count) == 1)
    print(f"check train {label}: card vs CPU, one step of "
          f"{TRAIN_CHECK_ROWS} x {TRAIN_CHECK_SEQ} tokens: loss "
          f"{loss_err:.3e}, grad norm {norm_err:.3e}, grads {grad_err:.3e}; "
          f"after the step (the CPU's optimizer on the card's grads): "
          f"first moments {mom_err:.3e}, squared statistics {sq_err:.3e}, "
          f"params {par_err:.3e} (tol {tol:g}, squared 2x) "
          f"({time.perf_counter() - t0:.2f} s)")
    require(ok and math.isfinite(loss_err + grad_err),
            f"train {label}: card vs CPU beyond tolerance")
    return dict(loss=loss_err, grad_norm=norm_err, grads=grad_err,
                moments=mom_err, squared=sq_err, params=par_err)


def top_device_ops(events, n: int = 8) -> list:
    """[(name, summed device ms, count)] of a profiler window's device
    records, grouped by name, the ``n`` costliest."""
    tot: dict[str, list] = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False) and \
                not e.name.startswith(("repro_torch.", "chip_smoke.")):
            t = tot.setdefault(e.name[:60], [0.0, 0])
            t[0] += (e.time_range.end - e.time_range.start) / 1e3
            t[1] += 1
    return sorted(((k, v[0], v[1]) for k, v in tot.items()),
                  key=lambda x: -x[1])[:n]


def min_ms(fn, reps: int = 2) -> float:
    """The best of ``reps`` host-clock times of ``fn``, the card
    synchronized around each."""
    best = float("inf")
    for _ in range(reps):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def bmm_out_dtype_backward(dev) -> str:
    """Whether this PyTorch's ``bmm(..., out_dtype=float32)`` has a
    backward on the card (``layers.matmul_f32`` takes float32 copies
    whenever autograd records the product, either way)."""
    a = torch.ones(1, 2, 2, dtype=torch.bfloat16, device=dev,
                   requires_grad=True)
    try:
        torch.bmm(a, a.detach(), out_dtype=torch.float32).sum().backward()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        return f"no backward ({type(e).__name__}: {str(e)[:120]})"
    return "a backward"


def train_leg(args) -> dict:
    """One model of ``TRAIN_ARCHS`` (``args.arch``), in its own process,
    with deterministic algorithms on.

    1. Qwen3-4B's child first checks the card against the CPU
       (``train_check``): the published widths cut to 2 layers in f32 and
       bf16, then every smoke config with AdamW and with Adafactor.
    2. ``launch.train.train`` at full width and depth, ``TRAIN_STEPS`` of
       ``TRAIN_ROWS`` x ``TRAIN_SEQ`` loader tokens: the loss must fall;
       its ms a step (the median after two warm-up steps, host clock, the
       loss read included) beside ``train_costs``' bound, tokens/s, 6·n·T
       over the step time and the peak rate; one more training step
       profiled for its host syncs (only the loss read; none inside
       ``steps.STEP_RANGE``) and the device's idle share; peak memory.
    3. Granite's child then kills and resumes a smoke-size run
       (``TRAIN_RESUME``): the resumed losses equal the uninterrupted
       run's bit for bit."""
    from repro_torch.launch import train as TR

    t_leg = time.perf_counter()
    arch = args.arch
    require(arch in TRAIN_ARCHS, f"--leg train: --arch {arch} is not one "
            f"of {TRAIN_ARCHS}")
    dev = torch.device(DEVICE)
    card = dev.type == "cuda"
    smi = nvidia_smi_line() if card else "cpu"
    with TR.deterministic(dev):
        return _train_leg(arch, args, dev, card, smi, t_leg)


def _train_leg(arch, args, dev, card, smi, t_leg) -> dict:
    """``train_leg``'s body, with deterministic algorithms on."""
    import dataclasses
    import statistics as stats_mod

    from repro_torch.analyze.trace_checks import syncs_of
    from repro_torch.configs import ARCHS
    from repro_torch.data.loader import LoaderConfig, TokenLoader
    from repro_torch.launch import train as TR
    from repro_torch.models import steps as TS

    out = dict(arch=arch)
    if arch == LM_ARCH:
        print("bmm(out_dtype=float32) on the card has "
              f"{bmm_out_dtype_backward(dev)}")
        cut = dataclasses.replace(ARCHS[arch].CONFIG,
                                  num_layers=LM_CPU_LAYERS)
        checks = {}
        for tag, dtype, tol in (("f32", torch.float32, LM_F32_TOL),
                                ("bf16", torch.bfloat16, LM_BF16_TOL)):
            cfg = dataclasses.replace(cut, compute_dtype=dtype)
            checks[tag] = train_check(cfg, f"{arch} d_model {cut.d_model}, "
                                      f"{cut.num_layers} layers, {tag}",
                                      tol, args, dev)
        for name in sorted(ARCHS):
            for opt in ("adamw", "adafactor"):
                cfg = dataclasses.replace(ARCHS[name].smoke_config(),
                                          optimizer=opt)
                checks[f"{name}/{opt}"] = train_check(
                    cfg, f"{name} smoke, {opt}", LM_F32_TOL, args, dev)
        out["cpu_check"] = checks
    if card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    cfg = ARCHS[arch].smoke_config() if LM_SMOKE else ARCHS[arch].CONFIG
    st = {}
    t0 = time.perf_counter()
    state, losses = TR.train(arch, smoke=LM_SMOKE, steps=TRAIN_STEPS,
                             batch=TRAIN_ROWS, seq=TRAIN_SEQ, lr=TRAIN_LR,
                             seed=args.seed, log_every=5, device=dev,
                             stats=st)
    wall = time.perf_counter() - t0
    require(all(math.isfinite(x) for x in losses), f"{arch}: losses {losses}")
    late = sum(losses[-5:]) / 5
    require(late < losses[0], f"{arch}: loss did not fall: first "
            f"{losses[0]:.4f}, mean of the last five {late:.4f}")
    step_s = stats_mod.median(st["step_s"][2:])
    costs = train_costs(cfg, state.params, TRAIN_ROWS, TRAIN_SEQ)
    flop_ms = costs["flops"] / BF16_FLOPS_PER_S * 1e3
    byte_ms = costs["opt_bytes"] / HBM_BYTES_PER_S * 1e3
    bound_ms = flop_ms + byte_ms
    toks_s = costs["tokens"] / step_s
    util = 6 * costs["active"] * costs["tokens"] / step_s / BF16_FLOPS_PER_S
    print(f"{arch} train: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{costs['params']} parameters, {cfg.optimizer}, remat "
          f"{cfg.remat}; {TRAIN_STEPS} steps of {TRAIN_ROWS} x {TRAIN_SEQ} "
          f"tokens in {wall:.1f} s; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (mean of the last five {late:.4f}) [{smi}]")
    print(f"{arch} train step: {step_s * 1e3:.1f} ms (median of steps "
          f"3-{TRAIN_STEPS}; bound {bound_ms:.1f} ms = "
          f"{costs['flops'] / 1e12:.2f} TFLOP at "
          f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s ({flop_ms:.1f} ms) + "
          f"{costs['opt_bytes'] / 1e9:.1f} GB of optimizer traffic at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s ({byte_ms:.1f} ms); "
          f"{bound_ms / (step_s * 1e3):.3f} of bound); {toks_s:.0f} "
          f"tokens/s; 6·n·T / (step time · peak) {util:.4f} with n = "
          f"{costs['active']} [{smi}]")
    loader = TokenLoader(LoaderConfig(cfg.vocab_size, TRAIN_ROWS, TRAIN_SEQ,
                                      seed=args.seed), device=dev)
    step = TS.make_train_step(cfg, lr=TRAIN_LR)
    box = {"state": state}
    del state

    def one_step():
        with torch.profiler.record_function(TRAIN_RANGE):
            box["state"], m = step(box["state"],
                                   loader.batch_at(TRAIN_STEPS))
            box["loss"] = float(m["loss"])

    events = profiled_events(one_step) if card else []
    step_syncs, _, _ = syncs_of(events, TRAIN_RANGE)
    waits = [n for n in step_syncs if n.endswith("Synchronize")]
    reads = step_syncs.count("aten::item")
    inside, ranges, dtoh = syncs_of(events, TS.STEP_RANGE)
    busy, span, n_dev, _, _ = busy_of(events)
    idle = 1.0 - busy / span if span else float("nan")
    if card:
        require(ranges == 1 and not inside,
                f"{arch}: host syncs inside {TS.STEP_RANGE}: {inside}")
        require(len(waits) == 1 and reads == 1, f"{arch}: host syncs in a "
                f"training step: {step_syncs}")
    print(f"{arch} train step profiled: {len(waits)} host wait in the "
          f"training step, the loss read ({step_syncs}), {len(inside)} "
          f"inside {TS.STEP_RANGE}, {dtoh} device-to-host copies, {n_dev} "
          f"device records, device busy {busy:.1f} ms of a {span:.1f} ms "
          f"span (idle share {idle:.4f}) [{smi}]")
    kernels = top_device_ops(events)
    print(f"{arch} train step, device time by operation (top of "
          f"{busy:.1f} ms): " + "; ".join(f"{n} {ms:.1f} ms x{c}"
                                          for n, ms, c in kernels))
    batch = loader.batch_at(TRAIN_STEPS + 1)

    def grads_only():
        TS.loss_and_grads(cfg, box["state"].params, batch)

    def whole_step():
        box["state"], m = step(box["state"], batch)
        float(m["loss"])
    grads_ms, step_ms = min_ms(grads_only), min_ms(whole_step)
    print(f"{arch} train step phases (host clock, the best of two): "
          f"autograd (forward, remat recompute, backward) {grads_ms:.1f} ms "
          f"of the step's {step_ms:.1f} ms; the clip and the optimizer "
          f"{step_ms - grads_ms:.1f} ms [{smi}]")
    del box
    peak = torch.cuda.max_memory_allocated() / 2**30 if card else float("nan")
    print(f"{arch} train: peak device memory {peak:.2f} GiB [{smi}]")
    out.update(layers=cfg.num_layers, losses=losses, step_ms=step_s * 1e3,
               bound_ms=bound_ms, flop_ms=flop_ms, opt_byte_ms=byte_ms,
               tokens_per_s=toks_s, six_nt_util=util,
               host_syncs_per_step=len(waits),
               syncs_in_step_range=len(inside), idle_share=idle,
               busy_ms=busy, span_ms=span, device_records=n_dev,
               peak_gib=peak, params=costs["params"], grads_ms=grads_ms,
               optimizer_ms=step_ms - grads_ms, top_device_ops=kernels,
               active_params=costs["active"], tokens=costs["tokens"])
    if card:
        torch.cuda.empty_cache()

    if arch == TRAIN_ARCHS[-1]:
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            tmp = pathlib.Path(tmp)
            kw = dict(TRAIN_RESUME, device=dev, seed=args.seed)
            _, whole = TR.train(arch, ckpt_dir=tmp / "whole", **kw)
            try:
                TR.train(arch, ckpt_dir=tmp / "cut", simulate_failure_at=5,
                         **kw)
                require(False, f"{arch}: the simulated failure did not fire")
            except TR.SimulatedFailure:
                pass
            _, resumed = TR.train(arch, ckpt_dir=tmp / "cut", **kw)
        same = whole[3:] == resumed
        print(f"{arch} kill and resume at the smoke size: {len(whole)} "
              f"steps; killed after step 5, resumed from the step-3 "
              f"checkpoint; the resumed losses "
              f"{'equal' if same else 'DIFFER FROM'} the uninterrupted "
              f"run's bit for bit ({resumed[:3]}...)")
        require(same, f"{arch}: resumed losses {resumed} != {whole[3:]}")
        out["resume_bit_identical"] = same
    out["wall_s"] = time.perf_counter() - t_leg
    print(f"{arch} train leg: {out['wall_s']:.1f} s wall [{smi}]")
    return out


# ---------------------------------------------------------------------------
# shard leg: the LM sharding layer (models/sharding.py, launch/mesh.py,
# launch/specs.py, launch/dryrun.py; torch code, no kernel of its own)
# ---------------------------------------------------------------------------

def examples_leg_child(args) -> dict:
    """The examples leg in one child process (``chip_smoke.py --leg
    examples``), with cuBLAS's deterministic workspace in its environment
    (``train_lm`` trains under deterministic algorithms).  Echoes its
    lines, raises if it failed, returns {"examples": its JSON}."""
    t0 = time.perf_counter()
    found = _leg_child("examples", "examples", seed=args.seed, timeout=600,
                       deterministic=True)
    found["wall_s"] = time.perf_counter() - t0
    print(f"examples leg: {found['wall_s']:.1f} s wall, the child's start "
          "included")
    return {"examples": found}


def _cpu_example(name: str) -> tuple[dict, float]:
    """``repro_torch.examples.<name>`` on the CPU in a worker process (its
    printed lines dropped): its numbers and host seconds.  The examples
    leg runs the solver examples' CPU twins there once lm_probe's timed
    sections are done, beside train_lm and the solver examples' card
    runs."""
    import contextlib
    import importlib
    import io

    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(4)
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = mod.main(["--device", "cpu"])
    return out, time.perf_counter() - t0


def _example_twins(name, twin, kernels, smi) -> tuple[dict, dict, dict]:
    """``repro_torch.examples.<name>`` on the card (its kernel launches
    counted from 0, timed on the host clock) against ``twin``, the future
    of its CPU run (``_cpu_example``): P* equal; ρ, F*, the λ sequence and
    every F trace within ``EX_RTOL`` of each entry (how many λ are equal
    bit for bit is printed); each final nnz within ``EX_NNZ_TOL``; a
    kernel of ``kernels`` not launched on the card fails.  Returns (the
    check's JSON, the card's numbers, the CPU's numbers)."""
    import importlib

    from repro_torch.kernels import batched as kb
    from repro_torch.kernels import shotgun_block as sb
    from repro_torch.kernels import shotgun_sparse as ss

    main = importlib.import_module(f"repro_torch.examples.{name}").main
    for mod in (sb, ss, kb):
        mod.reset_launches()
    t0 = time.perf_counter()
    card = main(["--device", DEVICE])
    card_s = time.perf_counter() - t0
    launches = {k: v for mod in (sb, ss, kb) for k, v in mod.LAUNCHES.items()
                if v}
    cpu, cpu_s = twin.result()
    require(card["p_star"] == cpu["p_star"],
            f"{name}: P* {card['p_star']} on the card, {cpu['p_star']} on "
            "the CPU")
    errs = {k: trace_rel(card[k], cpu[k]) for k in card
            if k in ("rho", "fstar", "lambdas", "objectives")
            or k.endswith("_F")}
    nnz = {k: int(np.max(np.abs(np.asarray(card[k]) - np.asarray(cpu[k]))))
           for k in card if k == "nnz" or k.endswith("_nnz")}
    same_lams = ""
    if "lambdas" in card:
        lam, clam = np.asarray(card["lambdas"]), np.asarray(cpu["lambdas"])
        same_lams = (f", λ equal bit for bit {int(np.sum(lam == clam))} of "
                     f"{clam.size}")
    for k in kernels:
        require(launches.get(k, 0) > 0,
                f"{name}: kernel {k} was not launched ({launches})")
    worst = max(errs.values())
    print(f"{name}: card vs CPU: P* {card['p_star']} both; largest rel. "
          f"difference {worst:.3e} (" + ", ".join(
              f"{k} {v:.2e}" for k, v in errs.items()) + f"; tol {EX_RTOL:g})"
          f"{same_lams}, final nnz apart by " + ", ".join(
              f"{k} {v}" for k, v in nnz.items()) + f" (tol {EX_NNZ_TOL}); "
          f"card {card_s:.2f} s, CPU {cpu_s:.2f} s host clock (each beside "
          f"the other: the CPU's in a worker); kernel launches on the card "
          f"{launches or 'none'} [{smi}]")
    require(worst <= EX_RTOL, f"{name}: card vs CPU {errs} > {EX_RTOL:g}")
    require(max(nnz.values()) <= EX_NNZ_TOL,
            f"{name}: final nnz apart by {nnz} > {EX_NNZ_TOL}")
    return dict(p_star=card["p_star"], rel_err=errs, nnz_apart=nnz,
                launches=launches, card_s=card_s, cpu_s=cpu_s), card, cpu


def _probe_cut(args, dev, smi) -> dict:
    """``lm_probe``'s pipeline on Qwen3-4B's published widths cut to
    ``LM_CPU_LAYERS`` layers, held against the CPU: the weights drawn on
    the card from --seed, warmed up ``EX_CUT_WARMUP`` steps there and
    copied to the host; ``EX_CUT_BATCHES`` feature batches of
    ``EX_CUT_ROWS`` rows featurized on both in f32 and bf16 (features to
    ``LM_F32_TOL`` / ``LM_BF16_TOL`` of the largest, labels equal); then
    the probe on the CPU's standardized bf16 features, solved on the card
    and on the CPU on the same draws (F traces within ``EX_RTOL``)."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.data.loader import LoaderConfig, TokenLoader
    from repro_torch.examples import lm_probe as LP
    from repro_torch.models import model as M
    from repro_torch.models import steps as TS

    full = (ARCHS[LM_ARCH].smoke_config() if LM_SMOKE
            else ARCHS[LM_ARCH].CONFIG)
    cut = dataclasses.replace(full, num_layers=LM_CPU_LAYERS)
    t0 = time.perf_counter()
    state = TS.init_train_state(cut, torch.Generator(dev).manual_seed(
        args.seed))

    def loader(where):
        return TokenLoader(LoaderConfig(vocab_size=cut.vocab_size,
                                        global_batch=EX_CUT_ROWS,
                                        seq_len=LP.SEQ), device=where)

    state, loss = LP.warm_up(cut, state, loader(dev), EX_CUT_WARMUP)
    host = M.to_device(state.params, "cpu")
    out = dict(layers=cut.num_layers, d_model=cut.d_model,
               warmup_loss=float(loss))
    feats = {}
    for tag, dtype, tol in (("f32", torch.float32, LM_F32_TOL),
                            ("bf16", torch.bfloat16, LM_BF16_TOL)):
        cfg = dataclasses.replace(cut, compute_dtype=dtype)
        A, y = LP.featurize(cfg, state.params, loader(dev), EX_CUT_BATCHES)
        hA, hy = LP.featurize(cfg, host, loader("cpu"), EX_CUT_BATCHES)
        err = _rel(A, hA)
        same = bool(torch.equal(y.cpu(), hy))
        print(f"lm_probe cut {cut.num_layers} layers, d_model "
              f"{cut.d_model}, {tag}: {EX_CUT_BATCHES} x {EX_CUT_ROWS} rows "
              f"of {LP.SEQ} tokens after {EX_CUT_WARMUP} warm-up steps on "
              f"the card, card vs CPU features: max |diff| / max |feature| "
              f"{err:.3e} (tol {tol:g}), labels equal {same} [{smi}]")
        require(math.isfinite(err) and err <= tol and same,
                f"lm_probe cut {tag}: features {err:.3e} > {tol:g} or "
                f"labels differ ({same})")
        out[f"{tag}_rel_err"] = err
        feats[tag] = (hA, hy)
    del state, host
    hA, hy = feats["bf16"]
    hA = LP.standardize(hA)
    runs = {}
    for where in (dev, torch.device("cpu")):
        prob, ps, P, u = LP.probe_problem(hA.to(where), hy.to(where),
                                          EX_CUT_ROUNDS)
        runs[where.type] = (ps, P, LP.probe(prob, P, u))
    (ps, P, res), (cps, cP, cres) = runs[dev.type], runs["cpu"]
    require((ps, P) == (cps, cP), f"lm_probe cut: P*, P ({ps}, {P}) on the "
            f"card, ({cps}, {cP}) on the CPU")
    F, cF = res.trace.objective.cpu(), cres.trace.objective
    err = trace_rel(F, cF)
    print(f"lm_probe cut: Shotgun-CDN on the CPU's standardized bf16 "
          f"features ({hA.shape[0]} x {hA.shape[1]}, P* {ps}, P {P}, "
          f"{EX_CUT_ROUNDS} rounds, the same draws) card vs CPU F trace "
          f"{err:.3e} (tol {EX_RTOL:g}); the cut {time.perf_counter() - t0:.1f}"
          f" s [{smi}]")
    require(bool(torch.isfinite(F).all()) and err <= EX_RTOL,
            f"lm_probe cut: CDN trace {err:.3e} > {EX_RTOL:g}")
    out.update(cdn_rel_err=err, p_star=ps, P=P,
               seconds=time.perf_counter() - t0)
    return out


def examples_leg(args) -> dict:
    """The five example programs (``repro_torch.examples``), in one
    process, each through its ``main`` as a user calls it.

    1. ``lm_probe --full``: Qwen3-4B at full width and depth warmed up,
       featurized and probed by Shotgun-CDN on the card (its F trace
       finite and falling: no round rises by more than ``EX_RISE`` of F,
       the rounding of a refused step's recomputed F), then its 2-layer
       cut against the CPU (``_probe_cut``); nothing else runs beside it.
    2. ``train_lm`` at the smoke size: ``EX_TRAIN_STEPS`` steps saving
       every ``EX_SAVE_EVERY``; the same run stopped after ``EX_FAIL_AT``
       steps and called again, resuming: its last loss equals the
       uninterrupted run's bit for bit (deterministic algorithms on the
       card), and the resumed losses that differ in any bit are counted.
    3. ``quickstart``, ``lasso_paths`` and ``distributed_shotgun`` (one
       NCCL rank) at their own sizes on the card, each against its CPU
       run, made in a worker process from the end of 1 on
       (``_cpu_example``, ``_example_twins``), the launches of kernels
       #1, #3 and #4 by the block solves of ``distributed_shotgun``
       counted from 0; the examples' own claims, on the card and on the
       CPU: Shotgun reaches 0.5% of F* in fewer rounds than Shooting, the
       block and fused solves agree to ``EX_GAP``."""
    import concurrent.futures
    import multiprocessing

    t_leg = time.perf_counter()
    dev = torch.device(DEVICE)
    smi = nvidia_smi_line() if dev.type == "cuda" else "cpu"
    out = {"lm_probe": _probe_full(args, dev, smi)}
    # the solver examples' CPU twins, in a worker from here on
    twins = ("quickstart", "lasso_paths", "distributed_shotgun")
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=1,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu = {name: pool.submit(_cpu_example, name) for name in twins}
        out.update(_examples_on_card(dev, smi, cpu))
    out["wall_s"] = time.perf_counter() - t_leg
    print(f"examples leg body: {out['wall_s']:.1f} s wall [{smi}]")
    return out


def _probe_full(args, dev, smi) -> dict:
    """``examples_leg``'s part 1: ``lm_probe`` (``--full`` on the card),
    then its cut against the CPU; the card's cache emptied after each."""
    import gc

    from repro_torch.examples import lm_probe

    card = dev.type == "cuda"
    t0 = time.perf_counter()
    argv = ["--device", DEVICE] + ([] if LM_SMOKE else ["--full"])
    probe = lm_probe.main(argv)
    F = probe.pop("F")
    # a round's F is its accepted trial's, or the recomputed F of the
    # start point when none is accepted: the two may differ by rounding
    rise = float(np.max(np.diff(F) / np.abs(F[1:]))) if F.size > 1 else 0.0
    require(np.all(np.isfinite(F)) and rise <= EX_RISE and F[-1] < F[0],
            f"lm_probe: F trace not finite and falling (largest rise "
            f"{rise:.3e}): {F[:3]} ... {F[-3:]}")
    probe.update(F_first=float(F[0]), F_last=float(F[-1]), F_rise=rise,
                 wall_s=time.perf_counter() - t0)
    print(f"lm_probe {probe['config']}, {probe['layers']} layers, d_model "
          f"{probe['d_model']}: warm-up ({lm_probe.ROWS} x {lm_probe.SEQ} "
          f"tokens a step) first step {probe['warmup_first_ms']:.1f} ms, "
          f"then {probe['warmup_ms_a_step']:.1f} ms a step (mean of "
          f"{lm_probe.WARMUP_STEPS - 1}), featurize "
          f"{probe['featurize_ms']:.1f} ms ({probe['n']} rows), Shotgun-CDN "
          f"{probe['cdn_ms_a_round']:.4f} ms a round (P {probe['P']}, P* "
          f"{probe['p_star']}), F {probe['F_first']:.3f} -> "
          f"{probe['F_last']:.3f} (largest rise of a round {rise:.2e} of F,"
          f" tol {EX_RISE:g}), train accuracy {probe['accuracy']:.3f}, "
          f"nnz {probe['nnz']}/{probe['d']}, peak "
          + (f"{probe['peak_gib']:.2f} GiB" if card else "not measured")
          + f"; {probe['wall_s']:.1f} s, nothing else running [{smi}]")
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    probe["cut"] = _probe_cut(args, dev, smi)
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    return probe


def _examples_on_card(dev, smi, cpu) -> dict:
    """``examples_leg``'s parts 2 and 3, with the CPU twins' futures
    ``cpu``."""
    import tempfile

    from repro_torch.examples import train_lm
    from repro_torch.launch.train import SimulatedFailure

    card = dev.type == "cuda"
    out = {}

    # 2. train_lm: uninterrupted, then stopped and resumed
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        base = ["--device", DEVICE, "--steps", str(EX_TRAIN_STEPS),
                "--save-every", str(EX_SAVE_EVERY)]
        whole = train_lm.main(base + ["--ckpt-dir", f"{tmp}/whole"])
        stopped = False
        try:
            train_lm.main(base + ["--ckpt-dir", f"{tmp}/cut",
                                  "--simulate-failure-at", str(EX_FAIL_AT)])
        except SimulatedFailure:
            stopped = True
        resumed = train_lm.main(base + ["--ckpt-dir", f"{tmp}/cut"])
    tail = whole["losses"][-len(resumed["losses"]):]
    differ = sum(a != b for a, b in zip(resumed["losses"], tail))
    print(f"train_lm: {whole['params']} parameters, {EX_TRAIN_STEPS} steps "
          f"at the example's batch and sequence (8 x 128 tokens), loss {whole['losses'][0]:.4f} -> "
          f"{whole['losses'][-1]:.4f}; stopped after {EX_FAIL_AT} "
          f"({stopped}) and resumed from step "
          f"{EX_TRAIN_STEPS - len(resumed['losses'])}: last loss "
          f"{resumed['losses'][-1]!r} (uninterrupted {tail[-1]!r}), "
          f"{differ} of {len(tail)} resumed losses differ in any bit; "
          f"{time.perf_counter() - t0:.1f} s [{smi}]")
    # bit for bit under the card's deterministic algorithms; a CPU
    # rehearsal's reductions round by their operands' alignment
    same = (resumed["losses"][-1] == tail[-1] if card else
            abs(resumed["losses"][-1] - tail[-1]) <= 1e-6 * abs(tail[-1]))
    require(stopped and same and len(resumed["losses"]) < EX_TRAIN_STEPS,
            f"train_lm resume: stopped {stopped}, {resumed['losses'][-3:]} "
            f"vs {tail[-3:]}")
    out["train_lm"] = dict(params=whole["params"], steps=EX_TRAIN_STEPS,
                           first_loss=whole["losses"][0],
                           last_loss=whole["losses"][-1],
                           resumed_steps=len(resumed["losses"]),
                           resumed_losses_differ=differ,
                           seconds=time.perf_counter() - t0)

    # 3. the solver examples, card against CPU
    out["quickstart"], q, cq = _example_twins(
        "quickstart", cpu["quickstart"], (), smi)
    rounds = {where: (r["shooting_rounds_to_tol"],
                      r["shotgun_rounds_to_tol"])
              for where, r in (("card", q), ("cpu", cq))}
    print(f"quickstart: rounds to 0.5% of F* (F* {q['fstar']:.6f} on the "
          f"card, {cq['fstar']:.6f} on the CPU), Shooting / Shotgun: card "
          f"{rounds['card'][0]} / {rounds['card'][1]}, CPU "
          f"{rounds['cpu'][0]} / {rounds['cpu'][1]}")
    require(all(shotgun < shooting for shooting, shotgun in rounds.values()),
            f"quickstart: Shooting / Shotgun rounds to 0.5% of F* {rounds}")
    out["quickstart"].update(
        rho=q["rho"], P=q["P"], shooting_rounds=rounds["card"][0],
        shotgun_rounds=rounds["card"][1], cpu_shooting_rounds=rounds["cpu"][0],
        cpu_shotgun_rounds=rounds["cpu"][1], final_F=q["final_F"],
        fstar=q["fstar"], cpu_fstar=cq["fstar"])
    out["lasso_paths"], lp, _ = _example_twins(
        "lasso_paths", cpu["lasso_paths"], (), smi)
    out["lasso_paths"].update(path_F=lp["path_F"],
                              cold_F=float(lp["cold_F"][-1]))
    out["distributed_shotgun"], ds, cds = _example_twins(
        "distributed_shotgun", cpu["distributed_shotgun"],
        ("fused_shotgun_rounds", "gather_block_matvec",
         "scatter_block_update"), smi)
    gaps = (ds["block_fused_gap"], cds["block_fused_gap"])
    require(max(gaps) <= EX_GAP,
            f"distributed_shotgun: block vs fused {gaps} (card, CPU) > "
            f"{EX_GAP:g}")
    out["distributed_shotgun"].update(
        K=ds["K"], P_local=ds["P_local"], block_fused_gap=ds["block_fused_gap"],
        cpu_block_fused_gap=cds["block_fused_gap"],
        sharded_F=float(ds["sharded_F"][-1]), fused_F=float(ds["fused_F"][-1]),
        scalar_F=float(ds["scalar_F"][-1]))
    return out


def shard_leg_child(args) -> dict:
    """The shard leg, one child process a part of ``SHARD_PARTS``
    (``chip_smoke.py --leg shard --part P``), with cuBLAS's deterministic
    workspace in its environment: the dry-run beside the one-rank part,
    then the four ranks.  Echoes each child's lines, raises (stopping the
    others) if one failed, returns {"shard": {part: its JSON}}."""
    found, t_leg = {}, time.perf_counter()

    def start(part):
        return part, time.perf_counter(), _leg_start(
            "shard", "--part", part, seed=args.seed, deterministic=True)

    # the dry-run (host only) beside the one-rank part (the card); the
    # four ranks, which take every host core, after them
    for group in ((SHARD_PARTS[0], SHARD_PARTS[1]), (SHARD_PARTS[2],)):
        runs = [start(part) for part in group]
        try:
            for part, t0, proc in runs:
                found[part] = _leg_result(f"shard {part}", proc, 900)
                found[part]["wall_s"] = time.perf_counter() - t0
        finally:
            for _, _, proc in runs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    parts = ", ".join(f"{p} {found[p]['wall_s']:.1f} s" for p in SHARD_PARTS)
    print(f"shard leg: {time.perf_counter() - t_leg:.1f} s wall ({parts})")
    return {"shard": found}


def _gib(n) -> str:
    return f"{n / 2**30:.3f} GiB"


def shard_dryrun(args) -> dict:
    """Part a: ``launch.dryrun.measure_cell`` of each of ``SHARD_CELLS``
    on the single mesh (a fake process group of 256 ranks, 16 x 16), its
    tensors fake ones of the card's device type: the three roofline terms
    on the H100's data sheet, the bottleneck and rank 0's memory; each
    cell's status must be "ok" and its argument bytes the count its specs
    give."""
    from repro_torch.launch import dryrun as D
    smi = nvidia_smi_line() if DEVICE == "cuda" else "cpu"
    print(f"dry-run terms on the H100 SXM data sheet: "
          f"{D.PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16, {D.HBM_BW / 1e12:.2f} "
          f"TB/s HBM3, {D.LINK_BW / 1e9:.0f} GB/s of NVLink a direction; "
          f"fake tensors of device type {DEVICE} [{smi}]")
    out = {}
    for arch, shape in SHARD_CELLS:
        t0 = time.perf_counter()
        rec = D.measure_cell(arch, shape, "single", tag="smoke", force=True,
                             device=DEVICE)
        wall = time.perf_counter() - t0
        require(rec["status"] == "ok", f"dry-run {arch} {shape}: "
                f"{rec.get('error')}\n{rec.get('traceback', '')[-3000:]}")
        mem, t = rec["memory"], rec["terms"]
        require(mem["argument_bytes"] == mem["argument_bytes_from_specs"],
                f"dry-run {arch} {shape}: argument bytes "
                f"{mem['argument_bytes']} != the specs' "
                f"{mem['argument_bytes_from_specs']}")
        coll = ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in
                         sorted(rec["collectives"].items()))
        print(f"dry-run {arch} {shape}, 16 x 16 fake ranks: compute "
              f"{t['compute_s']:.4e} s, memory {t['memory_s']:.4e} s, "
              f"collective {t['collective_s']:.4e} s -> {rec['bottleneck']}; "
              f"rank 0: {rec['hlo_flops_per_device']:.4e} FLOP, "
              f"{rec['hlo_bytes_per_device']:.4e} bytes (eager, unfused), "
              f"collectives {coll or 'none'}; memory: arguments "
              f"{_gib(mem['argument_bytes'])} (= the specs' count), outputs "
              f"{_gib(mem['output_bytes'])}, temporaries at peak "
              f"{_gib(mem['temp_bytes'])}; model FLOP a rank "
              f"{rec['model_flops_per_device']:.4e} (useful share "
              f"{rec['useful_flops_ratio']:.4f}); {wall:.1f} s [{smi}]")
        out[f"{arch}/{shape}"] = {
            k: rec[k] for k in ("terms", "bottleneck", "memory",
                                "collectives", "hlo_flops_per_device",
                                "hlo_bytes_per_device", "useful_flops_ratio",
                                "model_flops_per_device", "num_groups")}
        out[f"{arch}/{shape}"]["wall_s"] = wall
    return out


def _full(x):
    """A DTensor's whole value (a plain tensor as it is)."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def _serve_logits(cfg, params, toks, prompt, steps, max_len, dev, slot_pos,
                  cost=None):
    """A ``prompt``-token prefill of ``toks``' rows into ``max_len``
    positions, then ``steps`` per-slot decode steps on the tokens after it
    (slot i at position prompt + t - slot_pos[i]): (the last prefill
    position's logits and each step's, float32 on the CPU; prefill ms;
    decode ms a step, the median of the steps after the first).  A
    ``cost`` (``launch.dryrun.StepCost``) counts the first decode step."""
    from repro_torch.models import model as M
    from repro_torch.models import sharding as SH

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    b = toks.shape[0]
    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        logits, cache = M.forward(cfg, params, {"tokens": toks[:, :prompt]},
                                  make_cache_len=max_len)
        sync()
        pre_ms = (time.perf_counter() - t0) * 1e3
        outs, ms = [_full(logits[:, -1]).float().cpu()], []
        back = torch.tensor(slot_pos, device=dev)[:b, None]
        for t in range(steps):
            pos = prompt + t - back
            tok = toks[:, prompt + t:prompt + t + 1]
            if SH.is_sharded(toks):
                pos = SH.distribute(pos, SH.P(SH.axis("batch", b), None),
                                    toks.device_mesh)
            sync()
            t0 = time.perf_counter()
            with (cost if cost is not None and t == 0
                  else contextlib.nullcontext()):
                lg, cache = M.decode_step(cfg, params, tok, cache, pos)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            outs.append(_full(lg[:, -1]).float().cpu())
    return outs, pre_ms, statistics.median(ms[1:] if len(ms) > 1 else ms)


def _place_leafwise(tree, specs, mesh):
    """``sharding.distribute_tree`` one leaf at a time, each placed leaf
    written over the plain one in its dict or list (so that the plain
    leaf goes at once: a full-width train state does not fit twice on
    the card)."""
    from repro_torch import tree as T
    from repro_torch.models import sharding as SH
    out = []
    paths = [path for path, _ in T.items(tree)]
    for path, sp in zip(paths, T.leaves(specs)):
        leaf = T.get(tree, path)
        placed = SH.distribute(leaf, sp, mesh)
        parent = T.get(tree, path[:-1])
        if isinstance(parent, (dict, list)):
            parent[path[-1]] = placed
        del leaf
        out.append(placed)
    return T.unflatten(tree, out)


def shard_one(args) -> dict:
    """Part b: Qwen3-4B at full width, cut to ``SH1_LAYERS`` of its 36
    layers (the script's time limit; each layer is alike), on one NCCL
    rank, a (1, 1)
    mesh, every parameter, state, batch and cache leaf a DTensor placed
    by the rules, against the same model with plain tensors on the card:
    a ``SH1_PROMPT``-token prefill of ``SH1_SLOTS`` rows into
    ``SH1_MAX_LEN`` positions and ``SH1_DECODE`` per-slot decode steps in
    float32 and in bf16 (logits to ``SH1_F32_TOL`` / ``SH1_BF16_TOL`` of
    their largest), the decode ms a step beside the plain one's; the
    grads of the first batch of ``SH1_TRAIN_ROWS`` x ``SH1_TRAIN_SEQ``
    loader tokens at the config's dtypes (bf16 compute) with deterministic
    algorithms, every leaf to the bf16 tolerance of its largest; then
    ``SH1_TRAIN_STEPS`` train steps (float32 state), the losses and the
    first step's grad norm to the bf16 tolerance (the later norms and the
    parameters reported).  Says whether each is bit for bit."""
    import dataclasses

    from repro_torch import tree as T
    from repro_torch.configs import ARCHS
    from repro_torch.data.loader import LoaderConfig, TokenLoader
    from repro_torch.dist import ranks
    from repro_torch.launch import train as TR
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models import sharding as SH
    from repro_torch.models import steps as TS

    dev = torch.device(DEVICE)
    card = dev.type == "cuda"
    smi = nvidia_smi_line() if card else "cpu"
    base = ARCHS[LM_ARCH].smoke_config() if LM_SMOKE else \
        dataclasses.replace(ARCHS[LM_ARCH].CONFIG, num_layers=SH1_LAYERS)
    pol, out = SH.ShardingPolicy(), {}
    backend = ONE_RANK_BACKEND if card else "gloo"
    with ranks.one_rank(backend):
        mesh = make_mesh((1, 1), ("data", "model"), device=dev)
        toks = torch.randint(0, base.vocab_size,
                             (SH1_SLOTS, SH1_PROMPT + SH1_DECODE),
                             generator=torch.Generator(device=dev)
                             .manual_seed(args.seed), device=dev)
        stagger = [3 * i for i in range(SH1_SLOTS)]
        for tag, dtype, tol in (("f32", torch.float32, SH1_F32_TOL),
                                ("bf16", torch.bfloat16, SH1_BF16_TOL)):
            cfg = dataclasses.replace(base, compute_dtype=dtype,
                                      cache_dtype=dtype)
            params = M.init(cfg, torch.Generator(device=dev).manual_seed(
                args.seed + 1), weight_dtype=dtype)
            kw = dict(prompt=SH1_PROMPT, steps=SH1_DECODE,
                      max_len=SH1_MAX_LEN, dev=dev, slot_pos=stagger)
            plain, pre_p, dec_p = _serve_logits(cfg, params, toks, **kw)
            dp = _place_leafwise(params, SH.param_specs(params, mesh, pol),
                                 mesh)
            del params
            with SH.activation_axes(mesh, pol):
                dtoks = SH.distribute(toks, SH.P("data", None), mesh)
                got, pre_d, dec_d = _serve_logits(cfg, dp, dtoks, **kw)
            del dp
            if card:
                torch.cuda.empty_cache()
            err = max(_rel(g, w) for g, w in zip(got, plain))
            same = all(torch.equal(g, w) for g, w in zip(got, plain))
            require(err <= tol, f"shard one {tag}: logits {err:.3e} > {tol}")
            print(f"{LM_ARCH} serve on one {backend} rank, (1, 1) mesh, "
                  f"{tag}, {base.num_layers} layers, d_model "
                  f"{base.d_model}, {SH1_SLOTS} slots x {SH1_MAX_LEN}: "
                  f"DTensor vs plain logits (prefill's last position and "
                  f"{SH1_DECODE} per-slot decode steps) {err:.3e} of the "
                  f"largest (tolerance {tol}), "
                  f"{'bit for bit' if same else 'not bit for bit'}; prefill "
                  f"of {SH1_PROMPT} tokens {pre_d:.1f} ms (plain "
                  f"{pre_p:.1f}); decode {dec_d:.3f} ms a step (plain "
                  f"{dec_p:.3f}, x{dec_d / dec_p:.2f}) [{smi}]")
            out[f"serve_{tag}"] = dict(rel_err=err, bit_for_bit=same,
                                       prefill_ms=pre_d, prefill_plain_ms=pre_p,
                                       decode_ms=dec_d, decode_plain_ms=dec_p)
        loader = TokenLoader(LoaderConfig(base.vocab_size, SH1_TRAIN_ROWS,
                                          SH1_TRAIN_SEQ, seed=args.seed),
                             device=dev)
        # the first step's grads leaf by leaf (the parameters alone, no
        # optimizer state: both sets of grads fit on the card beside them)
        batch = loader.batch_at(0)
        with TR.deterministic(dev):
            params = M.init(base, torch.Generator(device=dev).manual_seed(
                args.seed + 2))
            loss_p, want = TS.loss_and_grads(base, params, batch)
            dp = _place_leafwise(params, SH.param_specs(params, mesh, pol),
                                 mesh)
            del params
            with SH.activation_axes(mesh, pol):
                loss_d, got = TS.loss_and_grads(base, dp, SH.distribute_tree(
                    batch, SH.batch_specs(batch, mesh, pol), mesh))
            del dp
            grad_err, grad_same = 0.0, torch.equal(_full(loss_d), loss_p)
            for g, w in zip(got, want):
                g = _full(g)
                scale = float(w.abs().max())
                err = float((g - w).abs().max())
                grad_err = max(grad_err, err / scale if scale > 0 else err)
                grad_same = grad_same and torch.equal(g, w)
            del got, want, g, w
        if card:
            torch.cuda.empty_cache()
        require(grad_err <= SH1_BF16_TOL,
                f"shard one grads: {grad_err:.3e} > {SH1_BF16_TOL}")
        print(f"{LM_ARCH} grads on one {backend} rank, DTensor vs plain, "
              f"{SH1_TRAIN_ROWS} x {SH1_TRAIN_SEQ} tokens, "
              f"{str(base.compute_dtype).split('.')[-1]} compute, "
              f"deterministic: every leaf's grad {grad_err:.3e} of its "
              f"largest (tolerance {SH1_BF16_TOL}), loss "
              f"{float(_full(loss_d)):.6f} (plain {float(loss_p):.6f}), "
              f"{'bit for bit' if grad_same else 'not bit for bit'} [{smi}]")
        out["grads"] = dict(rel_err=grad_err, bit_for_bit=grad_same)
        step = TS.make_train_step(base, lr=TRAIN_LR)
        runs = {}
        with TR.deterministic(dev):
            for sharded in (False, True):
                state = TS.init_train_state(base, torch.Generator(
                    device=dev).manual_seed(args.seed + 2))
                if sharded:
                    specs = SH.train_state_specs(
                        state, SH.param_specs(state.params, mesh, pol), mesh)
                    state = _place_leafwise(state, specs, mesh)
                ctx = (SH.activation_axes(mesh, pol) if sharded
                       else contextlib.nullcontext())
                losses, norms, ms = [], [], []
                with ctx:
                    for i in range(SH1_TRAIN_STEPS):
                        batch = loader.batch_at(i)
                        if sharded:
                            batch = SH.distribute_tree(batch, SH.batch_specs(
                                batch, mesh, pol), mesh)
                        t0 = time.perf_counter()
                        state, m = step(state, batch)
                        losses.append(float(_full(m["loss"])))
                        ms.append((time.perf_counter() - t0) * 1e3)
                        norms.append(float(_full(m["grad_norm"])))
                runs[sharded] = dict(losses=losses, norms=norms, ms=ms)
                if not sharded:     # the plain parameters kept on the host
                    plain = [p.to("cpu", copy=True)
                             for p in T.leaves(state.params)]
                else:               # each placed one against them in turn
                    param_err, param_same = 0.0, True
                    for p, w in zip(T.leaves(state.params), plain):
                        p = _full(p).cpu()
                        param_err = max(param_err, _rel(p, w))
                        param_same = param_same and torch.equal(p, w)
                    del plain, p, w
                del state
                if card:
                    torch.cuda.empty_cache()
        a, b = runs[True], runs[False]
        loss_err = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                           b["losses"]))
        norm_errs = [abs(x - y) / abs(y) for x, y in zip(a["norms"],
                                                         b["norms"])]
        norm_err = norm_errs[0]
        same = a["losses"] == b["losses"] and param_same
        # the parameters, and the grad norms after the first step, are
        # reported, not held: where the two runs' rounding differs, Adam
        # divides each grad by statistics of its own size, so an element
        # whose grad is near zero moves by up to lr a step on either side,
        # and the next grads follow
        require(max(loss_err, norm_err) <= SH1_BF16_TOL,
                f"shard one train: loss {loss_err:.3e}, grad norm "
                f"{norm_err:.3e}")
        print(f"{LM_ARCH} train on one {backend} rank, DTensor vs plain, "
              f"{SH1_TRAIN_STEPS} steps of {SH1_TRAIN_ROWS} x "
              f"{SH1_TRAIN_SEQ} tokens, {base.optimizer}, "
              f"{str(base.compute_dtype).split('.')[-1]} compute, "
              f"deterministic: losses {a['losses']} (plain {b['losses']}), "
              f"rel {loss_err:.3e}; grad norms {a['norms']} (plain "
              f"{b['norms']}), rel " + ", ".join(f"{e:.3e}" for e in
                                                 norm_errs) + "; "
              f"parameters after them {param_err:.3e} of each leaf's "
              f"largest (reported); "
              f"{'bit for bit' if same else 'not bit for bit'}; "
              f"step {statistics.median(a['ms'][1:]):.1f} ms (plain "
              f"{statistics.median(b['ms'][1:]):.1f}) [{smi}]")
        out["train"] = dict(losses=a["losses"], plain_losses=b["losses"],
                            loss_rel=loss_err, grad_norm_rel=norm_errs,
                            param_rel=param_err, bit_for_bit=same,
                            step_ms=a["ms"], plain_step_ms=b["ms"])
    out["backend"] = backend
    return out


PROBE_COLLECTIVES = r"""
import sys, torch, torch.distributed as dist
from repro_torch.dist import ranks
r, w, store, *names = sys.argv[1], sys.argv[2], sys.argv[3], *sys.argv[4:]
r, w = int(r), int(w)
ranks.join_group(r, w, store, timeout_s=60)
import torch.distributed._functional_collectives as fc
x = torch.full((8, 4), float(r + 1), device="cuda")
g = dist.group.WORLD
calls = {"all_gather_into_tensor": lambda: fc.all_gather_tensor(x, 0, g),
         "reduce_scatter_tensor": lambda: fc.reduce_scatter_tensor(
             x, "sum", 0, g),
         "all_reduce": lambda: fc.all_reduce(x, "sum", g),
         "all_to_all_single": lambda: fc.all_to_all_single(x, None, None, g),
         "broadcast": lambda: fc.broadcast(x, 0, g)}
for name in names:
    print("try", name, flush=True)
    try:
        y = calls[name]()
        y = y.wait() if hasattr(y, "wait") else y
        torch.cuda.synchronize()
        print("ok", name, float(y.sum()), flush=True)
    except Exception as e:
        print("err", name, type(e).__name__, str(e)[:120].replace("\n", " "),
              flush=True)
    dist.barrier()
"""


def gloo_card_collectives() -> dict:
    """{collective: "ok" or what went wrong} for each functional collective
    DTensor issues (``SH4_COLLECTIVES``), run by four gloo ranks on card
    tensors: one set of child processes for all of them, and a new one for
    those after a collective that killed it."""
    from repro_torch.dist import ranks
    todo, found = list(SH4_COLLECTIVES), {}
    while todo:
        try:
            text = ranks.spawn_code(PROBE_COLLECTIVES, 4, *todo,
                                    timeout_s=120)[0]
        except RuntimeError as e:
            text = str(e)
        tried = None
        for ln in text.splitlines():
            ln = ln.replace("[rank0]:", "").strip()
            word = ln.split(" ", 2)
            if len(word) >= 2 and word[0] in ("try", "ok", "err") and \
                    word[1] in todo:
                if word[0] == "try":
                    tried = word[1]
                else:
                    found[word[1]] = "ok" if word[0] == "ok" else \
                        f"error: {ln[4 + len(word[1]):]}"
                    tried = None
        if tried is not None:
            found[tried] = "kills the process"
        todo = [n for n in todo if n not in found]
        if tried is None and todo:       # the group never started
            for n in todo:
                found[n] = "not run: " + text[-200:]
            todo = []
    return found


def shard_four(args) -> dict:
    """Part c: Granite-MoE-1B at full width, cut to ``SH4_LAYERS`` of its
    24 layers (the script's time limit; each layer is alike), on four gloo
    ranks sharing the card, a (data=2, model=2) mesh: its experts placed by the
    rules (``wo`` over the experts on model, ``wi``/``wg`` over D on
    model), FSDP on data.  Gloo on card tensors is probed first for each
    collective DTensor issues (``gloo_card_collectives``); if one is
    missing the ranks hold CPU tensors, and the output says "cpu".  Rank
    0 first runs the model with plain tensors on the card in float32 and
    bf16 (the ranks serve with the policy's fsdp off, the weights
    replicated over data as a server holds them, the cache's heads on
    model, and train with FSDP on data): a ``SH4_PROMPT``-token prefill
    of ``SH4_SLOTS`` rows and ``SH4_DECODE`` per-slot decode steps, then
    one AdamW step of ``SH4_TRAIN_ROWS`` x ``SH4_TRAIN_SEQ`` tokens; the
    ranks run the same in float32 with DTensors (logits, loss, grad norm
    and every first moment after the step to ``SH4_TOL`` of its largest
    against rank 0's plain run), and time the same serve in bf16 (its
    logits finite, their distance from the plain bf16 run's reported);
    each rank's peak memory, and rank 0's collective bytes of the train
    step and of a decode step.  The card-tensor branch (no collective
    missing) has not run: on PyTorch 2.11 gloo's all-gather on card
    tensors kills the process."""
    card = DEVICE == "cuda"
    smi = nvidia_smi_line() if card else "cpu"
    t0 = time.perf_counter()
    probe = gloo_card_collectives() if card else {}
    missing = sorted(k for k, v in probe.items() if v != "ok")
    where = "cuda" if card and not missing else "cpu"
    if card:
        print("gloo on card tensors, four ranks, the functional "
              "collectives DTensor issues: " + "; ".join(
                  f"{k} {v}" for k, v in probe.items())
              + f"; missing: {', '.join(missing) or 'none'} -> the four "
              f"ranks hold {where} tensors; probe "
              f"{time.perf_counter() - t0:.1f} s [{smi}]")
    from repro_torch.dist import ranks
    conf = dict(seed=args.seed, where=where, card=DEVICE, smoke=LM_SMOKE,
                sizes=[SH4_SLOTS, SH4_PROMPT, SH4_DECODE, SH4_TRAIN_ROWS,
                       SH4_TRAIN_SEQ])
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            "import chip_smoke as C; C._four_rank_main(int(sys.argv[1]), "
            "int(sys.argv[2]), sys.argv[3], sys.argv[4])")
    outs = ranks.spawn_code(code, 4, json.dumps(conf), timeout_s=900)
    res = None
    for ln in outs[0].splitlines():
        if ln.startswith("SHARD4 "):
            res = json.loads(ln[len("SHARD4 "):])
        elif not ln.startswith("[rank") and "Warning" not in ln:
            print(ln)
    require(res is not None, f"shard four: no result\n{outs[0][-3000:]}")
    res.update(backend="gloo", device=where, missing_collectives=missing,
               probe=probe)
    return res


def _peak_gib(dev) -> float:
    if dev.type == "cuda":
        return torch.cuda.max_memory_allocated() / 2**30
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def _four_rank_main(rank, world, store, conf_json):
    """One of part c's four gloo ranks (see ``shard_four``)."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch import tree as T
    from repro_torch.configs import ARCHS
    from repro_torch.data.loader import LoaderConfig, TokenLoader
    from repro_torch.dist import ranks
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models import sharding as SH
    from repro_torch.models import steps as TS
    from repro_torch.optim import adamw

    conf = json.loads(conf_json)
    slots, prompt, steps, rows, seq = conf["sizes"]
    torch.set_num_threads(2)
    where, card = torch.device(conf["where"]), torch.device(conf["card"])
    if where.type == "cuda" or card.type == "cuda":
        torch.cuda.set_device(0)
    ranks.join_group(rank, world, store, timeout_s=900)
    smi = nvidia_smi_line() if card.type == "cuda" else "cpu"
    base = (ARCHS[SH4_ARCH].smoke_config() if conf["smoke"]
            else dataclasses.replace(ARCHS[SH4_ARCH].CONFIG,
                                     num_layers=SH4_LAYERS))
    f32 = dataclasses.replace(base, compute_dtype=torch.float32,
                              cache_dtype=torch.float32)
    # the same weights and tokens on every rank, drawn on the CPU
    params = M.init(f32, torch.Generator().manual_seed(conf["seed"]))
    toks = torch.randint(0, base.vocab_size, (slots, prompt + steps),
                         generator=torch.Generator().manual_seed(
                             conf["seed"] + 1))
    batch = TokenLoader(LoaderConfig(base.vocab_size, rows, seq,
                                     seed=conf["seed"]),
                        device="cpu").batch_at(0)
    stagger = [5 * i for i in range(slots)]
    kw = dict(prompt=prompt, steps=steps, max_len=prompt + steps,
              slot_pos=stagger)
    bf = dataclasses.replace(base, cache_dtype=torch.bfloat16)
    step = TS.make_train_step(f32, lr=TRAIN_LR)
    ref = {}
    if rank == 0:               # the one-rank plain run on the card
        cp = T.map_tree(lambda t: t.to(card, copy=True), params)
        ref["logits"], _, _ = _serve_logits(f32, cp, toks.to(card), dev=card,
                                            **kw)
        ref["bf16"], _, _ = _serve_logits(bf, M.cast_weights(
            cp, torch.bfloat16), toks.to(card), dev=card, **kw)
        st = TS.TrainState(cp, adamw.init(cp), torch.zeros(
            (), dtype=torch.int32, device=card))
        st, m = step(st, {k: v.to(card) for k, v in batch.items()})
        ref.update(loss=float(m["loss"]), gnorm=float(m["grad_norm"]),
                   mu=T.leaves(st.opt.mu))
        del st, cp
    dist.barrier()
    mesh = make_mesh((2, 2), ("data", "model"), device=where)
    pol = SH.ShardingPolicy()
    if where.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params = M.to_device(params, where)
    # served with the weights replicated over data (fsdp off: a server
    # holds them) and the cache's heads on model (where attention takes
    # them); trained with FSDP on data
    serve_pol = SH.ShardingPolicy(fsdp=False, cache_heads_on_tensor=True)
    pol = SH.ShardingPolicy()
    served = SH.distribute_tree(params, SH.param_specs(params, mesh,
                                                       serve_pol), mesh)
    dtoks = SH.distribute(toks.to(where), SH.P("data", None), mesh)
    dec_cost = D.StepCost()
    with SH.activation_axes(mesh, serve_pol):
        got, pre_ms, dec_ms = _serve_logits(f32, served, dtoks, dev=where,
                                            cost=dec_cost, **kw)
        cast = M.cast_weights(served, torch.bfloat16)
        del served
        bf_got, bf_pre, bf_dec = _serve_logits(bf, cast, dtoks, dev=where,
                                               **kw)
        del cast
    bf_finite = all(bool(torch.isfinite(x).all()) for x in bf_got)
    dparams = _place_leafwise(params, SH.param_specs(params, mesh, pol), mesh)
    del params
    zeros = lambda: T.map_tree(torch.zeros_like, dparams)  # noqa: E731
    scalar = lambda: SH.distribute(torch.zeros(  # noqa: E731
        (), dtype=torch.int32, device=where), SH.P(), mesh)
    dstate = TS.TrainState(dparams, adamw.AdamWState(zeros(), zeros(),
                                                     scalar()), scalar())
    del dparams
    dbatch = SH.distribute_tree({k: v.to(where) for k, v in batch.items()},
                                SH.batch_specs(batch, mesh, pol), mesh)
    with SH.activation_axes(mesh, pol):
        cost = D.StepCost()
        t0 = time.perf_counter()
        with cost:
            dstate, m = step(dstate, dbatch)
            loss = float(_full(m["loss"]))
        gnorm = float(_full(m["grad_norm"]))
        train_ms = (time.perf_counter() - t0) * 1e3
    # the first moments after one step are a tenth of the clipped grads;
    # the parameters are not compared: the first step divides each grad by
    # statistics of its own size, so an element whose grad is near zero
    # moves by up to lr on either side
    errs, bf_err = {"logits": 0.0, "mu": 0.0}, 0.0
    if rank == 0:
        errs["logits"] = max(_rel(g, w) for g, w in zip(got, ref["logits"]))
        bf_err = max(_rel(g, w) for g, w in zip(bf_got, ref["bf16"]))
    for i, x in enumerate(T.leaves(dstate.opt.mu)):
        whole = _full(x)
        if rank == 0:
            errs["mu"] = max(errs["mu"], _rel(whole, ref["mu"][i]))
        del whole
    peaks = [None] * world
    dist.all_gather_object(peaks, _peak_gib(where))
    if rank == 0:
        ok = (max(errs.values()) <= SH4_TOL
              and abs(loss - ref["loss"]) <= SH4_TOL * abs(ref["loss"])
              and abs(gnorm - ref["gnorm"]) <= SH4_TOL * ref["gnorm"]
              and bf_finite)
        kind = "GiB of card memory" if where.type == "cuda" else \
            "GiB host RSS"
        coll = {k: v for k, v in sorted(cost.coll.items())}
        dcoll = {k: v for k, v in sorted(dec_cost.coll.items())}
        gb = lambda c: ", ".join(  # noqa: E731
            f"{k} {v / 1e9:.4f} GB" for k, v in c.items()) or "none"
        print(f"{SH4_ARCH} on four gloo ranks sharing the card, (data=2, "
              f"model=2) mesh, {where} tensors, {base.num_layers} layers, "
              f"d_model {base.d_model}, {base.num_experts} experts placed "
              f"by the rules: "
              f"float32 against the one-rank plain run on the "
              f"{card.type}: logits (prefill's last position and "
              f"{steps} per-slot decode steps at {slots} slots) "
              f"{errs['logits']:.3e}, one AdamW step of {rows} x {seq} "
              f"tokens: loss {loss:.6f} (plain {ref['loss']:.6f}), grad "
              f"norm {gnorm:.6f} (plain {ref['gnorm']:.6f}), first moments "
              f"{errs['mu']:.3e} of each leaf's largest (tolerance "
              f"{SH4_TOL}); served with fsdp off and the cache's heads on "
              f"model, trained with FSDP on data [{smi}]")
        host = ("the card" if where.type == "cuda" else
                "the host's CPU, 2 threads a rank")
        print(f"{SH4_ARCH} four ranks, times on {where} tensors ({host}): "
              f"prefill of "
              f"{prompt} tokens at {slots} slots, float32 {pre_ms:.1f} ms, "
              f"bf16 {bf_pre:.1f} ms; decode a step (the median of "
              f"{steps - 1} after the first), float32 {dec_ms:.2f} ms, bf16 "
              f"{bf_dec:.2f} ms (bf16 logits finite, {bf_err:.3e} of the "
              f"largest from the card's plain bf16 run: reported, not held, "
              f"as bf16 expert picks can flip); train step {train_ms:.1f} "
              f"ms (its "
              f"collectives counted); peak per rank "
              + ", ".join(f"{p:.2f}" for p in peaks) + f" {kind}; "
              f"collective result bytes on rank 0: train step {gb(coll)}; "
              f"decode step {gb(dcoll)} [{smi}]")
        require(ok, f"shard four: errors {errs}, loss {loss} vs "
                f"{ref['loss']}, grad norm {gnorm} vs {ref['gnorm']}, bf16 "
                f"logits finite {bf_finite}")
        print("SHARD4 " + json.dumps(dict(
            rel_err=errs, loss=loss,
            plain_loss=ref["loss"], grad_norm=gnorm,
            plain_grad_norm=ref["gnorm"], prefill_ms=pre_ms,
            decode_ms=dec_ms, train_ms=train_ms, bf16_prefill_ms=bf_pre,
            bf16_decode_ms=bf_dec, bf16_rel_err=bf_err, peak_gib=peaks,
            peak_kind=kind, collective_bytes=coll,
            decode_collective_bytes=dcoll)), flush=True)
    dist.barrier()


SHARD_PART = {"dryrun": shard_dryrun, "one": shard_one, "four": shard_four}


if __name__ == "__main__":
    sys.exit(main())
