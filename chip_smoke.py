#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the CUDA kernels from the sources in this checkout, holds each kernel
against its plain PyTorch version at the paper's widths, then drives the
port's main path — ``block_shotgun_solve`` — on two legs:

  dense   a Sparco-style Lasso (n = 16384, d = 32768, fused and two-kernel
          rounds, f32 and bf16 A) and a zeta-shaped logistic regression
          with per-block Newton and the divergence guard (n = 500,000,
          d = 2000);
  sparse  BlockedCSC problems at the shapes of LIBSVM's news20.binary
          (S1: Lasso, n = 19,996, d = 1,355,191, density 3.36e-4; fused and
          two-kernel rounds, f32 and bf16 values) and rcv1.binary (S2:
          logistic with per-block Newton and the guard, n = 20,242,
          d = 47,236, density 0.16%), never densified;
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
          the same draws and an S1 solve profiled for host syncs; then the
          warm-started λ-path on S1 (``block_fused``, kernel #2) and on
          the dense Lasso.

The two-kernel pair #3/#4 is timed on three clocks (events, the
profiler's counted records, events behind a spin) beside cuBLAS on a
contiguous copy of the drawn blocks and on their strided views.

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
import datetime
import json
import math
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
# Runtime calls and operators that make the host wait on the card, or copy
# from it: none may fall inside an unguarded scalar solve's rounds.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "aten::item",
              "aten::_local_scalar_dense")


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
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.005)      # no device record at the window's edges
        fn()
        torch.cuda.synchronize()
        time.sleep(0.005)
    # a ``record_function`` range shows on the device timeline too, as an
    # annotation spanning everything inside it: not device activity
    events = [e for e in prof.events()
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
    a, b = a.cpu().double(), b.cpu().double()
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
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run "
              "from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
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

    dense_kernels, dense_json, dense_data = dense_leg(args)
    sparse_kernels, sparse_json, sparse_data = sparse_leg(args)
    sharded_kernels, sharded_json = sharded_leg(args, dense_data, sparse_data,
                                                dense_json, sparse_json)
    serve_kernels, serve_json = serve_leg(args, dense_data, sparse_data)
    scalar_json = scalar_leg(args, dense_data, sparse_data)

    # ---- report -----------------------------------------------------------
    print(json.dumps({**dense_json, **sparse_json, **sharded_json,
                      **serve_json, **scalar_json}))
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(json.dumps({"kernels": dense_kernels + sparse_kernels
                      + sharded_kernels + serve_kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


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
    from repro_torch.kernels import ops
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
        # every device op of a call, its records counted; the same calls
        # queued behind a spin; the yardsticks on the profiler's clock
        for name, fn, lib, strided in (
                ("gather_block_matvec", gather, lib_mv, strided_mv),
                ("scatter_block_update", scatter, lib_addmv,
                 strided_addmv)):
            t = out[name]
            t["device_ms"] = device_ms(fn, None, PAIR_ITERS)
            t["queued_ms"] = queued_ms(fn, PAIR_ITERS)
            t["library_device_ms"] = device_ms(lib, None, PAIR_ITERS)
            t["strided_ms"] = time_ms(strided, iters)
            t["strided_device_ms"] = device_ms(strided, None, iters)
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
        ("gather_partial_kernel", "gather_reduce_kernel", "scatter_kernel"))
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
          f"records of {3 * two_spec.rounds} launches); device busy "
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
    data = dict(lasso=lasso, zeta=zeta, La=La, Ly=Ly, Lm=Lm, Za=Za, Zy=Zy,
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


def sparse_phases(launch, ms: float | None, R: int, dev,
                  reps: int = 5) -> dict:
    """Phase breakdown of a fused sparse launch: ``launch(stamps)`` runs it
    with the grid's last block's SM clock stamped at each barrier (two a
    round: A, then BC) and the card's ns timer at launch start and end.  Of
    ``reps`` stamped launches the one of median ns span is broken down, its
    cycles turned into ms by its own ns per cycle, so the phases need no
    other clock.  ``ms`` (the profiler's device time per launch, or None)
    is set beside the stamped span, and the SM clock the stamps imply
    beside the card's maximum: three clocks that must agree."""
    runs = []
    for _ in range(reps):
        stamps = torch.zeros(2 * R + 6, dtype=torch.int64, device=dev)
        launch(stamps)
        torch.cuda.synchronize()
        runs.append(stamps.cpu())
    runs.sort(key=lambda t: int(t[-1] - t[-2]))
    spans = [float(t[-1] - t[-2]) / 1e6 for t in runs]
    st = runs[reps // 2].double()
    clk = st[:2 * R + 4]
    cyc = clk[1:] - clk[:-1]
    span = spans[reps // 2]
    per_cycle = span / float(clk[-1] - clk[0])
    rounds = cyc[1:1 + 2 * R].reshape(R, 2)
    return {
        "profiler_ms": ms, "stamped_ms": span, "stamped_ms_min": spans[0],
        "stamped_ms_max": spans[-1], "launch_cycles": float(clk[-1] - clk[0]),
        "sm_ghz": 1e-6 / per_cycle, "sm_ghz_max": sm_clock_max_ghz(),
        "launch_start_ms": float(cyc[0]) * per_cycle,
        "round_ms": float(rounds.sum(1).mean()) * per_cycle,
        "A_gather_delta_xpartial_ms": float(rounds[:, 0].mean()) * per_cycle,
        "BC_rowrange_sums_xupdate_finish_ms":
            float(rounds[:, 1].mean()) * per_cycle,
        "final_A_xpartial_only_ms": float(cyc[1 + 2 * R]) * per_cycle,
        "final_finish_only_ms": float(cyc[2 + 2 * R]) * per_cycle}


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
    """Profile ``fn``: the names of the ``SYNC_CALLS`` events inside the
    profiler range ``range_name``, how many such ranges there were, and
    the device-to-host copies anywhere in the window."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    ranges = [e.time_range for e in events
              if e.name == range_name and e.device_type == cpu]
    inside = [e.name for e in events
              if e.device_type == cpu and e.name in SYNC_CALLS
              and any(r.start <= e.time_range.start <= r.end
                      for r in ranges)]
    dtoh = sum(1 for e in events
               if e.device_type != cpu and "DtoH" in e.name)
    return inside, len(ranges), dtoh


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
    a = solve(f"dense lasso shotgun P={pd}", run_d, SC_DENSE_ROUNDS)
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
                           pstar_dense=pd, wall_s=wall)}


if __name__ == "__main__":
    sys.exit(main())
