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
          d = 47,236, density 0.16%), never densified.

Data are drawn on the card from ``--seed``.  Any failed check raises, so the script exits non-zero; it also
exits non-zero, printing no result, without a CUDA device or without the
rest of the repository.

Output: informative lines, then a ``{"kernels": [...]}`` JSON line, the
card's name and power limit as nvidia-smi reports them, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys
import time

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


def device_busy(fn) -> tuple[float, float, int]:
    """Run ``fn`` under torch.profiler; return (device busy ms, span ms from
    the first device activity to the last, device events).  Busy is the
    union of the device intervals, so idle share = 1 - busy / span."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
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
    return busy / 1e3, span / 1e3, len(spans)


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


def device_ms(fn, kernels: tuple[str, ...], iters: int) -> float | None:
    """Device time per call of ``fn`` from the profiler: the summed
    duration of the device events whose names contain one of ``kernels``,
    over ``iters`` calls (after a warm-up); None when the profiler sees no
    such event.  For a kernel of a few microseconds the CUDA-event time of
    back-to-back calls is set by the host enqueue, not by the device."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.time_range.end - e.time_range.start for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and any(k in e.name for k in kernels))
    return total / iters / 1e3 if total else None


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
    for prefix, grid_fn in (("fused", lib.sb_fused_grid_blocks),
                            ("fused sparse", lib.sp_fused_grid_blocks)):
        for a16 in (0, 1):
            for code, name in enumerate(("lasso", "logistic", "lasso_newton",
                                         "logistic_newton")):
                blocks = grid_fn(a16, code)
                require(blocks > 0, f"{prefix} cooperative grid for {name}: "
                        f"{blocks}")
                print(f"{prefix} grid: {'bf16' if a16 else 'f32'} {name}: "
                      f"{blocks} blocks x 256 threads")

    dense_kernels, dense_json = dense_leg(args)
    sparse_kernels, sparse_json = sparse_leg(args)

    # ---- report -----------------------------------------------------------
    print(json.dumps({**dense_json, **sparse_json}))
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(json.dumps({"kernels": dense_kernels + sparse_kernels}))
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
                library_ms=t.get("library_ms"), shape=shape)


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
        out["fused_shotgun_rounds"] = dict(
            ms=time_ms(lambda: sb.fused_shotgun_rounds(*fargs, loss=loss), iters),
            plain_ms=time_ms(lambda: sb.fused_shotgun_rounds_plain(
                *fargs, loss=loss), max(2, iters // 4), warmup=1),
            bound=bound(R * blk_bytes + 4 * (4 * n + 2 * d) + 8 * R,
                        R * (4 + 3 * newton) * K * n * sb.BLOCK))
        out["gather_block_matvec"] = dict(
            ms=time_ms(lambda: sb.gather_block_matvec(A, r, idx[0]), iters),
            plain_ms=time_ms(lambda: sb.gather_block_matvec_plain(
                A, r, idx[0]), iters),
            bound=bound(blk_bytes + 4 * n + 4 * K + 4 * K * sb.BLOCK,
                        2 * K * n * sb.BLOCK))
        out["scatter_block_update"] = dict(
            ms=time_ms(lambda: sb.scatter_block_update(A, z0, idx[0], dl),
                       iters),
            plain_ms=time_ms(lambda: sb.scatter_block_update_plain(
                A, z0, idx[0], dl), iters),
            bound=bound(blk_bytes + 8 * n + 4 * K + 4 * K * sb.BLOCK,
                        2 * K * n * sb.BLOCK))
        return out

    t_lasso = kernel_times(La, Ly, Lm, lasso, 8, "lasso", 20)
    t_zeta = kernel_times(Za, Zy, Zm, zeta, 2, "logistic_newton", 10)
    lasso_shape = f"lasso f32 n={La.shape[0]} d={La.shape[1]} K=8"
    print_times(((lasso_shape + f" R={R}", t_lasso),
                 (f"zeta f32 n={Za.shape[0]} d={Za.shape[1]} K=2 R={R} "
                  "logistic_newton", t_zeta)))

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
    counts = dict(sb.LAUNCHES)
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
        k: dict(ms=v["ms"], plain_ms=v["plain_ms"], bound_ms=v["bound"][0],
                bound_by=v["bound"][1]) for k, v in t_zeta.items()},
        "dense_solves": runs}
    return kernels, extra


def print_times(groups):
    for tag, tt in groups:
        for name, v in tt.items():
            b, by = v["bound"]
            lib = v.get("library_ms")
            dms = v.get("device_ms")
            print(f"time {name} [{tag}]: {v['ms']:.4f} ms; plain "
                  f"{v['plain_ms']:.4f} ms; bound {b:.4f} ms ({by}); "
                  f"{100 * b / v['ms']:.1f}% of bound"
                  + ("" if dms is None else
                     f"; device {dms:.4f} ms ({100 * b / dms:.1f}% of bound)")
                  + ("" if lib is None else f"; library {lib:.4f} ms"))


def print_busy(label, fn):
    busy, span, n_ev = device_busy(fn)
    if n_ev:
        print(f"profile {label}: device busy {busy:.3f} ms of a "
              f"{span:.3f} ms span ({n_ev} device events); idle share "
              f"{1 - busy / span:.3f}")
    else:
        print(f"profile {label}: not measured (the profiler saw no device "
              "activity)")


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
    K_of = {}
    for tag, prob, want_K in (("S1", s1, S1_P // B), ("S2", s2, S2_K)):
        A = prob.A
        t0 = time.perf_counter()
        rho = float(spectral.spectral_radius(
            A, torch.Generator(device=dev).manual_seed(args.seed + 12)))
        pstar = int(math.ceil(A.d / max(rho, 1.0) - 0.01))
        K = want_K
        if tag == "S1" and K * B >= pstar:
            K = max(1, (pstar - 1) // B)             # largest K under P*
        K_of[tag] = K
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
    K1, K2 = K_of["S1"], K_of["S2"]

    # ---- each kernel against its plain version at S1 and S2 ---------------
    for tag, probs, K, losses in (
            ("S1", (("f32", s1), ("bf16", s1_16)), K1, ("lasso",)),
            ("S2", (("f32", s2), ("bf16", s2_16)), K2,
             ("logistic", "logistic_newton"))):
        for store, prob in probs:
            A = prob.A
            od = A.scatter_order()
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
                                                    dl, order=od),
                ss.sparse_scatter_block_update_plain(A.rows, A.vals, r, idx,
                                                     dl), 0.0)])
            require_repeat(lambda: ss.sparse_gather_block_matvec(
                A.rows, A.vals, r, idx), f"sparse_gather_block_matvec [{t}]")
            require_repeat(lambda: ss.sparse_scatter_block_update(
                A.rows, A.vals, r, idx, dl, order=od),
                f"sparse_scatter_block_update [{t}]")
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
                        *fargs, loss=loss, k_eff=k_eff, order=od)
                    want = ss.fused_sparse_shotgun_rounds_plain(
                        *fargs, loss=loss, k_eff=k_eff)
                    check("fused_sparse_shotgun_rounds", t,
                          [("x", got[0], want[0], 1.0),
                           ("z", got[1], want[1], 0.0),
                           ("f", got[2], want[2], 0.0)],
                          nnz_pair=(got[3], want[3]),
                          health_pair=(got[4], want[4]))
                    require_repeat(lambda: ss.fused_sparse_shotgun_rounds(
                        *fargs, loss=loss, k_eff=k_eff, order=od),
                        f"fused_sparse_shotgun_rounds [{t}]")

    # ---- kernel times and the fused launch's phases -----------------------
    def kernel_times(prob, K, loss, iters):
        A = prob.A
        n, d_pad, tile = A.n, A.d_pad, A.tile
        vb = A.vals.element_size()
        od = A.scatter_order()
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
                *fargs, loss=loss, order=od), iters),
            plain_ms=time_ms(lambda: ss.fused_sparse_shotgun_rounds_plain(
                *fargs, loss=loss), max(2, iters // 4), warmup=1),
            bound=bound(R * tiles + 4 * (3 * n + 2 * d_pad) + 8 * R,
                        R * ((4 + 3 * newton) * slots + (K + 10) * n
                             + 2 * d_pad)))
        out["sparse_gather_block_matvec"] = dict(
            ms=time_ms(lambda: ss.sparse_gather_block_matvec(
                A.rows, A.vals, r, idx[0]), iters),
            plain_ms=time_ms(lambda: ss.sparse_gather_block_matvec_plain(
                A.rows, A.vals, r, idx[0]), iters),
            library_ms=time_ms(lambda: torch.mv(at_csr, r), iters),
            bound=bound(tiles + 4 * n + 512 * K, 2 * slots))
        out["sparse_scatter_block_update"] = dict(
            ms=time_ms(lambda: ss.sparse_scatter_block_update(
                A.rows, A.vals, z0, idx[0], dl, order=od), iters),
            plain_ms=time_ms(lambda: ss.sparse_scatter_block_update_plain(
                A.rows, A.vals, z0, idx[0], dl), iters),
            library_ms=time_ms(lambda: torch.addmv(z0, a_csr, dl.reshape(-1)),
                               iters),
            bound=bound(tiles + 8 * n + 512 * K, 2 * slots + K * n))
        calls = {
            "fused_sparse_shotgun_rounds": (
                ("fused_sparse_kernel",),
                lambda: ss.fused_sparse_shotgun_rounds(*fargs, loss=loss,
                                                       order=od)),
            "sparse_gather_block_matvec": (
                ("sparse_gather_kernel",),
                lambda: ss.sparse_gather_block_matvec(A.rows, A.vals, r,
                                                      idx[0])),
            "sparse_scatter_block_update": (
                ("scatter_runs_kernel", "combine_kernel"),
                lambda: ss.sparse_scatter_block_update(
                    A.rows, A.vals, z0, idx[0], dl, order=od))}
        for name, (kern, fn) in calls.items():
            out[name]["device_ms"] = device_ms(fn, kern, iters)
        # Phase breakdown of one launch: block 0's clock at each barrier,
        # scaled to the kernel's device time per launch.
        stamps = torch.zeros(3 * R + 4, dtype=torch.int64, device=dev)
        ss.fused_sparse_shotgun_rounds(*fargs, loss=loss, order=od,
                                       stamps=stamps)
        torch.cuda.synchronize()
        st = stamps.cpu().double()
        cyc = st[1:] - st[:-1]
        ms = out["fused_sparse_shotgun_rounds"]["device_ms"] or (
            out["fused_sparse_shotgun_rounds"]["ms"])
        per_cycle = ms / float(st[-1] - st[0])
        rounds = cyc[1:1 + 3 * R].reshape(R, 3)
        out["phases"] = {
            "launch_ms": ms, "launch_cycles": float(st[-1] - st[0]),
            "launch_start_ms": float(cyc[0]) * per_cycle,
            "round_ms": float(rounds.sum(1).mean()) * per_cycle,
            "A_gather_delta_xpartial_ms": float(rounds[:, 0].mean()) * per_cycle,
            "B_runs_finish_ms": float(rounds[:, 1].mean()) * per_cycle,
            "C_combine_xupdate_ms": float(rounds[:, 2].mean()) * per_cycle,
            "final_A_xpartial_only_ms": float(cyc[1 + 3 * R]) * per_cycle,
            "final_B_finish_only_ms": float(cyc[2 + 3 * R]) * per_cycle}
        return out

    t_s1 = kernel_times(s1, K1, "lasso", 20)
    t_s2 = kernel_times(s2, K2, "logistic_newton", 20)
    ph = {"S1": t_s1.pop("phases"), "S2": t_s2.pop("phases")}
    print_times(((f"S1 lasso f32 K={K1} R={R}", t_s1),
                 (f"S2 f32 K={K2} R={R} logistic_newton", t_s2)))
    for tag, p in ph.items():
        print(f"phases fused_sparse_shotgun_rounds [{tag}]: " + "; ".join(
            f"{k} {v:.4f}" for k, v in p.items()))

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
    counts = dict(ss.LAUNCHES)
    print(f"main path launches (sparse leg): {counts}")
    require(all(v > 0 for v in counts.values()),
            f"a kernel of the sparse leg never launched: {counts}")

    rel = trace_rel(fused.trace.objective[:S1_TWO_ROUNDS],
                    two.trace.objective)
    print(f"check sparse fused vs two-kernel F trace ({S1_TWO_ROUNDS} rounds, "
          f"same draws): max rel {rel:.3e}")
    require(rel <= TRACE_RTOL, f"sparse fused vs two-kernel rel {rel:.3e}")

    for label, prob, spec_, kw in (
            ("S1 lasso fused f32", s1, s1_spec, dict(blk_idx=s1_idx)),
            ("S2 logistic newton guarded fused f32", s2, s2_spec,
             dict(generator=torch.Generator(device=dev).manual_seed(1)))):
        print_busy(label, lambda: ops.block_shotgun_solve(prob, spec=spec_,
                                                          **kw))

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
                bound_ms=v["bound"][0], bound_by=v["bound"][1],
                library_ms=v.get("library_ms"))
        for k, v in t_s2.items()},
        "s1_device_ms": {k: v["device_ms"] for k, v in t_s1.items()},
        "sparse_phases": ph, "sparse_solves": runs}
    return kernels, extra


if __name__ == "__main__":
    sys.exit(main())
