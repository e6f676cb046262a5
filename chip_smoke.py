#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the CUDA kernels from the sources in this checkout, holds each kernel
against its plain PyTorch version at the paper's widths, then drives the
port's main path — ``block_shotgun_solve`` — on a Sparco-style dense Lasso
(n = 16384, d = 32768, fused and two-kernel rounds, f32 and bf16 A) and a
zeta-shaped sparse logistic regression with per-block Newton and the
divergence guard (n = 500,000, d = 2000).  Data are drawn on the card from
``--seed``.  Any failed check raises, so the script exits non-zero; it also
exits non-zero, printing no result, without a CUDA device or without the
rest of the repository.

Output: informative lines, then a ``{"kernels": [...]}`` JSON line, the
card's name and power limit as nvidia-smi reports them, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import json
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
    from repro_torch.core import health
    from repro_torch.core import objectives as obj
    from repro_torch.core.health import GuardConfig
    from repro_torch.core.spec import SolverSpec
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops
    from repro_torch.kernels import shotgun_block as sb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"device: {kind}; count {torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"nvidia-smi: {smi}")

    # ---- build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s wall "
          f"(nvcc {_build.build_info['seconds']:.1f} s)")
    for line in _build.build_info["ptxas"].splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")
    for a16 in (0, 1):
        for code, name in enumerate(("lasso", "logistic", "lasso_newton",
                                     "logistic_newton")):
            blocks = lib.sb_fused_grid_blocks(a16, code)
            require(blocks > 0, f"cooperative grid for {name}: {blocks}")
            print(f"fused grid: A {'bf16' if a16 else 'f32'} {name}: "
                  f"{blocks} blocks x 256 threads")

    # ---- data on the card -------------------------------------------------
    t0 = time.perf_counter()
    A, y, _ = syn.sparco_on_device(args.seed, n=LASSO_N, d=LASSO_D)
    lasso = obj.make_problem(A, y, 1.0, device=dev)
    del A
    lasso = lasso._replace(lam=0.1 * obj.lambda_max(lasso.A, lasso.y,
                                                     "lasso"))
    A, y, _ = syn.logistic_data_on_device(args.seed + 1, n=ZETA_N, d=ZETA_D)
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
    worst = {k: [0.0, 0.0] for k in ("gather_block_matvec",
                                      "scatter_block_update",
                                      "fused_shotgun_rounds")}

    def check(name, tag, pairs, nnz_pair=None, health_pair=None):
        for what, got, want, floor in pairs:
            err, rel = rel_err(got, want, floor)
            worst[name] = [max(worst[name][0], err), max(worst[name][1], rel)]
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
            require(torch.equal(sb.gather_block_matvec(AA, r, idx),
                                sb.gather_block_matvec(AA, r, idx)),
                    f"gather repeat not bit-identical [{t}]")
            require(torch.equal(sb.scatter_block_update(AA, r, idx, dl),
                                sb.scatter_block_update(AA, r, idx, dl)),
                    f"scatter repeat not bit-identical [{t}]")

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
                again = sb.fused_shotgun_rounds(*fargs, loss=loss, k_eff=k_eff)
                require(all(torch.equal(u, v) for u, v in zip(got, again)),
                        f"fused repeat not bit-identical [{t}]")
                print(f"check fused_shotgun_rounds [{t}] repeat bit-identical")

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
    for tag, tt in (("lasso f32 n=16384 d=32768 K=8 R=8", t_lasso),
                    ("zeta f32 n=500224 d=2048 K=2 R=8 logistic_newton",
                     t_zeta)):
        for name, v in tt.items():
            b, by = v["bound"]
            print(f"time {name} [{tag}]: {v['ms']:.4f} ms; plain "
                  f"{v['plain_ms']:.4f} ms; bound {b:.4f} ms ({by}); "
                  f"{100 * b / v['ms']:.1f}% of bound")

    # ---- the main path ----------------------------------------------------
    sb.reset_launches()
    runs = []

    def solve(label, prob, spec, **kw):
        before = dict(sb.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ops.block_shotgun_solve(prob, spec=spec, **kw)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = {k: sb.LAUNCHES[k] - before[k] for k in before}
        f = res.trace.objective.cpu()
        nnz = res.trace.nnz.cpu()
        status = int(res.status)
        K = max(1, -(-spec.P // sb.BLOCK))
        ab = prob.A.element_size()
        n_pad = prob.n + (-prob.n) % sb.TILE_N
        gbs = spec.rounds * K * n_pad * sb.BLOCK * ab / sec / 1e9
        print(f"solve {label}: {spec.rounds} rounds in {sec * 1e3:.2f} ms "
              f"({sec / spec.rounds * 1e3:.4f} ms/round, "
              f"{spec.rounds / sec:.1f} rounds/s, {gbs:.1f} GB/s of A_B "
              f"streamed once per round); status "
              f"{health.STATUS_NAMES[status]}; launches {launches}")
        marks = sorted({0, 1, R - 1, len(f) // 2, len(f) - 1})
        print(f"trace {label}: " + ", ".join(
            f"F[{i}]={float(f[i]):.7g} nnz={int(nnz[i])}" for i in marks))
        require(bool(torch.all(torch.isfinite(f))), f"{label}: non-finite F")
        require(float(f[-1]) < float(f[0]), f"{label}: F did not decrease")
        require(status == health.STATUS_OK, f"{label}: status {status}")
        require(res.x.shape == (prob.d,) and res.z.shape == (prob.n,),
                f"{label}: result shapes {res.x.shape} {res.z.shape}")
        if spec.fused:
            require(launches["fused_shotgun_rounds"] == spec.rounds // R,
                    f"{label}: {launches} != rounds/R = {spec.rounds // R}")
        else:
            require(launches["gather_block_matvec"] == spec.rounds
                    and launches["scatter_block_update"] == spec.rounds,
                    f"{label}: {launches} != {spec.rounds} rounds")
        runs.append(dict(label=label, ms_per_round=sec / spec.rounds * 1e3,
                         rounds_per_s=spec.rounds / sec, gb_per_s=gbs,
                         status=health.STATUS_NAMES[status]))
        return res

    lasso_idx = draws(256, 8, LASSO_D // sb.BLOCK, g, dup=False)
    spec = SolverSpec(loss="lasso", P=1024, rounds=256, fused=True)
    fused = solve("lasso fused f32", lasso, spec, blk_idx=lasso_idx)
    two = solve("lasso two-kernel f32", lasso,
                SolverSpec(loss="lasso", P=1024, rounds=32),
                blk_idx=lasso_idx[:32])
    solve("lasso fused bf16", lasso._replace(A=lasso.A.to(torch.bfloat16)),
          spec, blk_idx=lasso_idx)
    solve("zeta logistic newton guarded fused f32", zeta,
          SolverSpec(loss="logistic", P=256, rounds=64, fused=True,
                     newton=True, guard=GuardConfig()),
          generator=torch.Generator(device=dev).manual_seed(args.seed + 3))
    counts = dict(sb.LAUNCHES)
    print(f"main path launches: {counts}")
    require(all(v > 0 for v in counts.values()),
            f"a kernel of the main path never launched: {counts}")

    # Fused and two-kernel rounds on the same draws follow one trajectory.
    f_fused = fused.trace.objective[:32].double()
    f_two = two.trace.objective.double()
    rel = float(((f_fused - f_two).abs() / f_two.abs()).max())
    print(f"check fused vs two-kernel F trace (32 rounds, same draws): "
          f"max rel {rel:.3e}")
    require(rel <= TRACE_RTOL, f"fused vs two-kernel trace rel {rel:.3e}")

    # Device busy share over a fused solve (profiler; outside the counts).
    for label, prob, spec_, kw in (
            ("lasso fused f32", lasso, spec, dict(blk_idx=lasso_idx)),
            ("zeta logistic newton guarded fused f32", zeta,
             SolverSpec(loss="logistic", P=256, rounds=64, fused=True,
                        newton=True, guard=GuardConfig()),
             dict(generator=torch.Generator(device=dev).manual_seed(1)))):
        busy, span, n_ev = device_busy(
            lambda: ops.block_shotgun_solve(prob, spec=spec_, **kw))
        if n_ev:
            print(f"profile {label}: device busy {busy:.3f} ms of a "
                  f"{span:.3f} ms span ({n_ev} device events); idle share "
                  f"{1 - busy / span:.3f}")
        else:
            print(f"profile {label}: not measured (the profiler saw no "
                  "device activity)")

    # A small problem solved on the card and by the plain versions on the CPU.
    A, y, _ = syn.sparco(seed=args.seed, n=1000, d=700)
    small_spec = SolverSpec(loss="lasso", P=256, rounds=16, fused=True)
    small_idx = draws(16, 2, 6, g, dup=False).cpu()
    on_card = ops.block_shotgun_solve(obj.make_problem(A, y, 5.0, device=dev),
                                      spec=small_spec, blk_idx=small_idx)
    on_cpu = ops.block_shotgun_solve(obj.make_problem(A, y, 5.0, device="cpu"),
                                     spec=small_spec, blk_idx=small_idx)
    rel = float(((on_card.trace.objective.cpu().double()
                  - on_cpu.trace.objective.double()).abs()
                 / on_cpu.trace.objective.double().abs()).max())
    print(f"check small solve card vs CPU plain: F trace max rel {rel:.3e}")
    require(rel <= TRACE_RTOL, f"small solve card vs CPU rel {rel:.3e}")

    # ---- report -----------------------------------------------------------
    sources = {
        "fused_shotgun_rounds": "src/repro/kernels/shotgun_block.py:535",
        "gather_block_matvec": "src/repro/kernels/shotgun_block.py:81",
        "scatter_block_update": "src/repro/kernels/shotgun_block.py:127",
    }
    kernels = []
    for name in ("fused_shotgun_rounds", "gather_block_matvec",
                 "scatter_block_update"):
        v = t_lasso[name]
        b, by = v["bound"]
        kernels.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/shotgun_block.cu",
            replaces=sources[name], launches=counts[name],
            max_abs_err=worst[name][0], max_rel_err=worst[name][1],
            ms=v["ms"], plain_ms=v["plain_ms"],
            bound_ms=b, bound_by=by, library_ms=None,
            shape="lasso f32 n=16384 d=32768 K=8" + (" R=8" if "fused" in name
                                                      else "")))
    print(json.dumps({"zeta_kernel_times": {
        k: dict(ms=v["ms"], plain_ms=v["plain_ms"], bound_ms=v["bound"][0],
                bound_by=v["bound"][1]) for k, v in t_zeta.items()},
        "solves": runs}))
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
