"""Hold the dense two-kernel pair (``gather_block_matvec``,
``scatter_block_update``) against an earlier copy of ``csrc/`` on the card:
the scatter bit for bit, the gather to a tolerance, both repeated, the
gather on two streams at once, and both timed in turns (old, new, new,
old) on three clocks beside cuBLAS on a copy of the drawn blocks.

    PYTHONPATH=src python -m repro_torch.kernels.compare_dense OLD_CSRC [--seed N]

OLD_CSRC is a ``csrc/`` whose dense pair has the two-launch gather's C
interface ``sb_gather_block_matvec(A, a_bf16, r, idx, gpart, g, n, d, K,
rows, T, stream)`` and ``sb_scatter_block_update(A, a_bf16, z_in, idx,
delta, z_out, n, d, K, stream)`` with δ rounded by the caller.  It is
built with ``_build``'s flags into a temporary directory (one ``nvcc`` per
source, all started together, then the link); the old calls go through a
copy of the old wrappers' host path (device switch, the (K, T, 128)
partials, δ rounded by two elementwise kernels, pointer objects), so the
event times compare whole calls.

Cases, drawn on the card from ``--seed`` (A standard normal): the Lasso
shape (16384 × 32768, K = 8) and zeta's (500,224 × 2048, K = 2) in f32 and
bf16; K = 1; K = 72 with duplicate draws; 10240 × 2048 at K = 5, whose
chunks are ragged; a NaN in r and in δ.  The scatter is compared in the
f32 bit patterns (a pair that differs only in the sign of a zero is
counted apart); the gather by its largest difference over the old
output's largest magnitude.  Device ms: every device op of a call
(profiler records, a window of that call alone, its records counted);
events ms: CUDA events over back-to-back calls; spin ms: events around
each call queued behind a spin kernel.  Prints one line per case and a
JSON summary; exits 1 when a scatter output differs in more than the sign
of a zero, a gather output by more than rel 1e-5, a repeat or a
two-stream call differs in a bit, or a new call makes more than one
device record.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import pathlib
import sys
import tempfile

import torch

from repro_torch.kernels import shotgun_block as sb
from repro_torch.kernels._compare import (bit_compare, build_old, device_ms,
                                          events_ms, queued_ms,
                                          records_per_call, turns)

GATHER_RTOL = 1e-5
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LASSO = dict(n=16384, d=32768, K=8)
ZETA = dict(n=500_224, d=2048, K=2)
RAGGED = dict(n=10_240, d=2048, K=5)

_OLD_ARGTYPES = {
    "sb_gather_block_matvec": [_P, _I, _P, _P, _P, _P, _L, _L, _I, _I, _I,
                               _P],
    "sb_scatter_block_update": [_P, _I, _P, _P, _P, _P, _L, _L, _I, _P],
}


def old_gather(lib, A, r, idx):
    """The old wrapper's host path and its two launches."""
    n, d = A.shape
    K = idx.shape[0]
    rows = sb._gather_rows(n)
    T = math.ceil(n / rows)
    rv = r.to(torch.float32).contiguous()
    ix = idx.to(torch.int32).contiguous()
    part = torch.empty((K, T, 128), dtype=torch.float32, device=A.device)
    g = torch.empty((K, 128), dtype=torch.float32, device=A.device)
    with torch.cuda.device(A.device):
        rc = lib.sb_gather_block_matvec(
            sb._ptr(A), int(A.dtype == torch.bfloat16), sb._ptr(rv),
            sb._ptr(ix), sb._ptr(part), sb._ptr(g), n, d, K, rows, T,
            sb._stream(A.device))
    if rc:
        raise RuntimeError(f"old sb_gather_block_matvec: CUDA error {rc}")
    return g


def old_scatter(lib, A, z, idx, delta):
    """The old wrapper's host path (δ rounded by the caller) and its
    launch."""
    n, d = A.shape
    K = idx.shape[0]
    z_in = z.to(torch.float32).contiguous()
    ix = idx.to(torch.int32).contiguous()
    dl = delta.to(A.dtype).to(torch.float32).contiguous()
    z_out = torch.empty(n, dtype=torch.float32, device=A.device)
    with torch.cuda.device(A.device):
        rc = lib.sb_scatter_block_update(
            sb._ptr(A), int(A.dtype == torch.bfloat16), sb._ptr(z_in),
            sb._ptr(ix), sb._ptr(dl), sb._ptr(z_out), n, d, K,
            sb._stream(A.device))
    if rc:
        raise RuntimeError(f"old sb_scatter_block_update: CUDA error {rc}")
    return z_out


def gather_rel(new, old) -> float:
    """Largest |new − old| over the largest |old|; NaN where they hold NaN
    in other places."""
    if not torch.equal(torch.isnan(new), torch.isnan(old)):
        return math.nan
    keep = ~torch.isnan(old)
    err = float((new - old)[keep].abs().max()) if keep.any() else 0.0
    return err / max(float(old[keep].abs().max()) if keep.any() else 0.0,
                     1e-30)


def two_streams(A, r, idx, r2, idx2):
    """#3 on two streams at once, each against its single-stream bits."""
    want = (sb.gather_block_matvec(A, r, idx),
            sb.gather_block_matvec(A, r2, idx2))
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000)      # both calls queue before either runs
    got = []
    for s, (rr, ii) in ((s1, (r, idx)), (s2, (r2, idx2))):
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            got.append(sb.gather_block_matvec(A, rr, ii))
    torch.cuda.synchronize()
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in zip(got, want))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old_csrc", type=pathlib.Path)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_dense: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        old = build_old(args.old_csrc, pathlib.Path(tmp), _OLD_ARGTYPES)
    g = torch.Generator(device=dev).manual_seed(args.seed + 50)
    summary, failed = {}, False

    def draw(nblk, K, dup):
        idx = torch.randint(0, nblk, (K,), generator=g, device=dev,
                            dtype=torch.int32)
        if dup and K > 1:
            idx[-1] = idx[0]
            idx[K // 2] = idx[0]
        return idx

    def case(tag, A, K, dup=True, nan_r=False, nan_d=False, timed=False):
        nonlocal failed
        n, d = A.shape
        idx = draw(d // 128, K, dup)
        r = torch.randn(n, generator=g, device=dev)
        z = torch.randn(n, generator=g, device=dev)
        dl = torch.randn(K, 128, generator=g, device=dev) * 0.01
        if nan_r:
            r[n // 3] = float("nan")
        if nan_d:
            dl[0, 5] = float("nan")
        res = {}
        gn = sb.gather_block_matvec(A, r, idx)
        rel = gather_rel(gn, old_gather(old, A, r, idx))
        res["g_rel"] = rel
        zn = sb.scatter_block_update(A, z, idx, dl)
        res["z"] = bit_compare(zn, old_scatter(old, A, z, idx, dl))
        res["repeat"] = bool(
            torch.equal(gn.view(torch.int32),
                        sb.gather_block_matvec(A, r, idx).view(torch.int32))
            and torch.equal(zn.view(torch.int32),
                            sb.scatter_block_update(A, z, idx, dl)
                            .view(torch.int32)))
        res["records"] = [records_per_call(
            lambda: sb.gather_block_matvec(A, r, idx)), records_per_call(
            lambda: sb.scatter_block_update(A, z, idx, dl))]
        failed |= (not rel <= GATHER_RTOL or res["z"]["other"] > 0
                   or not res["repeat"] or res["records"] != [1, 1])
        print(f"compare [{tag} K={K}]: gather max rel {rel:.3e}; scatter z "
              f"{res['z']}; repeats bit-identical {res['repeat']}; device "
              f"records a call {res['records']}")
        if timed:
            # cuBLAS on a contiguous copy of the drawn blocks (f32 only:
            # the same function), made outside the timed window
            Ac = torch.cat([A[:, b * 128:(b + 1) * 128]
                            for b in idx.tolist()], dim=1)
            dflat = dl.reshape(-1)
            yard = {"gather": lambda: torch.mv(Ac.t(), r),
                    "scatter": lambda: torch.addmv(z, Ac, dflat)}
            calls = {"gather": (lambda: old_gather(old, A, r, idx),
                                lambda: sb.gather_block_matvec(A, r, idx)),
                     "scatter": (lambda: old_scatter(old, A, z, idx, dl),
                                 lambda: sb.scatter_block_update(A, z, idx,
                                                                 dl))}
            for name, (fo, fn) in calls.items():
                t = turns(fo, fn, lambda f: events_ms(f, args.iters),
                          lambda f: device_ms(f, args.iters),
                          lambda f: queued_ms(f, args.iters))
                lib_dev = (device_ms(yard[name], args.iters)
                           if A.dtype == torch.float32 else None)
                res[f"{name}_turns"] = t
                res[f"{name}_cublas_device_ms"] = lib_dev
                print(f"time {name} [{tag} K={K}]: " + "; ".join(
                    f"{lb} events {e:.4f} device "
                    + ("n/a" if dv is None else f"{dv:.4f}")
                    + f" spin {q:.4f}" for lb, e, dv, q in t)
                    + " ms; cuBLAS on a copy device "
                    + ("n/a" if lib_dev is None else f"{lib_dev:.4f} ms"))
        summary[f"{tag} K={K}"] = res

    for tag, shape in (("lasso", LASSO), ("zeta", ZETA)):
        A = torch.randn(shape["n"], shape["d"], generator=g, device=dev)
        for store in ("f32", "bf16"):
            AA = A if store == "f32" else A.to(torch.bfloat16)
            case(f"{tag} {store}", AA, shape["K"], dup=False, timed=True)
            if tag == "lasso":
                case(f"{tag} {store} NaN in r and δ", AA, shape["K"],
                     nan_r=True, nan_d=True)
            del AA
        if tag == "lasso":
            case("lasso f32", A, 1)
            case("lasso f32 duplicates", A, 72)
            r = torch.randn(shape["n"], generator=g, device=dev)
            r2 = torch.randn(shape["n"], generator=g, device=dev)
            same = two_streams(A, r, draw(256, 8, False), r2,
                               draw(256, 8, False))
            summary["two streams"] = same
            failed |= not same
            print(f"compare [lasso f32 K=8 two streams]: each stream's "
                  f"bits equal a single-stream call {same}")
        del A
    A = torch.randn(RAGGED["n"], RAGGED["d"], generator=g, device=dev)
    case(f"ragged n={RAGGED['n']} f32", A, RAGGED["K"])
    case(f"ragged n={RAGGED['n']} bf16", A.to(torch.bfloat16), RAGGED["K"])
    print(json.dumps({"compare_dense": summary, "ok": not failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
