"""Hold the BlockedCSC two-kernel pair (``sparse_gather_block_matvec``,
``sparse_scatter_block_update``) against an earlier copy of ``csrc/`` on
the card: the scatter bit for bit, the gather to a tolerance, and both
timed in turns (old, new, new, old) on two clocks.

    PYTHONPATH=src python -m repro_torch.kernels.compare_pair OLD_CSRC [--seed N]

OLD_CSRC is a ``csrc/`` whose ``sp_scatter_block_update`` runs the
two-launch scatter through a zeroed (K, n) buffer, with the C interface
(rows, vals, v_bf16, order, count, zmask, z_in, idx, delta, buf, padterm,
z_out, n, tile, K, stream), and whose ``sp_gather_block_matvec`` has this
package's interface.  It is built with ``_build``'s flags into a temporary
directory (one ``nvcc`` per source, all started together, then the link);
the old calls go through a copy of the old wrappers' host path (device
switch, ``torch.zeros`` of the buffer, pointer objects), so the event
times compare the whole calls.

Problems are drawn on the card from ``--seed`` at LIBSVM news20.binary's
shape (S1: 19,996 × 1,355,191, density 3.36e-4, K = 32) and rcv1.binary's
(S2: 20,242 × 47,236, density 0.16%, K = 8), values f32 and bf16, plus K =
64 with duplicate draws and a NaN through a padding column.  Equality of the
scatter is of the f32 bit patterns; where a pair differs only in the sign
of a zero it is counted apart.  Device ms: every device op of the call
(profiler, a window of that call alone); events ms: CUDA events over
back-to-back calls.  Prints one line per case and a JSON summary; exits 1
when a scatter output differs in more than the sign of a zero, or a gather
output by more than rel 1e-5 of its largest magnitude.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import sys
import tempfile

import torch

from repro_torch.data import synthetic as syn
from repro_torch.kernels import shotgun_sparse as ss
from repro_torch.kernels._compare import (bit_compare, build_old, device_ms,
                                          events_ms, turns)

GATHER_RTOL = 1e-5
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
S1 = dict(n=19_996, d=1_355_191, density=3.36e-4, K=32)
S2 = dict(n=20_242, d=47_236, density=0.0016, K=8)


_OLD_ARGTYPES = {
    "sp_scatter_block_update": [_P, _P, _I] + [_P] * 9 + [_L, _I, _I, _P],
    "sp_gather_block_matvec": [_P, _P, _I, _P, _P, _P, _I, _I, _P],
}


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def old_scatter(lib, rows, vals, z, idx, delta, od):
    """The old wrapper's host path and its two launches."""
    K, n, tile = idx.shape[0], z.shape[0], rows.shape[1]
    dev = vals.device
    f32 = dict(dtype=torch.float32, device=dev)
    z_in = z.to(torch.float32).contiguous()
    ix = idx.to(torch.int32).contiguous()
    dl = delta.to(torch.float32).contiguous()
    buf = torch.zeros(K * n, **f32)
    padterm = torch.empty(K, **f32)
    z_out = torch.empty(n, **f32)
    with torch.cuda.device(dev):
        rc = lib.sp_scatter_block_update(
            _ptr(rows), _ptr(vals), int(vals.dtype == torch.bfloat16),
            _ptr(od.order), _ptr(od.count), _ptr(od.zmask), _ptr(z_in),
            _ptr(ix), _ptr(dl), _ptr(buf), _ptr(padterm), _ptr(z_out), n,
            tile, K, ctypes.c_void_p(torch.cuda.current_stream(dev)
                                     .cuda_stream))
    if rc:
        raise RuntimeError(f"old sp_scatter_block_update: CUDA error {rc}")
    return z_out


def old_gather(lib, rows, vals, r, idx):
    """The old wrapper's host path and its launch."""
    K, tile = idx.shape[0], rows.shape[1]
    dev = vals.device
    rv = r.to(torch.float32).contiguous()
    ix = idx.to(torch.int32).contiguous()
    g = torch.empty((K, 128), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.sp_gather_block_matvec(
            _ptr(rows), _ptr(vals), int(vals.dtype == torch.bfloat16),
            _ptr(rv), _ptr(ix), _ptr(g), tile, K,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc:
        raise RuntimeError(f"old sp_gather_block_matvec: CUDA error {rc}")
    return g


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old_csrc", type=pathlib.Path)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_pair: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        old = build_old(args.old_csrc, pathlib.Path(tmp), _OLD_ARGTYPES)
    g = torch.Generator(device=dev).manual_seed(args.seed + 30)
    summary, failed = {}, False
    for tag, shape, gen in (("S1", S1, syn.large_sparse_bcsc_on_device),
                            ("S2", S2, syn.logistic_bcsc_on_device)):
        S, _, _ = gen(args.seed + (10 if tag == "S1" else 11), n=shape["n"],
                      d=shape["d"], density=shape["density"], device=dev)
        for store in ("f32", "bf16"):
            A = S if store == "f32" else S.astype(torch.bfloat16)
            od, rs = A.scatter_order(), A.range_starts()
            for K in (shape["K"], 64):
                u = torch.rand(A.nblk, generator=g, device=dev)
                idx = u.argsort()[:K].to(torch.int32)
                idx[-1] = idx[0]                         # duplicate draw
                z = torch.randn(A.n, generator=g, device=dev)
                r = torch.randn(A.n, generator=g, device=dev)
                dl = torch.randn(K, 128, generator=g, device=dev) * 0.01
                case = f"{tag} {store} K={K}"
                res = {}
                cols = torch.nonzero(od.zmask[idx[0]])
                dn = dl.clone()
                if len(cols):
                    dn[0, int(cols[0])] = float("nan")
                for what, d_ in (("z", dl), ("z nan-pad", dn)):
                    new = ss.sparse_scatter_block_update(
                        A.rows, A.vals, z, idx, d_, order=od, rstart=rs)
                    res[what] = bit_compare(
                        new, old_scatter(old, A.rows, A.vals, z, idx, d_,
                                         od))
                    failed |= res[what]["other"] > 0
                gn = ss.sparse_gather_block_matvec(A.rows, A.vals, r, idx)
                go = old_gather(old, A.rows, A.vals, r, idx)
                err = float((gn - go).abs().max())
                rel = err / max(float(go.abs().max()), 1e-30)
                res["g_rel"] = rel
                failed |= not rel <= GATHER_RTOL
                if K == shape["K"] and store == "f32":
                    calls = {
                        "scatter": (
                            lambda: old_scatter(old, A.rows, A.vals, z, idx,
                                                dl, od),
                            lambda: ss.sparse_scatter_block_update(
                                A.rows, A.vals, z, idx, dl, order=od,
                                rstart=rs)),
                        "gather": (
                            lambda: old_gather(old, A.rows, A.vals, r, idx),
                            lambda: ss.sparse_gather_block_matvec(
                                A.rows, A.vals, r, idx))}
                    for name, (fo, fn) in calls.items():
                        t = turns(fo, fn,
                                  lambda f: events_ms(f, args.iters),
                                  lambda f: device_ms(f, args.iters))
                        res[f"{name}_turns"] = t
                        print(f"time {name} [{case}]: " + "; ".join(
                            f"{lb} events {e:.4f} ms device "
                            + ("n/a" if d is None else f"{d:.4f} ms")
                            for lb, e, d in t))
                print(f"compare [{case}]: scatter z {res['z']}; nan-pad "
                      f"{res['z nan-pad']}; gather max rel {rel:.3e}")
                summary[case] = res
    print(json.dumps({"compare_pair": summary, "ok": not failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
