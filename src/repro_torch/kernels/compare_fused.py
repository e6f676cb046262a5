"""Hold the fused kernels against an earlier copy of ``csrc/`` on the card:
every output bit for bit, and device time per call in turns old, new, new,
old.  Dense: ``fused_shotgun_rounds`` (#1), ``fused_shotgun_delta_rounds``
(#7) and ``batched_fused_shotgun_rounds`` (#9); BlockedCSC:
``fused_sparse_shotgun_rounds`` (#2), ``fused_sparse_shotgun_delta_rounds``
(#8) and ``batched_fused_sparse_shotgun_rounds`` (#10).

    PYTHONPATH=src python -m repro_torch.kernels.compare_fused OLD_CSRC [--seed N]

OLD_CSRC is a ``csrc/`` whose six fused entries have this package's C
interface.  It is built with ``_build``'s flags into a temporary
directory, and every old call runs this package's wrapper on the old
library.

Shapes are ``chip_smoke.py``'s, drawn on the card from ``--seed``, R = 8:

* dense: the Lasso (sparco, 16384 × 32768, K = 8) and zeta (logistic,
  500,224 × 2048, K = 2) designs in f32 and bf16, lasso and logistic Newton
  (labels sign(y)) on the Lasso design, logistic and logistic Newton on
  zeta, each with a duplicate draw and with k_eff = K and K − 1; #9 on 4
  stacked Lasso designs (f32, slot k_eff 8, 8, 4, 0), one bf16 Lasso design
  shared by 8 slots, and zeta shared by 4 slots (logistic Newton, slot 1's
  guard at 0);
* BlockedCSC: S1 at LIBSVM news20.binary's shape (19,996 × 1,355,191,
  density 3.36e-4, K = 32, lasso) and S2 at rcv1.binary's (20,242 ×
  47,236, density 0.16%, K = 8, logistic and logistic Newton), f32 and
  bf16, k_eff = K and K − 1, a duplicate draw; S2 with K = 72 (above the
  kernel's chunk of 32 drawn blocks), S2 cut to an odd tile of 7, and S2
  with a NaN iterate in a column with a padding slot (row 0 goes NaN);
  #10 on 4 stacked copies of S1 (slot k_eff 32, 32, 16, 0) and on S2
  shared by 4 slots (logistic Newton), once with slot 2 frozen (k_eff 0);
* #2's OVF instantiation (a design with an overflow store) at LIBSVM
  url_combined's row count (2,396,130 rows, 262,144 heavy-tailed columns,
  tile 64, K = 32, logistic Newton, f32), k_eff = K and K − 1, a duplicate
  draw: its BC walks ≈ 9,360 row items a round.

Equality is of the bit patterns of every output (x, z or Δz, F, nnz,
health).  Two device clocks per call, over ``--iters`` calls (fewer at
the slower shapes): the profiler's records of the fused kernel alone,
one a call (a window short of records is retried, and reported), and,
in brackets as "call", CUDA events around each call enqueued behind a spin
kernel — every device op of the call (the old calls' copies and fills
too), none of the host's enqueue.  Prints one line per case and a JSON
summary; exits 1 when any output differs in a bit.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import batched as kb
from repro_torch.kernels import shotgun_block as sb
from repro_torch.kernels import shotgun_sparse as ss
from repro_torch.kernels._compare import (bits_equal, build_old, device_ms,
                                          library, queued_ms, turns)

LASSO = dict(n=16384, d=32768, K=8)
ZETA = dict(n=500_000, d=2000, K=2)
S1 = dict(n=19_996, d=1_355_191, density=3.36e-4, K=32)
S2 = dict(n=20_242, d=47_236, density=0.0016, K=8)
URL = dict(n=2_396_130, d=262_144, tile=64, K=32)
R = 8
DENSE, SPARSE = ("fused_rounds_kernel",), ("fused_sparse_kernel",)
OVF = ("fused_sparse_ovf_kernel",)
_OLD_ARGTYPES = {name: _build._ARGTYPES[name] for name in (
    "sb_fused_shotgun_rounds", "sb_fused_shotgun_delta_rounds",
    "sb_batched_fused_shotgun_rounds", "sp_fused_shotgun_rounds",
    "sp_fused_shotgun_delta_rounds", "sp_batched_fused_shotgun_rounds",
    "sp_fused_shotgun_rounds_ovf")}


def on(lib, fn):
    """``fn`` with every launch through ``lib``."""
    def call():
        with library(lib):
            return fn()
    return call


def _dense_designs(seed: int, dev):
    """The Lasso and zeta problems of ``chip_smoke.py``, padded."""
    from repro_torch.core import objectives as obj
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import ops
    A, y, _ = syn.sparco_on_device(seed, n=LASSO["n"], d=LASSO["d"],
                                   device=dev)
    lasso = obj.make_problem(A, y, 1.0, device=dev)
    del A
    lasso = lasso._replace(lam=0.1 * obj.lambda_max(lasso.A, lasso.y,
                                                     "lasso"))
    A, y, _ = syn.logistic_data_on_device(seed + 1, n=ZETA["n"],
                                          d=ZETA["d"], device=dev)
    zeta = obj.make_problem(A, y, 1.0, loss="logistic", device=dev)
    del A
    zeta = zeta._replace(lam=0.1 * obj.lambda_max(zeta.A, zeta.y,
                                                   "logistic"))
    La, Ly, Lm = ops.pad_problem(lasso.A, lasso.y)
    Za, Zy, Zm = ops.pad_problem(zeta.A, zeta.y)
    return (dict(A=La, A16=La.to(torch.bfloat16), y=Ly, m=Lm.float(),
                 lam=lasso.lam, beta=1.0),
            dict(A=Za, A16=Za.to(torch.bfloat16), y=Zy, m=Zm.float(),
                 lam=zeta.lam, beta=0.25))


def _sparse_designs(seed: int, dev):
    """The S1 (lasso) and S2 (logistic) BlockedCSC problems."""
    from repro_torch.core import objectives as obj
    from repro_torch.data import synthetic as syn
    out = []
    for tag, shape, gen, loss in (
            ("S1", S1, syn.large_sparse_bcsc_on_device, "lasso"),
            ("S2", S2, syn.logistic_bcsc_on_device, "logistic")):
        A, y, _ = gen(seed + (10 if tag == "S1" else 11), n=shape["n"],
                      d=shape["d"], density=shape["density"], device=dev)
        prob = obj.make_problem(A, y, 1.0, loss=loss, device=dev)
        del A
        prob = prob._replace(lam=0.1 * obj.lambda_max(prob.A, prob.y, loss))
        out.append(prob)
    return out


def _ovf_design(seed: int, dev):
    """A logistic problem at url_combined's row count on a heavy-tailed
    design: the column of rank r (a seeded permutation) draws ⌊n / r⌋
    uniform rows (repeats kept once), values N(0, 1), labels ±1 at random;
    ``BlockedCSC.from_csc`` at tile 64, so each column deeper than 64
    spills into the overflow store."""
    from repro_torch.core import objectives as obj
    from repro_torch.data.sparse import BlockedCSC
    g = torch.Generator(device=dev).manual_seed(seed + 12)
    n, d = URL["n"], URL["d"]
    count = n // (torch.randperm(d, generator=g, device=dev) + 1)
    col = torch.repeat_interleave(torch.arange(d, device=dev), count)
    key = torch.unique(col * n + torch.randint(
        0, n, (col.numel(),), generator=g, device=dev))
    del col, count
    col, row = key // n, (key % n).to(torch.int32)
    col_ptr = torch.searchsorted(col, torch.arange(d + 1, device=dev))
    vals = torch.randn(row.numel(), generator=g, device=dev)
    A = BlockedCSC.from_csc(col_ptr, row, vals, n, d, tile=URL["tile"],
                            device=dev)
    del key, col, row, vals
    y = torch.where(torch.rand(n, generator=g, device=dev) < 0.5, 1.0, -1.0)
    prob = obj.make_problem(A, y, 1.0, loss="logistic", device=dev)
    return prob._replace(lam=0.1 * obj.lambda_max(prob.A, prob.y,
                                                   "logistic"))


def ovf_cases(old, seed: int, g, record, timed, iters: int) -> None:
    """#2's OVF instantiation at url's row count, new against ``old``:
    bit for bit at k_eff = K and K − 1 (a duplicate draw, a small start),
    then device time per call from zero in turns."""
    dev = g.device
    prob = _ovf_design(seed, dev)
    A, K = prob.A, URL["K"]
    kw = dict(loss="logistic_newton", order=A.scatter_order(),
              rstart=A.range_starts(), ovf=A.ovf)
    tag = f"url n={A.n} logistic_newton f32 tile={A.tile} K={K} R={R}"
    for k_eff in (None, K - 1):
        x0 = torch.randn(A.d_pad, generator=g, device=dev) * 0.01
        x0[A.d:] = 0.0
        fa = (A.rows, A.vals, A.matvec(x0), x0, _draws(g, K, A.nblk),
              prob.lam, prob.beta, prob.y)
        fn = lambda: ss.fused_sparse_shotgun_rounds(  # noqa: E731
            *fa, k_eff=k_eff, **kw)
        record(f"#2 OVF {tag} k_eff={k_eff}", fn(), on(old, fn)())
    fa = (A.rows, A.vals, torch.zeros(A.n, device=dev),
          torch.zeros(A.d_pad, device=dev),
          _draws(g, K, A.nblk, dup=False), prob.lam, prob.beta, prob.y)
    fn = lambda: ss.fused_sparse_shotgun_rounds(*fa, **kw)  # noqa: E731
    timed(f"#2 OVF {tag}", on(old, fn), fn, iters, OVF)


def _draws(g, K, nblk, dup=True):
    idx = torch.rand(R, nblk, generator=g, device=g.device).argsort(
        dim=-1)[:, :K].to(torch.int32)
    if dup and K > 1:
        idx[R // 2, -1] = idx[R // 2, 0]
    return idx


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old_csrc", type=pathlib.Path)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_fused: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        old = build_old(args.old_csrc, pathlib.Path(tmp), _OLD_ARGTYPES)
    g = torch.Generator(device=dev).manual_seed(args.seed + 40)
    summary, times, failed = {}, {}, False
    inf = float("inf")

    def record(case, got, want):
        nonlocal failed
        same = bits_equal(got, want)
        failed |= not same
        summary[case] = dict(bitwise=same)
        print(f"compare [{case}]: {'bit-identical' if same else 'DIFFER'}")

    def timed(name, fo, fn, iters, kernels):
        t = turns(fo, fn, lambda f: device_ms(f, iters, kernels, 1),
                  lambda f: queued_ms(f, iters))
        times[name] = t
        print(f"time {name}: " + "; ".join(
            f"{lb} {'n/a' if ms is None else f'{ms:.4f}'} "
            f"(call {q:.4f})" for lb, ms, q in t) + " ms device")

    def full(S, v):
        return torch.full((S,), float(v), device=dev)

    def ladder(lam, S):
        return lam * (1.0 + 0.5 * torch.arange(S, dtype=torch.float32,
                                                device=dev))

    # ---- #1 and #7 at chip_smoke.py's shapes, losses and storage types ---
    lasso, zeta = _dense_designs(args.seed, dev)
    ylog = torch.where(lasso["y"] >= 0, 1.0, -1.0) * lasso["m"]
    for tag, P, loss, K, y in (
            ("lasso", lasso, "lasso", LASSO["K"], lasso["y"]),
            ("lasso", lasso, "logistic_newton", LASSO["K"], ylog),
            ("zeta", zeta, "logistic", ZETA["K"], zeta["y"]),
            ("zeta", zeta, "logistic_newton", ZETA["K"], zeta["y"])):
        d = P["A"].shape[1]
        idx = _draws(g, K, d // 128)
        x0 = torch.randn(d, generator=g, device=dev) * 0.01
        for store in ("f32", "bf16"):
            A = P["A"] if store == "f32" else P["A16"]
            z0 = A.float() @ x0
            for k_eff in (None, K - 1):
                fa = (A, z0, x0, idx, P["lam"], P["beta"], y, P["m"])
                case = f"{tag} {loss} {store} K={K} R={R} k_eff={k_eff}"
                rounds = lambda: sb.fused_shotgun_rounds(  # noqa: E731
                    *fa, loss=loss, k_eff=k_eff)
                record("#1 " + case, rounds(), on(old, rounds)())
                delta = lambda: sb.fused_shotgun_delta_rounds(  # noqa: E731
                    *fa, loss=loss, k_eff=k_eff)
                record("#7 " + case, delta(), on(old, delta)())

    # ---- #9 at chip_smoke.py's serve shapes -------------------------------
    stacked = torch.stack([lasso["A"] * (1.0 + 0.1 * s) for s in range(4)])
    kl = full(4, 8)
    kl[2], kl[3] = 4, 0
    gz = full(4, inf)
    gz[1] = 0.0
    for tag, A, shared, P, loss, K, S, k_eff, guard in (
            ("lasso f32 stacked S=4", stacked, False, lasso, "lasso", 8, 4,
             kl, full(4, inf)),
            ("lasso bf16 shared S=8", lasso["A16"], True, lasso, "lasso", 8,
             8, full(8, 8), full(8, inf)),
            ("zeta logistic_newton f32 shared S=4", zeta["A"], True, zeta,
             "logistic_newton", 2, 4, full(4, 2), gz)):
        dd = P["A"].shape[1]
        x0 = torch.randn(S, dd, generator=g, device=dev) * 0.01
        z0 = torch.stack([(A if shared else A[s]).float() @ x0[s]
                          for s in range(S)])
        idx = torch.stack([_draws(g, K, dd // 128) for _ in range(S)])
        fa = (A, z0, x0, idx, ladder(P["lam"], S), full(S, P["beta"]),
              P["y"].expand(S, -1).contiguous(),
              P["m"].expand(S, -1).contiguous(), k_eff, guard)
        fn = lambda: kb.batched_fused_shotgun_rounds(  # noqa: E731
            *fa, loss=loss, shared_design=shared)
        record(f"#9 {tag} K={K} R={R}", fn(), on(old, fn)())

    # ---- device time per call at chip_smoke.py's timing shapes ------------
    def zeros_args(P, A, K):
        nn, dd = A.shape
        return (A, torch.zeros(nn, device=dev), torch.zeros(dd, device=dev),
                _draws(g, K, dd // 128, dup=False), P["lam"], P["beta"],
                P["y"], P["m"])

    for tag, P, A, loss, K, iters in (
            ("lasso f32", lasso, lasso["A"], "lasso", 8, args.iters),
            ("lasso bf16", lasso, lasso["A16"], "lasso", 8, args.iters),
            ("zeta f32 logistic_newton", zeta, zeta["A"], "logistic_newton",
             2, max(2, args.iters // 2))):
        fa = zeros_args(P, A, K)
        fn = lambda: sb.fused_shotgun_rounds(*fa, loss=loss)  # noqa: E731
        timed(f"#1 {tag} R={R}", on(old, fn), fn, iters, DENSE)
        fn = lambda: sb.fused_shotgun_delta_rounds(*fa, loss=loss)  # noqa
        timed(f"#7 {tag} R={R}", on(old, fn), fn, iters, DENSE)
    for tag, A, shared, P, loss, K, S, iters in (
            ("lasso f32 stacked S=4", stacked, False, lasso, "lasso", 8, 4,
             max(2, args.iters // 2)),
            ("lasso bf16 shared S=8", lasso["A16"], True, lasso, "lasso", 8,
             8, max(2, args.iters // 2)),
            ("zeta logistic_newton f32 shared S=4", zeta["A"], True, zeta,
             "logistic_newton", 2, 4, max(2, args.iters // 5))):
        nn, dd = P["A"].shape
        fa = (A, torch.zeros(S, nn, device=dev),
              torch.zeros(S, dd, device=dev),
              torch.stack([_draws(g, K, dd // 128, dup=False)
                           for _ in range(S)]),
              ladder(P["lam"], S), full(S, P["beta"]),
              P["y"].expand(S, -1).contiguous(),
              P["m"].expand(S, -1).contiguous(), full(S, K), full(S, inf))
        fn = lambda: kb.batched_fused_shotgun_rounds(  # noqa: E731
            *fa, loss=loss, shared_design=shared)
        timed(f"#9 {tag} R={R}", on(old, fn), fn, iters, DENSE)
    del stacked, lasso, zeta

    # ---- #2 and #8 at S1 and S2, f32 and bf16 ------------------------------
    s1, s2 = _sparse_designs(args.seed, dev)

    def sparse_pair(case, A, prob, loss, idx, x0, k_eff=None):
        """#2 and #8, new against old, on one input."""
        od, rs = A.scatter_order(), A.range_starts()
        fa = (A.rows, A.vals, A.matvec(x0), x0, idx, prob.lam, prob.beta,
              prob.y)
        rounds = lambda: ss.fused_sparse_shotgun_rounds(  # noqa: E731
            *fa, loss=loss, k_eff=k_eff, order=od, rstart=rs)
        record("#2 " + case, rounds(), on(old, rounds)())
        delta = lambda: ss.fused_sparse_shotgun_delta_rounds(  # noqa: E731
            *fa, loss=loss, k_eff=k_eff, order=od, rstart=rs)
        record("#8 " + case, delta(), on(old, delta)())

    def start(A):
        x0 = torch.randn(A.d_pad, generator=g, device=dev) * 0.01
        x0[A.d:] = 0.0
        return x0

    for tag, prob, K, losses in (("S1", s1, S1["K"], ("lasso",)),
                                 ("S2", s2, S2["K"],
                                  ("logistic", "logistic_newton"))):
        for store in ("f32", "bf16"):
            A = prob.A if store == "f32" else prob.A.astype(torch.bfloat16)
            od, rs = A.scatter_order(), A.range_starts()
            for loss in losses:
                idx, x0 = _draws(g, K, A.nblk), start(A)
                for k_eff in (None, K - 1):
                    sparse_pair(f"{tag} {loss} {store} tile={A.tile} K={K} "
                                f"R={R} k_eff={k_eff}", A, prob, loss, idx,
                                x0, k_eff)
            if store == "f32":
                loss = losses[-1]
                fa = (A.rows, A.vals, torch.zeros(A.n, device=dev),
                      torch.zeros(A.d_pad, device=dev),
                      _draws(g, K, A.nblk, dup=False), prob.lam, prob.beta,
                      prob.y)
                fn = lambda: ss.fused_sparse_shotgun_rounds(  # noqa: E731
                    *fa, loss=loss, order=od, rstart=rs)
                timed(f"#2 {tag} f32 {loss} R={R}", on(old, fn), fn,
                      args.iters, SPARSE)
                fn = lambda: ss.fused_sparse_shotgun_delta_rounds(  # noqa
                    *fa, loss=loss, order=od, rstart=rs)
                timed(f"#8 {tag} f32 {loss} R={R}", on(old, fn), fn,
                      args.iters, SPARSE)

    # S2 with K above the kernel's chunk of drawn blocks, cut to an odd
    # tile, and with a NaN iterate in a column with a padding slot
    A = s2.A
    sparse_pair(f"S2 logistic f32 tile={A.tile} K=72 R={R}", A, s2,
                "logistic", _draws(g, 72, A.nblk), start(A))
    A7 = type(A)(rows=A.rows[:, :7].contiguous(),
                 vals=A.vals[:, :7].contiguous(), n=A.n, d=A.d,
                 block=A.block)
    sparse_pair(f"S2 logistic_newton f32 tile=7 K={S2['K']} R={R}", A7, s2,
                "logistic_newton", _draws(g, S2["K"], A7.nblk), start(A7))
    b, c = map(int, torch.nonzero(A.scatter_order().zmask)[0])
    x0 = start(A)
    x0[b * 128 + c] = float("nan")
    idx = _draws(g, S2["K"], A.nblk)
    idx[:, 0] = b
    sparse_pair(f"S2 logistic f32 NaN in padded column K={S2['K']} R={R}",
                A, s2, "logistic", idx, x0)

    # ---- #10: S1 stacked on 4 slots, S2 shared by 4 -----------------------
    S = 4
    st_rows = s1.A.rows.expand(S, -1, -1, -1).contiguous()
    st_vals = s1.A.vals.expand(S, -1, -1, -1).contiguous()
    k1 = full(S, S1["K"])
    k1[2], k1[3] = S1["K"] // 2, 0
    k2 = full(S, S2["K"])
    k2[2] = 0
    for tag, prob, rows, vals, shared, loss, K, k_eff in (
            ("S1 lasso f32 stacked S=4", s1, st_rows, st_vals, False,
             "lasso", S1["K"], k1),
            ("S2 logistic_newton f32 shared S=4", s2, s2.A.rows, s2.A.vals,
             True, "logistic_newton", S2["K"], full(S, S2["K"])),
            ("S2 logistic_newton f32 shared S=4 slot 2 frozen", s2,
             s2.A.rows, s2.A.vals, True, "logistic_newton", S2["K"], k2)):
        A = prob.A
        od = (A.scatter_order() if shared
              else kb.stacked_scatter_order(rows, vals))
        rs = kb.stacked_range_starts(rows, od, A.n)
        x0 = torch.randn(S, A.d_pad, generator=g, device=dev) * 0.01
        x0[:, A.d:] = 0.0
        z0 = torch.stack([A.matvec(x0[s]) for s in range(S)])
        idx = torch.stack([_draws(g, K, A.nblk) for _ in range(S)])
        y = prob.y.expand(S, -1).contiguous()
        fa = (rows, vals, z0, x0, idx, ladder(prob.lam, S),
              full(S, prob.beta), y, k_eff, full(S, inf))
        kw = dict(loss=loss, shared_design=shared, order=od, rstart=rs)
        fn = lambda: kb.batched_fused_sparse_shotgun_rounds(  # noqa: E731
            *fa, **kw)
        record(f"#10 {tag} K={K} R={R}", fn(), on(old, fn)())
        if "frozen" in tag:
            continue
        fa = (rows, vals, torch.zeros(S, A.n, device=dev),
              torch.zeros(S, A.d_pad, device=dev),
              torch.stack([_draws(g, K, A.nblk, dup=False)
                           for _ in range(S)]),
              ladder(prob.lam, S), full(S, prob.beta), y, full(S, K),
              full(S, inf))
        fn = lambda: kb.batched_fused_sparse_shotgun_rounds(  # noqa: E731
            *fa, **kw)
        timed(f"#10 {tag} R={R}", on(old, fn), fn, args.iters, SPARSE)

    # ---- #2's OVF instantiation at url_combined's row count ---------------
    ovf_cases(old, args.seed, g, record, timed, max(2, args.iters // 2))
    print(json.dumps({"compare_fused": summary, "times": times,
                      "ok": not failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
