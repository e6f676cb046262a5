"""The port's CUDA kernels (dense and BlockedCSC, margin-owning,
Δz-emitting and batched) on the card against their plain versions on the
same inputs, bit-identical repeat runs, a batched slot bit-identical to the
unbatched kernel, the launch counters, the sharded driver on a one-rank
NCCL group and a served stream against the sequential queue.  Marked
``gpu``; each test skips (inside the ``cuda`` fixture, so every worker
collects the same tests) when ``torch.cuda.is_available()`` is false.

Run on a machine with the card:
    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: the kernels sum in another order than the plain versions
(tile partials, shuffle trees); after R = 8 rounds x, z and F agree to
rtol/atol 1e-4 (bf16 A: 1e-3, as against the JAX kernel)."""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import batched as tcb  # noqa: E402
from repro_torch.core import objectives as tobj  # noqa: E402
from repro_torch.core import sharded as tsh  # noqa: E402
from repro_torch.core.spec import SolverSpec  # noqa: E402
from repro_torch.data import sparse as tsp  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.kernels import batched as tkb  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import shotgun_block as tsb  # noqa: E402
from repro_torch.kernels import shotgun_sparse as tss  # noqa: E402
from repro_torch.launch import solver_serve as tserve  # noqa: E402

pytestmark = pytest.mark.gpu
BLOCK = 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _padded(loss, dev, n=1000, d=700, seed=0):
    name = "lasso" if loss == "lasso" else "logistic"
    A, y, _ = (tsyn.sparco(seed=seed, n=n, d=d) if name == "lasso"
               else tsyn.logistic_data(seed=seed, n=n, d=d))
    prob = tobj.make_problem(A, y, 0.3 if name == "lasso" else 0.5,
                             loss=name, device=dev)
    Ap, yp, mask = tops.pad_problem(prob.A, prob.y)
    return prob, Ap, yp, mask


def _inputs(Ap, R=8, K=3, seed=1):
    g = torch.Generator(device=Ap.device).manual_seed(seed)
    nblk = Ap.shape[1] // BLOCK
    x = torch.randn(Ap.shape[1], generator=g, device=Ap.device) * 0.05
    idx = torch.randint(0, nblk, (R, K), generator=g, device=Ap.device,
                        dtype=torch.int32)
    idx[R // 2, -1] = idx[R // 2, 0]                   # duplicate draw
    return x, Ap @ x, idx


@pytest.mark.parametrize("store", ["f32", "bf16"])
def test_gather_and_scatter_match_plain(cuda, store):
    _, Ap, _, _ = _padded("lasso", cuda)
    A = Ap.to(torch.bfloat16) if store == "bf16" else Ap
    g = torch.Generator(device=cuda).manual_seed(2)
    r = torch.randn(A.shape[0], generator=g, device=cuda)
    idx = torch.tensor([2, 0, 2, 5], dtype=torch.int32, device=cuda)
    delta = torch.randn(4, BLOCK, generator=g, device=cuda) * 0.1
    tol = 1e-3 if store == "bf16" else 1e-4
    got = tsb.gather_block_matvec(A, r, idx)
    torch.testing.assert_close(got, tsb.gather_block_matvec_plain(A, r, idx),
                               rtol=tol, atol=tol)
    zk = tsb.scatter_block_update(A, r, idx, delta)
    torch.testing.assert_close(
        zk, tsb.scatter_block_update_plain(A, r, idx, delta),
        rtol=tol, atol=tol)
    assert torch.equal(got, tsb.gather_block_matvec(A, r, idx))
    assert torch.equal(zk, tsb.scatter_block_update(A, r, idx, delta))


@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("loss", ["lasso", "logistic", "logistic_newton"])
def test_fused_matches_plain_and_repeats_bitwise(cuda, loss, store):
    prob, Ap, yp, mask = _padded(loss, cuda)
    A = Ap.to(torch.bfloat16) if store == "bf16" else Ap
    x, z, idx = _inputs(A.float())
    tol = 1e-3 if store == "bf16" else 1e-4
    for k_eff in (None, 2):
        args = (A, z, x, idx, prob.lam, prob.beta, yp, mask)
        got = tsb.fused_shotgun_rounds(*args, loss=loss, k_eff=k_eff)
        want = tsb.fused_shotgun_rounds_plain(*args, loss=loss, k_eff=k_eff)
        for u, v in zip(got[:3], want[:3]):
            torch.testing.assert_close(u, v, rtol=tol, atol=tol)
        assert torch.all((got[3] - want[3]).abs() <= 1)
        assert float(got[4]) == float(want[4]) == 0.0
        again = tsb.fused_shotgun_rounds(*args, loss=loss, k_eff=k_eff)
        for u, v in zip(got, again):
            assert torch.equal(u, v)


def test_fused_invariants_on_card(cuda):
    prob, Ap, yp, mask = _padded("logistic", cuda)
    x, z, idx = _inputs(Ap)
    args = (Ap, z, x, idx, prob.lam, prob.beta, yp, mask)
    full = tsb.fused_shotgun_rounds(*args, loss="logistic")
    same = tsb.fused_shotgun_rounds(*args, loss="logistic",
                                    k_eff=torch.tensor(3, device=cuda))
    for u, v in zip(full, same):
        assert torch.equal(u, v)
    xo, zo, _, _, h = tsb.fused_shotgun_rounds(*args, loss="logistic",
                                               k_eff=0)
    assert torch.equal(xo, x) and torch.equal(zo, z) and float(h) == 0.0
    *_, h = tsb.fused_shotgun_rounds(
        *args, loss="logistic", guard_f=full[2].min() * 0.5)
    assert float(h) == 1.0


def _wide(loss, dev, n, d=4096, seed=0):
    """A padded problem with more scatter tiles than the fused grid has
    CTAs (n = 32768: 1024 tiles on 528)."""
    name = "lasso" if loss == "lasso" else "logistic"
    A, y, _ = (tsyn.sparco_on_device(seed, n=n, d=d, device=dev)
               if name == "lasso" else
               tsyn.logistic_data_on_device(seed, n=n, d=d, device=dev))
    prob = tobj.make_problem(A, y, 0.1, loss=name, device=dev)
    Ap, yp, mask = tops.pad_problem(prob.A, prob.y)
    return prob, Ap, yp, mask


@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("loss", ["lasso", "logistic_newton"])
def test_fused_wide_matches_plain_and_repeats_bitwise(cuda, loss, store):
    """#1 and #7 at n = 32768 against the plain version, a second launch
    bit for bit against the first, and the phase stamps."""
    prob, Ap, yp, mask = _wide(loss, cuda, 32768)
    A = Ap.to(torch.bfloat16) if store == "bf16" else Ap
    x, z, idx = _inputs(A.float(), K=8)
    tol = 1e-3 if store == "bf16" else 1e-4
    args = (A, z, x, idx, prob.lam, prob.beta, yp, mask)
    got = tsb.fused_shotgun_rounds(*args, loss=loss)
    want = tsb.fused_shotgun_rounds_plain(*args, loss=loss)
    for u, v in zip(got[:3], want[:3]):
        torch.testing.assert_close(u, v, rtol=tol, atol=tol)
    assert torch.all((got[3] - want[3]).abs() <= 1)
    got7 = tsb.fused_shotgun_delta_rounds(*args, loss=loss)
    _delta_check(got7, tsb.fused_shotgun_delta_rounds_plain(*args, loss=loss),
                 tol)
    assert all(torch.equal(u, v) for u, v in zip(
        got7, tsb.fused_shotgun_delta_rounds(*args, loss=loss)))
    # the phase stamps: one per barrier, in order, outputs unchanged
    stamps = torch.zeros(2 + 3 * idx.shape[0], dtype=torch.int64,
                         device=cuda)
    timed = tsb.fused_shotgun_rounds(*args, loss=loss, stamps=stamps)
    assert all(torch.equal(u, v) for u, v in zip(got, timed))
    assert int(stamps[0]) > 0 and bool(torch.all(stamps[1:] > stamps[:-1]))


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("loss", ["lasso", "logistic_newton"])
def test_batched_wide_equals_unbatched_bitwise(cuda, loss, shared):
    """#9 on 2 slots at n = 16384 (1024 scatter tiles a launch) against the
    plain version, and bit for bit against the unbatched kernel slot by
    slot."""
    padded = [_wide(loss, cuda, 16384, seed=s) for s in range(2)]
    prob = padded[0][0]
    A = torch.stack([p[1] for p in padded])
    A = A[0].to(torch.bfloat16) if shared else A
    y = torch.stack([p[2] for p in padded])
    mask = torch.stack([p[3] for p in padded])
    cols = [_inputs((A if shared else A[s]).float(), K=8, seed=10 + s)
            for s in range(2)]
    x, z, idx = (torch.stack(c) for c in zip(*cols))
    lam = prob.lam * torch.tensor([1.0, 1.5], device=cuda)
    beta = torch.full((2,), prob.beta, device=cuda)
    k_eff = torch.tensor([8.0, 5.0], device=cuda)
    guard = torch.full((2,), float("inf"), device=cuda)
    args = (A, z, x, idx, lam, beta, y, mask, k_eff, guard)
    want = tkb.batched_fused_shotgun_rounds_plain(*args, loss=loss,
                                                  shared_design=shared)
    tol = 1e-3 if shared else 1e-4
    got = tkb.batched_fused_shotgun_rounds(*args, loss=loss,
                                           shared_design=shared)
    for u, v in zip(got[:3], want[:3]):
        torch.testing.assert_close(u, v, rtol=tol, atol=tol)
    for s in range(2):
        one = tsb.fused_shotgun_rounds(
            A if shared else A[s], z[s], x[s], idx[s], lam[s], beta[s], y[s],
            mask[s], loss=loss, k_eff=k_eff[s])
        assert all(torch.equal(a[s], b) for a, b in zip(got, one)), s


@pytest.mark.parametrize("fused", [True, False])
def test_solve_on_card_matches_cpu_and_counts_launches(cuda, fused):
    A, y, _ = tsyn.sparco(seed=3, n=900, d=1000)
    spec = SolverSpec(loss="lasso", P=256, rounds=16, fused=fused)
    idx = np.random.default_rng(0).integers(0, 8, (16, 2)).astype(np.int32)
    idx[:, 1] = (idx[:, 0] + 1 + idx[:, 1] % 7) % 8     # distinct per round
    res = {}
    for dev in ("cpu", cuda):
        prob = tobj.make_problem(A, y, 5.0, device=dev)
        tsb.reset_launches()
        res[str(dev)] = tops.block_shotgun_solve(prob, spec=spec,
                                                 blk_idx=idx)
        counts = dict(tsb.LAUNCHES)
    assert counts == ({"fused_shotgun_rounds": 2, "gather_block_matvec": 0,
                       "scatter_block_update": 0,
                       "fused_shotgun_delta_rounds": 0} if fused else
                      {"fused_shotgun_rounds": 0, "gather_block_matvec": 16,
                       "scatter_block_update": 16,
                       "fused_shotgun_delta_rounds": 0})
    cpu, gpu = res["cpu"], res["cuda"]
    torch.testing.assert_close(gpu.trace.objective.cpu(),
                               cpu.trace.objective, rtol=1e-4, atol=0)
    torch.testing.assert_close(gpu.x.cpu(), cpu.x, rtol=1e-4, atol=1e-4)
    assert int(gpu.status) == 0


# ---------------------------------------------------------------------------
# BlockedCSC kernels
# ---------------------------------------------------------------------------

def _shallow(name, n, d, tile, seed):
    """A BlockedCSC of 1..tile nonzeros a column (tile ``tile``, odd or
    even) and its labels, on the CPU."""
    rng = np.random.default_rng(seed + 100 * tile)
    A = np.zeros((n, d), np.float32)
    for j in range(d):
        k = int(rng.integers(1, tile + 1))
        A[rng.choice(n, k, replace=False), j] = rng.standard_normal(k)
    x = np.zeros(d, np.float32)
    x[rng.choice(d, 30, replace=False)] = rng.standard_normal(30)
    y = A @ x + 0.05 * rng.standard_normal(n).astype(np.float32)
    if name == "logistic":
        y = np.where(y >= 0, 1.0, -1.0).astype(np.float32)
    return tsp.BlockedCSC.from_dense(A, tile=tile, device="cpu"), y


def _sparse(loss, dev, n=1500, d=3000, seed=0, tile=None):
    name = "lasso" if loss == "lasso" else "logistic"
    if tile is not None:
        S, y = _shallow(name, n, d, tile, seed)
    elif name == "lasso":
        S, y, _ = tsyn.large_sparse(seed=seed, n=n, d=d, density=0.01,
                                    layout="bcsc")
    else:
        S, y, _ = tsyn.logistic_data(seed=seed, n=n, d=d, density=0.02,
                                     layout="bcsc")
    return tobj.make_problem(S, y, 0.3 if name == "lasso" else 0.5,
                             loss=name, device=dev)


def _sparse_inputs(S, R=8, K=3, seed=1):
    g = torch.Generator(device=S.device).manual_seed(seed)
    x = torch.randn(S.d_pad, generator=g, device=S.device) * 0.05
    x[S.d:] = 0.0
    idx = torch.randint(0, S.nblk, (R, K), generator=g, device=S.device,
                        dtype=torch.int32)
    idx[R // 2, -1] = idx[R // 2, 0]                   # duplicate draw
    return x, S.matvec(x), idx


@pytest.mark.parametrize("store", ["f32", "bf16"])
def test_sparse_gather_and_scatter_match_plain(cuda, store):
    prob = _sparse("lasso", cuda)
    S = prob.A.astype(torch.bfloat16) if store == "bf16" else prob.A
    g = torch.Generator(device=cuda).manual_seed(2)
    r = torch.randn(S.n, generator=g, device=cuda)
    idx = torch.tensor([2, 0, 2, 5], dtype=torch.int32, device=cuda)
    delta = torch.randn(4, BLOCK, generator=g, device=cuda) * 0.1
    got = tss.sparse_gather_block_matvec(S.rows, S.vals, r, idx)
    torch.testing.assert_close(
        got, tss.sparse_gather_block_matvec_plain(S.rows, S.vals, r, idx),
        rtol=1e-4, atol=1e-4)
    zk = tss.sparse_scatter_block_update(S.rows, S.vals, r, idx, delta,
                                         order=S.scatter_order())
    torch.testing.assert_close(
        zk, tss.sparse_scatter_block_update_plain(S.rows, S.vals, r, idx,
                                                  delta),
        rtol=1e-4, atol=1e-4)
    assert torch.equal(got, tss.sparse_gather_block_matvec(S.rows, S.vals,
                                                           r, idx))
    assert torch.equal(zk, tss.sparse_scatter_block_update(
        S.rows, S.vals, r, idx, delta))


def _padded_sparse(dev, store, n=1500, d=3000, tile=None):
    """A BlockedCSC at n rows (not a multiple of RANGE_ROWS) with two
    all-padding tail blocks (count 0), in f32 or bf16, of the generator's
    tile depth or of ``tile``."""
    S = (tsyn.large_sparse(seed=5, n=n, d=d, density=0.01, layout="bcsc")[0]
         if tile is None else _shallow("lasso", n, d, tile, 5)[0])
    S = tsp.pad_feature_blocks(S, S.nblk + 2).to(dev)
    return S.astype(torch.bfloat16) if store == "bf16" else S


@pytest.mark.parametrize("tile", [None, 7])
@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("K", [1, 8, 64])
def test_sparse_scatter_rows_matches_plain_and_repeats_bitwise(cuda, K,
                                                               store, tile):
    S = _padded_sparse(cuda, store, tile=tile)
    assert S.n % tsp.RANGE_ROWS and int(S.scatter_order().count[-1]) == 0
    g = torch.Generator(device=cuda).manual_seed(K)
    idx = torch.randint(0, S.nblk, (K,), generator=g, device=cuda,
                        dtype=torch.int32)
    idx[0] = S.nblk - 1                                 # count-0 block
    if K > 1:
        idx[-1] = idx[K // 2]                           # duplicate draw
    z = torch.randn(S.n, generator=g, device=cuda)
    delta = torch.randn(K, BLOCK, generator=g, device=cuda) * 0.1
    kw = dict(order=S.scatter_order(), rstart=S.range_starts())
    before = tss.LAUNCHES["sparse_scatter_block_update"]
    got = tss.sparse_scatter_block_update(S.rows, S.vals, z, idx, delta,
                                          **kw)
    assert tss.LAUNCHES["sparse_scatter_block_update"] == before + 1
    torch.testing.assert_close(
        got, tss.sparse_scatter_block_update_plain(S.rows, S.vals, z, idx,
                                                   delta, **kw),
        rtol=1e-4, atol=1e-4)
    assert torch.equal(got, tss.sparse_scatter_block_update(
        S.rows, S.vals, z, idx, delta, **kw))
    # a non-finite δ in a column with a padding slot reaches row 0 (and
    # the column's own rows)
    zm = S.scatter_order().zmask
    col = int(torch.nonzero(zm[idx[-1]])[0])
    delta[-1, col] = float("nan")
    got = tss.sparse_scatter_block_update(S.rows, S.vals, z, idx, delta,
                                          **kw)
    want = tss.sparse_scatter_block_update_plain(S.rows, S.vals, z, idx,
                                                 delta, **kw)
    assert torch.isnan(got[0]) and torch.equal(torch.isnan(got),
                                               torch.isnan(want))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4,
                               equal_nan=True)


def _deep_tiles(dev, tile, n=2000, nblk=40, seed=0):
    """(nblk, tile, 128) tiles with columns of every depth up to ``tile``
    (distinct rows per column, padding slots after the stored ones)."""
    rng = np.random.default_rng(seed + tile)
    depth = rng.integers(0, tile + 1, (nblk, BLOCK))
    depth[0, :] = tile                                  # a full block
    rows = np.zeros((nblk, tile, BLOCK), np.int32)
    vals = np.zeros((nblk, tile, BLOCK), np.float32)
    for b in range(nblk):
        for c in range(BLOCK):
            m = int(depth[b, c])
            rows[b, :m, c] = np.sort(rng.choice(n, m, replace=False))
            vals[b, :m, c] = rng.standard_normal(m)
    return (torch.from_numpy(rows).to(dev), torch.from_numpy(vals).to(dev))


@pytest.mark.parametrize("K", [1, 8, 32])
@pytest.mark.parametrize("tile", [7, 8, 24, 64, 72])
def test_sparse_gather_split_matches_plain_and_repeats_bitwise(cuda, tile,
                                                               K):
    rows, vals = _deep_tiles(cuda, tile)
    g = torch.Generator(device=cuda).manual_seed(tile * 100 + K)
    r = torch.randn(2000, generator=g, device=cuda)
    idx = torch.randint(0, rows.shape[0], (K,), generator=g, device=cuda,
                        dtype=torch.int32)
    idx[0] = 0
    if K > 1:
        idx[-1] = idx[K // 2]                           # duplicate draw
    for v in (vals, vals.to(torch.bfloat16)):
        before = tss.LAUNCHES["sparse_gather_block_matvec"]
        got = tss.sparse_gather_block_matvec(rows, v, r, idx)
        assert tss.LAUNCHES["sparse_gather_block_matvec"] == before + 1
        torch.testing.assert_close(
            got, tss.sparse_gather_block_matvec_plain(rows, v, r, idx),
            rtol=1e-4, atol=1e-4)
        assert torch.equal(got, tss.sparse_gather_block_matvec(rows, v, r,
                                                               idx))


def test_sparse_scatter_is_one_launch_and_no_other_device_op(cuda):
    """Each scatter call enqueues one kernel launch and nothing else (no
    memset, copy or second kernel); the gather likewise.  Counted on the
    runtime calls that enqueue device work, seen by the profiler on the
    host: in the pytest process the profiler has returned fewer device
    records than launches, so the records only name the kernel."""
    from torch.profiler import ProfilerActivity, profile
    S = _padded_sparse(cuda, "f32")
    g = torch.Generator(device=cuda).manual_seed(3)
    idx = torch.randint(0, S.nblk, (8,), generator=g, device=cuda,
                        dtype=torch.int32)
    z = torch.randn(S.n, generator=g, device=cuda)
    delta = torch.randn(8, BLOCK, generator=g, device=cuda)
    kw = dict(order=S.scatter_order(), rstart=S.range_starts())
    calls = {"scatter_rows_kernel": lambda: tss.sparse_scatter_block_update(
                 S.rows, S.vals, z, idx, delta, **kw),
             "sparse_gather_split_kernel":
                 lambda: tss.sparse_gather_block_matvec(S.rows, S.vals, z,
                                                        idx)}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        enqueue = [e.name for e in prof.events() if e.name.startswith(
            ("cudaLaunch", "cudaMemcpy", "cudaMemset"))]
        assert enqueue == ["cudaLaunchKernel"] * 3, (name, enqueue)
        ev = [e.name for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(ev) <= 3 and all(name in e for e in ev), ev


def test_sparse_two_kernel_wrappers_raise_off_the_current_device(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    S = _padded_sparse(torch.device("cuda:1"), "f32")
    idx = torch.zeros(1, dtype=torch.int32, device=S.device)
    with pytest.raises(ValueError, match="current device"):
        tss.sparse_gather_block_matvec(S.rows, S.vals,
                                       torch.zeros(S.n, device=S.device), idx)


@pytest.mark.parametrize("tile", [None, 7])
@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("loss", ["lasso", "logistic", "logistic_newton"])
def test_fused_sparse_matches_plain_and_repeats_bitwise(cuda, loss, store,
                                                        tile):
    prob = _sparse(loss, cuda, tile=tile)
    S = prob.A.astype(torch.bfloat16) if store == "bf16" else prob.A
    x, z, idx = _sparse_inputs(S)
    for k_eff in (None, 2):
        args = (S.rows, S.vals, z, x, idx, prob.lam, prob.beta, prob.y)
        got = tss.fused_sparse_shotgun_rounds(*args, loss=loss, k_eff=k_eff,
                                              order=S.scatter_order())
        want = tss.fused_sparse_shotgun_rounds_plain(*args, loss=loss,
                                                     k_eff=k_eff)
        for u, v in zip(got[:3], want[:3]):
            torch.testing.assert_close(u, v, rtol=1e-4, atol=1e-4)
        assert torch.all((got[3] - want[3]).abs() <= 1)
        assert float(got[4]) == float(want[4]) == 0.0
        again = tss.fused_sparse_shotgun_rounds(*args, loss=loss,
                                                k_eff=k_eff)
        for u, v in zip(got, again):
            assert torch.equal(u, v)


def test_fused_sparse_invariants_on_card(cuda):
    prob = _sparse("logistic", cuda)
    S = prob.A
    x, z, idx = _sparse_inputs(S)
    args = (S.rows, S.vals, z, x, idx, prob.lam, prob.beta, prob.y)
    full = tss.fused_sparse_shotgun_rounds(*args, loss="logistic")
    same = tss.fused_sparse_shotgun_rounds(*args, loss="logistic",
                                           k_eff=torch.tensor(3, device=cuda))
    for u, v in zip(full, same):
        assert torch.equal(u, v)
    xo, zo, _, _, h = tss.fused_sparse_shotgun_rounds(*args, loss="logistic",
                                                      k_eff=0)
    assert torch.equal(xo, x) and torch.equal(zo, z) and float(h) == 0.0
    *_, h = tss.fused_sparse_shotgun_rounds(
        *args, loss="logistic", guard_f=full[2].min() * 0.5)
    assert float(h) == 1.0
    # a NaN iterate in a column with padding slots reaches z[0] (0·NaN)
    b, c = map(int, torch.nonzero(S.scatter_order().zmask)[0])
    xn = x.clone()
    xn[b * BLOCK + c] = float("nan")
    one = torch.tensor([[b]], dtype=torch.int32, device=cuda)
    xo, zo, _, _, h = tss.fused_sparse_shotgun_rounds(
        S.rows, S.vals, z, xn, one, prob.lam, prob.beta, prob.y,
        loss="logistic")
    assert float(h) == 1.0 and bool(torch.isnan(zo[0]))
    # the phase stamps: one per barrier (two a round), in order, then the
    # launch's ns times, outputs unchanged; the slot past them stays
    # unwritten
    R = idx.shape[0]
    stamps = torch.zeros(2 * R + 7, dtype=torch.int64, device=cuda)
    timed = tss.fused_sparse_shotgun_rounds(*args, loss="logistic",
                                            stamps=stamps)
    for u, v in zip(full, timed):
        assert torch.equal(u, v)
    st = stamps[:2 * R + 4]
    assert bool(torch.all(st[1:] >= st[:-1])) and int(st[0]) > 0
    ns = stamps[2 * R + 4:2 * R + 6]
    assert int(ns[1]) > int(ns[0]) > 0
    assert int(stamps[-1]) == 0


@pytest.mark.parametrize("fused", [True, False])
def test_sparse_solve_on_card_matches_cpu_and_counts_launches(cuda, fused):
    S, y, _ = tsyn.large_sparse(seed=3, n=1500, d=3000, density=0.01,
                                layout="bcsc")
    spec = SolverSpec(loss="lasso", P=512, rounds=16, fused=fused)
    rng = np.random.default_rng(0)
    idx = np.stack([rng.permutation(24)[:4] for _ in range(16)]).astype(
        np.int32)
    res = {}
    for dev in ("cpu", cuda):
        prob = tobj.make_problem(S, y, 1.0, device=dev)
        tss.reset_launches()
        res[str(dev)] = tops.block_shotgun_solve(prob, spec=spec,
                                                 blk_idx=idx)
        counts = dict(tss.LAUNCHES)
    assert counts == (
        {"fused_sparse_shotgun_rounds": 2, "sparse_gather_block_matvec": 0,
         "sparse_scatter_block_update": 0,
         "fused_sparse_shotgun_delta_rounds": 0} if fused else
        {"fused_sparse_shotgun_rounds": 0, "sparse_gather_block_matvec": 16,
         "sparse_scatter_block_update": 16,
         "fused_sparse_shotgun_delta_rounds": 0})
    cpu, gpu = res["cpu"], res["cuda"]
    torch.testing.assert_close(gpu.trace.objective.cpu(),
                               cpu.trace.objective, rtol=1e-4, atol=0)
    torch.testing.assert_close(gpu.x.cpu(), cpu.x, rtol=1e-4, atol=1e-4)
    assert int(gpu.status) == 0 and gpu.z.shape == (1500,)


@pytest.mark.parametrize("fused", [True, False])
def test_warm_started_sparse_solves_are_bit_identical(cuda, fused):
    """The warm-start margin z0 = A x0 is summed in a fixed order on the
    card (no float atomics), so two warm-started solves agree bit for
    bit."""
    S, y, _ = tsyn.large_sparse_bcsc_on_device(seed=4, n=3000, d=20000,
                                               density=0.002, device=cuda)
    prob = tobj.make_problem(S, y, 0.5, device=cuda)
    x0 = torch.randn(prob.d, generator=torch.Generator(cuda).manual_seed(1),
                     device=cuda) * 0.1
    spec = SolverSpec(loss="lasso", P=1024, rounds=16, fused=fused)
    runs = [tops.block_shotgun_solve(
        prob, torch.Generator(cuda).manual_seed(2), spec=spec, x0=x0)
        for _ in range(2)]
    assert torch.equal(runs[0].x, runs[1].x)
    assert torch.equal(runs[0].z, runs[1].z)
    assert torch.equal(runs[0].trace.objective, runs[1].trace.objective)
    assert torch.equal(prob.A.matvec(x0), prob.A.matvec(x0))


# ---------------------------------------------------------------------------
# Δz-emitting fused kernels (the sharded driver's engines)
# ---------------------------------------------------------------------------

def _delta_check(got, want, tol):
    torch.testing.assert_close(got[0], want[0], rtol=tol, atol=tol)
    torch.testing.assert_close(got[1], want[1], rtol=tol, atol=tol)
    assert float(got[2]) == float(want[2])


@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("loss", ["lasso", "logistic", "logistic_newton"])
def test_fused_delta_matches_plain_and_repeats_bitwise(cuda, loss, store):
    prob, Ap, yp, mask = _padded(loss, cuda)
    A = Ap.to(torch.bfloat16) if store == "bf16" else Ap
    x, z, idx = _inputs(A.float())
    tol = 1e-3 if store == "bf16" else 1e-4
    for k_eff in (None, 2):
        args = (A, z, x, idx, prob.lam, prob.beta, yp, mask)
        got = tsb.fused_shotgun_delta_rounds(*args, loss=loss, k_eff=k_eff)
        want = tsb.fused_shotgun_delta_rounds_plain(*args, loss=loss,
                                                    k_eff=k_eff)
        _delta_check(got, want, tol)
        assert float(got[2]) == 0.0
        again = tsb.fused_shotgun_delta_rounds(*args, loss=loss, k_eff=k_eff)
        assert all(torch.equal(u, v) for u, v in zip(got, again))
    xn = x.clone()
    xn[int(idx[0, 0]) * BLOCK + 5] = float("nan")
    args = (A, z, xn, idx, prob.lam, prob.beta, yp, mask)
    got = tsb.fused_shotgun_delta_rounds(*args, loss=loss)
    assert float(got[2]) == 1.0 == float(
        tsb.fused_shotgun_delta_rounds_plain(*args, loss=loss)[2])


@pytest.mark.parametrize("tile", [None, 7])
@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("loss", ["lasso", "logistic", "logistic_newton"])
def test_fused_sparse_delta_matches_plain_and_repeats_bitwise(cuda, loss,
                                                              store, tile):
    prob = _sparse(loss, cuda, tile=tile)
    S = prob.A.astype(torch.bfloat16) if store == "bf16" else prob.A
    x, z, idx = _sparse_inputs(S)
    od = S.scatter_order()
    for k_eff in (None, 2):
        args = (S.rows, S.vals, z, x, idx, prob.lam, prob.beta, prob.y)
        got = tss.fused_sparse_shotgun_delta_rounds(*args, loss=loss,
                                                    k_eff=k_eff, order=od)
        want = tss.fused_sparse_shotgun_delta_rounds_plain(*args, loss=loss,
                                                           k_eff=k_eff)
        _delta_check(got, want, 1e-4)
        assert float(got[2]) == 0.0
        again = tss.fused_sparse_shotgun_delta_rounds(*args, loss=loss,
                                                      k_eff=k_eff)
        assert all(torch.equal(u, v) for u, v in zip(got, again))
    # a NaN iterate in a column with padding slots reaches dz[0]
    b, c = map(int, torch.nonzero(od.zmask)[0])
    xn = x.clone()
    xn[b * BLOCK + c] = float("nan")
    one = torch.tensor([[b]], dtype=torch.int32, device=cuda)
    _, dz, h = tss.fused_sparse_shotgun_delta_rounds(
        S.rows, S.vals, z, xn, one, prob.lam, prob.beta, prob.y, loss=loss)
    assert float(h) == 1.0 and bool(torch.isnan(dz[0]))


@pytest.fixture
def nccl_rank(cuda, tmp_path):
    import torch.distributed as dist
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_one_rank_nccl_sharded_solve_matches_block_solve(cuda, nccl_rank,
                                                         kind):
    """merge="round" on one NCCL rank follows the fused block solve on the
    same draws, one delta-kernel launch per round."""
    if kind == "dense":
        A, y, _ = tsyn.sparco(seed=3, n=900, d=1000)
    else:
        A, y, _ = tsyn.large_sparse(seed=3, n=1500, d=3000, density=0.01,
                                    layout="bcsc")
    prob = tobj.make_problem(A, y, 5.0 if kind == "dense" else 1.0,
                             device=cuda)
    nblk = -(-prob.d // BLOCK)
    rng = np.random.default_rng(0)
    idx = np.stack([rng.permutation(nblk)[:2] for _ in range(16)]).astype(
        np.int32)
    ref = tops.block_shotgun_solve(
        prob, spec=SolverSpec(loss="lasso", P=256, rounds=16, fused=True),
        blk_idx=idx)
    tsb.reset_launches()
    tss.reset_launches()
    got = tsh.shotgun_sharded_solve(
        prob, spec=SolverSpec(loss="lasso", rounds=16, merge="round"),
        engine="sparse_fused" if kind == "sparse" else "fused", K=2,
        blk_idx=idx[None])
    name = ("fused_sparse_shotgun_delta_rounds" if kind == "sparse"
            else "fused_shotgun_delta_rounds")
    launches = (tss if kind == "sparse" else tsb).LAUNCHES[name]
    assert launches == 16
    torch.testing.assert_close(got.trace.objective, ref.trace.objective,
                               rtol=1e-4, atol=0)
    torch.testing.assert_close(got.x, ref.x, rtol=1e-4, atol=1e-4)
    assert int(got.status) == 0 and got.x.is_cuda


# ---------------------------------------------------------------------------
# Batched kernels (#9, #10) and the solver service
# ---------------------------------------------------------------------------

def _slot_scalars(prob, dev):
    """Per-slot λ and β ladders, k_eff all / some / none, and a guard that
    trips on slot 1 only."""
    inf = float("inf")
    return (prob.lam * torch.tensor([1.0, 2.0, 4.0], device=dev),
            prob.beta * torch.tensor([1.0, 1.5, 2.0], device=dev),
            torch.tensor([3.0, 2.0, 0.0], device=dev),
            torch.tensor([inf, 0.0, inf], device=dev))


def _check_batched(got, want, one_of, x, z, tol):
    """Batched kernel vs its plain version; slot s vs the unbatched kernel
    bit for bit; the frozen slot 2 returns its inputs; slot 1's guard."""
    for u, v in zip(got[:3], want[:3]):
        torch.testing.assert_close(u, v, rtol=tol, atol=tol)
    assert torch.all((got[3] - want[3]).abs() <= 1)
    assert got[4].tolist() == want[4].tolist() == [0.0, 1.0, 0.0]
    for s in range(3):
        assert all(torch.equal(a[s], b) for a, b in zip(got, one_of(s))), s
    assert torch.equal(got[0][2], x[2]) and torch.equal(got[1][2], z[2])


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("loss", ["lasso", "logistic", "logistic_newton"])
def test_batched_matches_plain_and_unbatched_bitwise(cuda, loss, store,
                                                     shared):
    padded = [_padded(loss, cuda, seed=s) for s in range(3)]
    prob = padded[0][0]
    A = torch.stack([p[1] for p in padded])
    A = A[0] if shared else A
    A = A.to(torch.bfloat16) if store == "bf16" else A
    y = torch.stack([p[2] for p in padded])
    mask = torch.stack([p[3] for p in padded])
    cols = [_inputs((A if shared else A[s]).float(), seed=10 + s)
            for s in range(3)]
    x, z, idx = (torch.stack(c) for c in zip(*cols))
    lam, beta, k_eff, guard = _slot_scalars(prob, cuda)
    args = (A, z, x, idx, lam, beta, y, mask, k_eff, guard)
    before = tkb.LAUNCHES["batched_fused_shotgun_rounds"]
    got = tkb.batched_fused_shotgun_rounds(*args, loss=loss,
                                           shared_design=shared)
    assert tkb.LAUNCHES["batched_fused_shotgun_rounds"] == before + 1
    want = tkb.batched_fused_shotgun_rounds_plain(*args, loss=loss,
                                                  shared_design=shared)
    _check_batched(got, want, lambda s: tsb.fused_shotgun_rounds(
        A if shared else A[s], z[s], x[s], idx[s], lam[s], beta[s], y[s],
        mask[s], loss=loss, k_eff=k_eff[s], guard_f=guard[s]), x, z,
        1e-3 if store == "bf16" else 1e-4)


def _stacked_tiles(probs, store):
    """(rows, vals, order) of BlockedCSC problems stacked on a slot axis,
    tiles padded to the deepest with (row 0, value 0) slots."""
    tile = max(p.A.tile for p in probs)
    pad = lambda t, p: torch.nn.functional.pad(  # noqa: E731
        t, (0, 0, 0, tile - p.A.tile))
    rows = torch.stack([pad(p.A.rows, p) for p in probs])
    vals = torch.stack([pad(p.A.vals, p) for p in probs])
    vals = vals.to(torch.bfloat16) if store == "bf16" else vals
    return rows, vals, tkb.stacked_scatter_order(rows, vals)


@pytest.mark.parametrize("tile", [None, 7])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("loss", ["lasso", "logistic", "logistic_newton"])
def test_batched_sparse_matches_plain_and_unbatched_bitwise(cuda, loss,
                                                            store, shared,
                                                            tile):
    probs = [_sparse(loss, cuda, seed=s, tile=tile) for s in range(3)]
    rows, vals, od = _stacked_tiles(probs, store)
    if shared:
        rows, vals = rows[0], vals[0]
        od = tss.scatter_order(rows, vals)
    y = torch.stack([p.y for p in probs])
    cols = [_sparse_inputs(probs[0 if shared else s].A, seed=10 + s)
            for s in range(3)]
    x, z, idx = (torch.stack(c) for c in zip(*cols))
    lam, beta, k_eff, guard = _slot_scalars(probs[0], cuda)
    args = (rows, vals, z, x, idx, lam, beta, y, k_eff, guard)
    before = tkb.LAUNCHES["batched_fused_sparse_shotgun_rounds"]
    got = tkb.batched_fused_sparse_shotgun_rounds(
        *args, loss=loss, shared_design=shared, order=od)
    assert tkb.LAUNCHES["batched_fused_sparse_shotgun_rounds"] == before + 1
    want = tkb.batched_fused_sparse_shotgun_rounds_plain(
        *args, loss=loss, shared_design=shared)

    def one(s):
        slot = (rows, vals) if shared else (rows[s], vals[s])
        return tss.fused_sparse_shotgun_rounds(
            *slot, z[s], x[s], idx[s], lam[s], beta[s], y[s], loss=loss,
            k_eff=k_eff[s], guard_f=guard[s],
            order=od if shared else tss.scatter_order(*slot))

    _check_batched(got, want, one, x, z, 1e-4)
    # the phase stamps: one per barrier (two a round), in order, then the
    # launch's ns times, outputs unchanged; the slot past them stays
    # unwritten
    R = idx.shape[1]
    stamps = torch.zeros(2 * R + 7, dtype=torch.int64, device=cuda)
    timed = tkb.batched_fused_sparse_shotgun_rounds(
        *args, loss=loss, shared_design=shared, order=od, stamps=stamps)
    assert all(torch.equal(u, v) for u, v in zip(got, timed))
    st = stamps[:2 * R + 4]
    assert bool(torch.all(st[1:] >= st[:-1])) and int(st[0]) > 0
    ns = stamps[2 * R + 4:2 * R + 6]
    assert int(ns[1]) > int(ns[0]) > 0
    assert int(stamps[-1]) == 0


def _fused_sparse_call(kernel, probs, x, z, idx, loss, k_eff=None):
    """(kernel, plain) outputs of #2 or #8 on probs[0], or of #10 on the
    stacked probs (x, z, idx stacked; k_eff a number or (S,) tensor), each
    with its cached layouts; #10 is also held slot by slot against #2."""
    if kernel in ("#2", "#8"):
        S = probs[0].A
        args = (S.rows, S.vals, z, x, idx, probs[0].lam, probs[0].beta,
                probs[0].y)
        kw = dict(loss=loss, k_eff=k_eff, order=S.scatter_order(),
                  rstart=S.range_starts())
        if kernel == "#2":
            return (tss.fused_sparse_shotgun_rounds(*args, **kw),
                    tss.fused_sparse_shotgun_rounds_plain(*args, loss=loss,
                                                          k_eff=k_eff))
        return (tss.fused_sparse_shotgun_delta_rounds(*args, **kw),
                tss.fused_sparse_shotgun_delta_rounds_plain(*args, loss=loss,
                                                            k_eff=k_eff))
    rows, vals, od = _stacked_tiles(probs, "f32")
    n, nS = probs[0].A.n, len(probs)
    rs = tkb.stacked_range_starts(rows, od, n)
    y = torch.stack([p.y for p in probs])
    k = torch.full((nS,), float(idx.shape[-1] if k_eff is None else k_eff),
                   device=x.device)
    lam = torch.stack([torch.as_tensor(p.lam, dtype=torch.float32,
                                       device=x.device) for p in probs])
    beta = torch.full((nS,), float(probs[0].beta), device=x.device)
    guard = torch.full((nS,), float("inf"), device=x.device)
    args = (rows, vals, z, x, idx, lam, beta, y, k, guard)
    got = tkb.batched_fused_sparse_shotgun_rounds(*args, loss=loss, order=od,
                                                  rstart=rs)
    for s in range(nS):
        one = tss.fused_sparse_shotgun_rounds(
            rows[s], vals[s], z[s], x[s], idx[s], lam[s], beta[s], y[s],
            loss=loss, k_eff=k[s], guard_f=guard[s],
            order=tss.scatter_order(rows[s], vals[s]), rstart=rs[s])
        assert all(torch.equal(_bits(a[s]), _bits(b))
                   for a, b in zip(got, one)), s
    return got, tkb.batched_fused_sparse_shotgun_rounds_plain(*args,
                                                              loss=loss)


def _bits(t):
    """An f32 tensor's bit patterns (equal also where both hold one NaN)."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _close_with_nan(got, want, tol):
    """Outputs agree to ``tol`` and are NaN at the same places."""
    for u, v in zip(got, want):
        if u.dtype == torch.float32:
            assert torch.equal(torch.isnan(u), torch.isnan(v))
            torch.testing.assert_close(u, v, rtol=tol, atol=tol,
                                       equal_nan=True)
        else:
            assert torch.all((u - v).abs() <= 1)


@pytest.mark.parametrize("K", [33, 72])
@pytest.mark.parametrize("kernel", ["#2", "#8", "#10"])
def test_fused_sparse_K_above_the_chunk_matches_plain(cuda, kernel, K):
    """K above the fused kernels' chunk of 32 drawn blocks (two and three
    chunks of the row-range sums), with a duplicate draw and k_eff < K, on
    94 column blocks."""
    probs = [_sparse("logistic", cuda, d=12000, seed=s) for s in range(2)]
    cols = [_sparse_inputs(p.A, K=K, seed=20 + s)
            for s, p in enumerate(probs)]
    for k_eff in (None, K - 5):
        if kernel == "#10":
            x, z, idx = (torch.stack(c) for c in zip(*cols))
        else:
            x, z, idx = cols[0]
        got, want = _fused_sparse_call(kernel, probs, x, z, idx, "logistic",
                                       k_eff)
        _close_with_nan(got, want, 1e-4)
        assert not any(bool(torch.isnan(t).any()) for t in got
                       if t.dtype == torch.float32)


@pytest.mark.parametrize("kernel", ["#2", "#8", "#10"])
def test_fused_sparse_nonfinite_delta_on_a_padded_block(cuda, kernel):
    """A NaN iterate in a column with a padding slot gives that column a
    NaN δ, whose 0·δ reaches row 0 through the padding terms: z (or Δz) is
    NaN at row 0 and at the column's rows, as in the plain version, and
    health trips; #10's other slot is untouched."""
    probs = [_sparse("logistic", cuda, seed=s) for s in range(2)]
    cols = [list(_sparse_inputs(p.A, R=1, K=4, seed=30 + s))
            for s, p in enumerate(probs)]
    S = probs[0].A
    b, c = map(int, torch.nonzero(S.scatter_order().zmask)[0])
    x0, _, idx0 = cols[0]
    x0[b * BLOCK + c] = float("nan")
    idx0[0, 1] = b
    if kernel == "#10":
        x, z, idx = (torch.stack(t) for t in zip(*cols))
    else:
        x, z, idx = cols[0]
    got, want = _fused_sparse_call(kernel, probs, x, z, idx, "logistic")
    _close_with_nan(got, want, 1e-4)
    out = got[1][0] if kernel == "#10" else got[1]
    assert bool(torch.isnan(out[0]))
    health = got[-1]
    if kernel == "#10":
        assert health.tolist() == [1.0, 0.0]
        assert not bool(torch.isnan(got[1][1]).any())
    else:
        assert float(health) == 1.0


@pytest.mark.parametrize("kernel", ["#2", "#8", "#10"])
def test_fused_sparse_call_is_one_launch_and_no_other_device_op(cuda, kernel):
    """With operands in the kernel's types and the cached layouts, a call
    is one cooperative launch and no other device operation: no (K, n)
    buffer or memset, and z, x and health are written by the launch itself.
    Counted on the runtime calls that enqueue device work; the device
    records are read only for the kernel's name: in this test process the
    profiler has returned one, and no, device record for three
    back-to-back cooperative launches (seen on the H100; a script alone
    gets three)."""
    from torch.profiler import ProfilerActivity, profile
    probs = [_sparse("lasso", cuda, seed=s) for s in range(2)]
    cols = [_sparse_inputs(p.A, seed=40 + s) for s, p in enumerate(probs)]
    S = probs[0].A
    kw = dict(loss="lasso", order=S.scatter_order(), rstart=S.range_starts())
    lam = torch.as_tensor(probs[0].lam, dtype=torch.float32, device=cuda)
    if kernel == "#10":
        x, z, idx = (torch.stack(t) for t in zip(*cols))
        y = torch.stack([probs[0].y] * 2)
        per = lambda v: torch.full((2,), v, device=cuda)  # noqa: E731
        args = (S.rows, S.vals, z, x, idx, lam.expand(2).contiguous(),
                per(1.0), y, per(3.0), per(float("inf")))
        fn = lambda: tkb.batched_fused_sparse_shotgun_rounds(  # noqa: E731
            *args, shared_design=True, **kw)
    else:
        x, z, idx = cols[0]
        args = (S.rows, S.vals, z, x, idx, lam, 1.0, probs[0].y)
        wrapper = (tss.fused_sparse_shotgun_rounds if kernel == "#2"
                   else tss.fused_sparse_shotgun_delta_rounds)
        fn = lambda: wrapper(*args, **kw)  # noqa: E731
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    enqueue = [e.name for e in prof.events()
               if e.name.startswith(("cudaLaunch", "cudaMemcpy", "cudaMemset"))]
    assert enqueue == ["cudaLaunchCooperativeKernel"] * 3, enqueue
    ev = [e.name for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(ev) <= 3 and all("fused_sparse_kernel" in e for e in ev), ev


def test_fused_sparse_wrappers_reject_a_wrong_rstart_on_card(cuda):
    prob = _sparse("lasso", cuda)
    S = prob.A
    x, z, idx = _sparse_inputs(S)
    rs = S.range_starts()
    args = (S.rows, S.vals, z, x, idx, prob.lam, prob.beta, prob.y)
    for bad in (rs[:, :-1].contiguous(), rs.long(), rs[None]):
        for fn in (tss.fused_sparse_shotgun_rounds,
                   tss.fused_sparse_shotgun_delta_rounds):
            with pytest.raises(ValueError, match="rstart"):
                fn(*args, order=S.scatter_order(), rstart=bad)
    st = lambda t: torch.stack([t, t])  # noqa: E731
    full = lambda v: torch.full((2,), float(v), device=cuda)  # noqa: E731
    bargs = (S.rows, S.vals, st(z), st(x), st(idx), full(prob.lam),
             full(prob.beta), st(prob.y), full(3), full(float("inf")))
    for shared, bad in ((True, st(rs)), (False, rs)):
        rows = S.rows if shared else st(S.rows)
        vals = S.vals if shared else st(S.vals)
        with pytest.raises(ValueError, match="rstart"):
            tkb.batched_fused_sparse_shotgun_rounds(
                rows, vals, *bargs[2:], shared_design=shared, rstart=bad)


@pytest.mark.parametrize("kind", ["dense", "bcsc"])
def test_served_stream_on_card_equals_sequential_queue(cuda, kind):
    if kind == "dense":
        # the service CLI's default shape and λ: P = 128 stays under P*
        # for every draw (at 192 x 384, λ = 2 some draws diverge)
        reqs = tserve.make_stream(256, 512, requests=6, lam=4.0,
                                  device=cuda)
        K = 1
    else:
        probs = [_sparse("lasso", cuda, seed=s) for s in range(2)]
        reqs = [tserve.SolveRequest(rid=i, problem_id=None,
                                    prob=probs[i % 2]._replace(
                                        lam=probs[0].lam * (1 + 0.5 * i)),
                                    seed=1000 + i) for i in range(6)]
        K = 1         # P = 128 under these designs' P* ≈ 170
    for r in reqs:
        r.problem_id = ("solo", r.rid)
    kw = dict(K=K, max_rounds=24, rounds_per_launch=8, tol=1e-4, device=cuda)

    def clone():
        return [tserve.SolveRequest(rid=r.rid, problem_id=r.problem_id,
                                    prob=r.prob, seed=r.seed) for r in reqs]

    name = ("batched_fused_shotgun_rounds" if kind == "dense"
            else "batched_fused_sparse_shotgun_rounds")
    tkb.reset_launches()
    svc = tserve.SolverService(tcb.batch_meta_of(reqs[0].prob), slots=3,
                               cache=tcb.WarmStartCache(), **kw)
    served = {r.rid: r for r in svc.serve(clone())}
    assert tkb.LAUNCHES[name] == svc.launch_count > 0
    seq = {r.rid: r for r in tserve.solve_queue_sequential(
        clone(), cache=tcb.WarmStartCache(), **kw)}
    for rid, a in served.items():
        b = seq[rid]
        assert a.status == b.status == "ok", rid
        assert a.rounds_used == b.rounds_used, rid
        assert torch.equal(a.x, b.x), rid


class _HostCache(tcb.WarmStartCache):
    """A warm-start cache whose entries are forced to host numpy."""

    def put(self, problem_id, lam, x, loss="lasso"):
        super().put(problem_id, lam, x.cpu().numpy(), loss=loss)


def _host_copies(prof, tmp_path, nbytes):
    """The device's copies between the host and the card of ``nbytes``
    bytes in a profiled window (read from its exported trace, where each
    copy carries its size)."""
    import json
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e["name"] for e in events
            if e.get("cat") == "gpu_memcpy"
            and ("DtoH" in e["name"] or "HtoD" in e["name"])
            and e.get("args", {}).get("bytes") == nbytes]


def test_served_warm_starts_stay_on_card_and_equal_a_host_cache(cuda,
                                                                 tmp_path):
    """A λ-grid job over two BlockedCSC designs, repeated so that warm
    starts hit: served with the card-resident cache it gives the same bits
    (x, f, rounds, warm verdicts) as with a cache forced to host numpy,
    copies no x between the card and the host, and its entries are copies
    that a caller writing into its answers leaves alone."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    probs = [_sparse("lasso", cuda, seed=s) for s in range(2)]
    grid = (1.0, 1.5)

    def job():
        return [tserve.SolveRequest(
            rid=i, problem_id=("d", i % 2),
            prob=probs[i % 2]._replace(lam=probs[0].lam * grid[i // 2 % 2]),
            seed=2000 + i) for i in range(8)]

    kw = dict(slots=2, K=1, max_rounds=24, rounds_per_launch=8, tol=1e-4,
              device=cuda)
    meta = tcb.batch_meta_of(probs[0])
    caches = {"host": _HostCache(), "card": tcb.WarmStartCache()}
    runs, copies, counted = {}, {}, {}
    for name, cache in caches.items():
        svc = tserve.SolverService(meta, cache=cache, **kw)
        obs.reset()
        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                runs[name] = {r.rid: r for r in svc.serve(job())}
                torch.cuda.synchronize()
            counted[name] = obs.totals()["counters"]["serve.cache_host_bytes"]
        finally:
            obs.reset()
        copies[name] = _host_copies(prof, tmp_path, probs[0].d * 4)
    warm = [runs["card"][i].warm for i in range(8)]
    assert sum(w in ("exact", "near") for w in warm) >= 2, warm
    for rid, a in runs["card"].items():
        b = runs["host"][rid]
        assert a.status == b.status == "ok", rid
        assert (a.f_final, a.rounds_used, a.warm) == (
            b.f_final, b.rounds_used, b.warm), rid
        assert torch.equal(a.x.view(torch.int32), b.x.view(torch.int32)), rid
    assert counted["card"] == 0 and counted["host"] > 0
    assert copies["card"] == [] and copies["host"], copies
    cache = caches["card"]
    kept = {}
    for r in runs["card"].values():
        key = (r.problem_id, float(r.prob.lam))
        entry, kind = cache.get(*key)
        assert kind == "exact" and entry.device.type == "cuda"
        kept[key] = entry.clone()
    for r in runs["card"].values():
        r.x.fill_(float("nan"))
    for key, entry in kept.items():
        assert torch.equal(cache.get(*key)[0], entry), key


# ---------------------------------------------------------------------------
# The scalar family, CDN and the λ-path on the card (torch code, no kernel
# of their own; the block_fused path launches the fused kernels)
# ---------------------------------------------------------------------------

def _scalar_problem(layout, loss, dev, n=600, d=1500, seed=3):
    if layout == "bcsc":
        return _sparse(loss, dev, n=n, d=d, seed=seed)
    A, y, _ = (tsyn.sparco(seed=seed, n=n, d=d) if loss == "lasso"
               else tsyn.logistic_data(seed=seed, n=n, d=d))
    return tobj.make_problem(A, y, 0.3 if loss == "lasso" else 0.5,
                             loss=loss, device=dev)


def _on_cpu(prob):
    return prob._replace(A=prob.A.to("cpu"), y=prob.y.cpu(),
                         lam=prob.lam.cpu(),
                         scales=None if prob.scales is None
                         else prob.scales.cpu())


def _assert_card_matches_cpu(a, b):
    torch.testing.assert_close(a.trace.objective.cpu(), b.trace.objective,
                               rtol=1e-4, atol=0.0)
    assert int((a.trace.nnz.cpu() - b.trace.nnz).abs().max()) <= 2
    torch.testing.assert_close(a.x.cpu(), b.x, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layout,loss", [("dense", "lasso"),
                                         ("dense", "logistic"),
                                         ("bcsc", "lasso")])
def test_scalar_shotgun_on_card_matches_cpu(cuda, layout, loss):
    from repro_torch.core import shotgun as tshot
    prob = _scalar_problem(layout, loss, cuda)
    idx = torch.randint(0, prob.d, (40, 64),
                        generator=torch.Generator().manual_seed(0))
    spec = SolverSpec(loss=loss, P=64, rounds=40)
    a = tshot.shotgun_solve(prob, spec=spec, idx=idx.to(cuda))
    b = tshot.shotgun_solve(_on_cpu(prob), spec=spec, idx=idx)
    _assert_card_matches_cpu(a, b)


@pytest.mark.parametrize("layout", ["dense", "bcsc"])
def test_scalar_shotgun_repeat_on_card_is_bit_identical(cuda, layout):
    """Duplicate draws in every round, and (BlockedCSC) many drawn columns
    on one row: the fixed-order scatter gives the same bits."""
    from repro_torch.core import shotgun as tshot
    prob = _scalar_problem(layout, "lasso", cuda, d=300)
    idx = torch.randint(0, prob.d, (30, 256), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
    s = idx.sort(dim=1).values
    assert bool((s[:, 1:] == s[:, :-1]).any(dim=1).all())
    spec = SolverSpec(P=256, rounds=30)
    a, b = (tshot.shotgun_solve(prob, spec=spec, idx=idx) for _ in range(2))
    for u, v in ((a.x, b.x), (a.z, b.z), (a.trace.objective,
                                          b.trace.objective)):
        assert torch.equal(u.view(torch.int32), v.view(torch.int32))
    g = [torch.Generator(device=cuda).manual_seed(5) for _ in range(2)]
    c, d = (tshot.shotgun_solve(prob, gg, spec=spec) for gg in g)
    assert torch.equal(c.x.view(torch.int32), d.x.view(torch.int32))


def test_cdn_on_card_matches_cpu(cuda):
    from repro_torch.core import cdn as tcdn
    prob = _scalar_problem("dense", "logistic", cuda, d=400)
    idx = torch.randint(0, prob.d, (40, 8),
                        generator=torch.Generator().manual_seed(2))
    kw = dict(P=8, rounds=40, active_set=False)
    a = tcdn.shotgun_cdn_solve(prob, idx=idx.to(cuda), **kw)
    b = tcdn.shotgun_cdn_solve(_on_cpu(prob), idx=idx, **kw)
    _assert_card_matches_cpu(a, b)
    e = [tcdn.shotgun_cdn_solve(prob, torch.Generator(
        device=cuda).manual_seed(3), P=8, rounds=40) for _ in range(2)]
    assert torch.equal(e[0].x, e[1].x)


@pytest.mark.parametrize("layout", ["dense", "bcsc"])
def test_unguarded_scalar_rounds_make_no_host_sync(cuda, layout):
    """Inside the rounds of an unguarded solve, counted on the runtime
    calls and operators that wait on the card: none; and no copy from the
    card anywhere in a solve whose draws come from a card generator."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import shotgun as tshot
    prob = _scalar_problem(layout, "lasso", cuda)
    spec = SolverSpec(P=64, rounds=20)

    def fn():
        return tshot.shotgun_solve(
            prob, torch.Generator(device=cuda).manual_seed(0), spec=spec)

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cpu = torch.autograd.DeviceType.CPU
    ev = prof.events()
    ranges = [e.time_range for e in ev if e.name == tshot.ROUNDS_RANGE
              and e.device_type == cpu]
    assert len(ranges) == 1
    r = ranges[0]
    waits = [e.name for e in ev if e.device_type == cpu
             and r.start <= e.time_range.start <= r.end
             and (e.name.endswith("Synchronize") or e.name in (
                 "cudaMemcpy", "aten::item", "aten::_local_scalar_dense"))]
    assert waits == []
    assert not [e.name for e in ev if "DtoH" in e.name]


def test_block_fused_path_on_card_launches_and_hits_the_cache(cuda):
    from repro_torch.core import path as tpath
    from repro_torch.core.batched import WarmStartCache
    prob = _sparse("lasso", cuda)
    cache = WarmStartCache()
    kw = dict(lam_target=float(prob.lam), spec=SolverSpec(P=BLOCK, rounds=32),
              num_lambdas=4, solver="block_fused", cache=cache,
              problem_id="p", validate_p=False)
    sweeps = []
    for seed in range(2):
        tss.reset_launches()
        res = tpath.solve_path(
            prob, torch.Generator(device=cuda).manual_seed(seed), **kw)
        launches = tss.LAUNCHES["fused_sparse_shotgun_rounds"]
        assert launches == int(res.rounds.sum()) // 8 > 0
        assert sum(tss.LAUNCHES.values()) == launches
        sweeps.append(res)
    assert cache.stats.hits_exact == 4
    assert int(sweeps[1].rounds.sum()) <= int(sweeps[0].rounds.sum())
    assert np.all(np.isfinite(sweeps[1].objectives))


def test_path_cache_keeps_entries_on_card_and_equals_a_host_cache(cuda):
    """``solve_path(cache=)`` on the card stores each λ's x on the card;
    two sweeps give the same x, rounds and objectives, bit for bit, as the
    same sweeps with a cache forced to host numpy."""
    from repro_torch.core import path as tpath
    prob = _sparse("lasso", cuda)
    kw = dict(lam_target=float(prob.lam), spec=SolverSpec(P=BLOCK, rounds=32),
              num_lambdas=4, solver="block_fused", problem_id="p",
              validate_p=False)
    sweeps = {}
    for name, cache in (("card", tcb.WarmStartCache()), ("host", _HostCache())):
        sweeps[name] = [tpath.solve_path(
            prob, torch.Generator(device=cuda).manual_seed(seed), cache=cache,
            **kw) for seed in range(2)]
        assert cache.stats.hits_exact == 4
        if name == "card":
            for lam in sweeps[name][0].lambdas:
                entry, kind = cache.get("p", float(lam))
                assert kind == "exact" and entry.device.type == "cuda"
    for a, b in zip(sweeps["card"], sweeps["host"]):
        assert torch.equal(a.x.view(torch.int32), b.x.view(torch.int32))
        np.testing.assert_array_equal(a.rounds, b.rounds)
        np.testing.assert_array_equal(a.objectives, b.objectives)


# ---------------------------------------------------------------------------
# The dense two-kernel pair (#3, #4): one device record a call, parity and
# repeats at K = 1, K = 72 with duplicates and ragged chunks, two streams,
# the in-kernel δ rounding, and the current-device rule
# ---------------------------------------------------------------------------

def _dense_pair_inputs(dev, n, d, K, seed, dup=True):
    g = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn(n, d, generator=g, device=dev)
    idx = torch.randint(0, d // BLOCK, (K,), generator=g, device=dev,
                        dtype=torch.int32)
    if dup and K > 1:
        idx[-1] = idx[0]
        idx[K // 2] = idx[0]
    r = torch.randn(n, generator=g, device=dev)
    delta = torch.randn(K, BLOCK, generator=g, device=dev) * 0.1
    return A, idx, r, delta


@pytest.mark.parametrize("store", ["f32", "bf16"])
def test_dense_pair_is_one_launch_and_no_other_device_op(cuda, store):
    """Each call of #3 and of #4 enqueues one kernel launch and nothing
    else: no second pass, rounding kernel, memset or copy (the runtime
    calls that enqueue device work, seen by the profiler on the host).  In
    the pytest process the profiler has returned fewer device records than
    launches, and none at all in one run, so the records are not read
    here; ``chip_smoke.py`` and ``compare_dense`` count them, one a call."""
    from torch.profiler import ProfilerActivity, profile
    A, idx, r, delta = _dense_pair_inputs(cuda, 16384, 4096, 8, 3)
    if store == "bf16":
        A = A.to(torch.bfloat16)
    calls = (lambda: tsb.gather_block_matvec(A, r, idx),
             lambda: tsb.scatter_block_update(A, r, idx, delta))
    for fn in calls:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        enqueue = [e.name for e in prof.events() if e.name.startswith(
            ("cudaLaunch", "cudaMemcpy", "cudaMemset"))]
        assert enqueue == ["cudaLaunchKernel"] * 3, enqueue


@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("n,d,K", [(16384, 4096, 1), (4096, 4096, 72),
                                   (10240, 2048, 5), (512, 256, 3)])
def test_dense_pair_matches_plain_and_repeats_bitwise(cuda, n, d, K, store):
    """K = 1, 72 draws with duplicates, and shapes whose row chunks are
    ragged (10240 rows, and 512 rows in chunks of 8): the plain version's
    values, and the same bits on a repeat."""
    A, idx, r, delta = _dense_pair_inputs(cuda, n, d, K, n + K)
    if store == "bf16":
        A = A.to(torch.bfloat16)
    tol = 1e-3 if store == "bf16" else 1e-4
    before = dict(tsb.LAUNCHES)
    g = tsb.gather_block_matvec(A, r, idx)
    z = tsb.scatter_block_update(A, r, idx, delta)
    assert tsb.LAUNCHES["gather_block_matvec"] == \
        before["gather_block_matvec"] + 1
    assert tsb.LAUNCHES["scatter_block_update"] == \
        before["scatter_block_update"] + 1
    torch.testing.assert_close(g, tsb.gather_block_matvec_plain(A, r, idx),
                               rtol=tol, atol=tol)
    torch.testing.assert_close(
        z, tsb.scatter_block_update_plain(A, r, idx, delta), rtol=tol,
        atol=tol)
    assert torch.equal(g.view(torch.int32),
                       tsb.gather_block_matvec(A, r, idx).view(torch.int32))
    assert torch.equal(z.view(torch.int32), tsb.scatter_block_update(
        A, r, idx, delta).view(torch.int32))


def test_dense_gather_on_two_streams_at_once_keeps_its_bits(cuda):
    """Two gathers queued on two streams behind one spin run at once; each
    gives the bits of a call alone (the in-launch reduction's tickets are
    per stream)."""
    A, idx, r, _ = _dense_pair_inputs(cuda, 16384, 4096, 8, 5, dup=False)
    _, idx2, r2, _ = _dense_pair_inputs(cuda, 16384, 4096, 8, 6, dup=False)
    want = [tsb.gather_block_matvec(A, r, idx),
            tsb.gather_block_matvec(A, r2, idx2)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)
        got = []
        for s, (rr, ii) in zip(streams, ((r, idx), (r2, idx2))):
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                got.append(tsb.gather_block_matvec(A, rr, ii))
        torch.cuda.synchronize()
        for u, v in zip(got, want):
            assert torch.equal(u.view(torch.int32), v.view(torch.int32))


def test_dense_scatter_rounds_delta_to_bf16_in_the_kernel(cuda):
    """At bf16 A the kernel rounds δ itself: the bits of a call given δ
    rounded beforehand (as the plain version rounds it), and the plain
    version's values."""
    A, idx, r, delta = _dense_pair_inputs(cuda, 16384, 4096, 8, 7)
    A16 = A.to(torch.bfloat16)
    delta = delta * (1.0 + 2.0 ** -12)            # bits below bf16's
    got = tsb.scatter_block_update(A16, r, idx, delta)
    pre = tsb.scatter_block_update(A16, r, idx,
                                   delta.to(torch.bfloat16).float())
    assert torch.equal(got.view(torch.int32), pre.view(torch.int32))
    torch.testing.assert_close(
        got, tsb.scatter_block_update_plain(A16, r, idx, delta), rtol=1e-3,
        atol=1e-3)
    assert not torch.equal(got, tsb.scatter_block_update(A, r, idx, delta))


def test_dense_pair_wrappers_raise_off_the_current_device(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    A, idx, r, delta = _dense_pair_inputs(torch.device("cuda:1"), 512, 256,
                                          2, 8)
    with pytest.raises(ValueError, match="current device"):
        tsb.gather_block_matvec(A, r, idx)
    with pytest.raises(ValueError, match="current device"):
        tsb.scatter_block_update(A, r, idx, delta)


# ---------------------------------------------------------------------------
# The baselines (``repro_torch.core.baselines``) on the card
# ---------------------------------------------------------------------------

BASELINES = ["fista", "sparsa", "l1_ls", "sgd", "smidas"]


def _baseline_problem(name, dev):
    loss = "logistic" if name in ("sgd", "smidas") else "lasso"
    return _scalar_problem("dense", loss, dev, n=400, d=700)


def _baseline(name, prob, L=None, idx=None, generator=None):
    """The first iterations of baseline ``name``: the same L / draws on
    every device when given.  SpaRSA's nonmonotone BB steps and SMIDAS's
    link (|θ|^(q−1) with q − 1 ≈ 0.08 lifts a rounding difference in a
    tiny θ_j to a visible one in x_j) amplify the card's and the CPU's
    rounding differences to rel 1e-3 within 40 iterations and 200 steps,
    so they are held over 20 iterations and 100 steps (F every 20)."""
    from repro_torch.core import baselines as tbl
    if name == "fista":
        return tbl.fista_solve(prob, 40, L=L)
    if name == "sparsa":
        return tbl.sparsa_solve(prob, 20)
    if name == "l1_ls":
        return tbl.l1_ls_solve(prob, outer=3)
    if name == "sgd":
        return tbl.sgd_solve(prob, generator, 0.5, 500, idx=idx)
    return tbl.smidas_solve(prob, generator, 0.005, 100, 20,
                            idx=None if idx is None else idx[:100])


@pytest.mark.parametrize("name", BASELINES)
def test_baseline_on_card_matches_cpu(cuda, name):
    """F traces rtol 1e-4 and x atol 1e-5 of max(1, ‖x‖∞) (SMIDAS: its
    iterate θ; L1_LS, whose CG early stop and line search may branch on
    rounding: the last F, rtol 1e-3), on the same L and the same draws."""
    from repro_torch.core.baselines import common
    prob = _baseline_problem(name, cuda)
    cpu = _on_cpu(prob)
    L = common.lipschitz(cpu)
    idx = torch.randint(0, prob.n, (500,),
                        generator=torch.Generator().manual_seed(4))
    a = _baseline(name, prob, L=L, idx=idx)
    b = _baseline(name, cpu, L=L, idx=idx)
    if name == "l1_ls":
        torch.testing.assert_close(a.objective[-1].cpu(), b.objective[-1],
                                   rtol=1e-3, atol=0.0)
        return
    torch.testing.assert_close(a.objective.cpu(), b.objective, rtol=1e-4,
                               atol=0.0)
    xa, xb = a.x.cpu(), b.x
    if name == "smidas":
        # x = f⁻¹(θ) lifts a rounding-level difference in a tiny θ_j (the
        # truncation's cancellation) to a visible one in x_j (|θ_j|^(q−1),
        # q − 1 ≈ 0.08): hold SMIDAS's iterate θ = f(x), the p-norm link
        from repro_torch.core.baselines import smidas
        q = float(smidas.link_q(prob.d, "cpu"))
        p = q / (q - 1.0)

        def link(x):
            x = x.double()
            return (torch.sign(x) * x.abs() ** (p - 1.0)
                    / torch.linalg.vector_norm(x, p) ** (p - 2.0))

        xa, xb = link(xa), link(xb)
    torch.testing.assert_close(
        xa, xb, rtol=0.0, atol=1e-5 * max(1.0, float(xb.abs().max())))


@pytest.mark.parametrize("name", BASELINES)
def test_baseline_repeat_on_card_is_bit_identical(cuda, name):
    prob = _baseline_problem(name, cuda)
    a, b = (_baseline(name, prob, generator=torch.Generator(
        device=cuda).manual_seed(6)) for _ in range(2))
    assert torch.equal(a.x.view(torch.int32), b.x.view(torch.int32))
    assert torch.equal(a.objective.view(torch.int32),
                       b.objective.view(torch.int32))


def _host_waits(fn, range_name):
    """The runtime calls and operators that wait on the card inside the
    profiler range ``range_name`` of one call of ``fn``, the number of
    such ranges, and the device-to-host copies anywhere in it (counted on
    the host's records: in this process the profiler has returned fewer
    device records than launches)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.analyze.trace_checks import is_sync
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cpu = torch.autograd.DeviceType.CPU
    ev = prof.events()
    ranges = [e.time_range for e in ev if e.name == range_name
              and e.device_type == cpu]
    waits = [e.name for e in ev if e.device_type == cpu
             and any(r.start <= e.time_range.start <= r.end for r in ranges)
             and is_sync(e.name)]
    return waits, len(ranges), [e.name for e in ev if "DtoH" in e.name]


@pytest.mark.parametrize("name", BASELINES)
def test_baseline_iterations_make_no_host_sync(cuda, name):
    """Inside a baseline's iterations (SGD and SMIDAS: every chunk), no
    call waits on the card, and no copy from the card anywhere in a solve
    whose L and draws come from the card."""
    from repro_torch.core.baselines import common
    prob = _baseline_problem(name, cuda)
    waits, n_ranges, dtoh = _host_waits(lambda: _baseline(
        name, prob, generator=torch.Generator(device=cuda).manual_seed(7)),
        common.ITERS_RANGE)
    assert (waits, n_ranges, dtoh) == ([], 1, [])


def test_cdn_rounds_make_no_host_sync(cuda):
    """The batched Armijo step picks its trial on the device
    (``objectives.take``), with the active set's draws from the card."""
    from repro_torch.core import cdn as tcdn
    from repro_torch.core import shotgun as tshot
    prob = _scalar_problem("dense", "logistic", cuda, d=400)
    waits, n_ranges, dtoh = _host_waits(lambda: tcdn.shotgun_cdn_solve(
        prob, torch.Generator(device=cuda).manual_seed(8), P=8, rounds=20),
        tshot.ROUNDS_RANGE)
    assert (waits, n_ranges, dtoh) == ([], 1, [])


def test_lint_resource_budget_of_the_build(cuda):
    """SL101 over the library built from this checkout: every compiled
    instantiation's spills and shared memory, from the build's own report,
    give no finding outside the port's allowlist and leave no SL101 entry
    of it stale."""
    import pathlib

    from repro_torch.analyze import render_report, runner
    from repro_torch.analyze.trace_checks import parse_ptxas
    from repro_torch.kernels import _build
    report = runner.run_checkers(pathlib.Path(__file__).resolve().parents[1],
                                 rules=["SL101"])
    assert report.ok, render_report(report.findings)
    assert report.unused_allows == []
    assert any(u.registers > 0
               for u in parse_ptxas(_build.build_info["ptxas"]).values())


def test_lint_repeat_calls_leave_the_caches_alone_on_the_card(cuda):
    """SL102 on the card: each registry solver and baseline called twice
    at a tiny size adds no entry to the wrappers' per-device caches, loads
    the library once, syncs nowhere inside its rounds and repeats bit for
    bit; the two-kernel pair's caches were exercised."""
    from repro_torch.analyze import render_report
    from repro_torch.analyze.trace_checks import check_repeat, repeat_targets
    findings = check_repeat(None, targets=repeat_targets(cuda))
    assert findings == [], render_report(findings)
    assert tsb._SLOTS and tsb._WORK


# ---------------------------------------------------------------------------
# The LM serving path (repro_torch.launch.serve, repro_torch.models)
# ---------------------------------------------------------------------------

def _lm_smoke():
    from repro_torch.configs import ARCHS
    return ARCHS["qwen3-4b"].smoke_config()


def test_lm_serve_on_card_matches_cpu_with_and_without_eviction(cuda):
    """Smoke-size qwen3-4b at f32 on the same weights: the card serves the
    CPU's token streams token for token, and a stream evicted every three
    steps (re-prefilled into the next free slot) serves them too."""
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as TM
    params = TM.init(_lm_smoke(), torch.Generator().manual_seed(1))
    kw = dict(requests=5, batch=2, max_new=8, prompt_len=5, max_len=48,
              quiet=True, seed=1, max_evictions=10)

    def streams(device, **extra):
        reqs = serve("qwen3-4b", params=TM.to_device(params, device),
                     device=device, **kw, **extra)
        return {r.rid: r.out for r in reqs}, [r.evictions for r in reqs]

    cpu, _ = streams("cpu")
    card, _ = streams(cuda)
    evicted, evictions = streams(cuda, max_rounds=3)
    assert card == cpu
    assert any(evictions) and evicted == cpu


def test_lm_refill_no_warm_state_leak_on_card(cuda):
    """A request admitted into a slot heavy with another's KV generates
    what it generates in a fresh engine."""
    from repro_torch.launch.serve import Engine, Request
    cfg = _lm_smoke()
    rng = np.random.default_rng(4)
    prompt_a = rng.integers(1, cfg.vocab_size, 12, dtype=np.int32)
    prompt_b = rng.integers(1, cfg.vocab_size, 4, dtype=np.int32)

    def run_b(engine):
        rb = Request(9, prompt_b.copy(), 6)
        engine.admit(rb, 0)
        while not rb.done:
            engine.step()
        return rb.out

    warm = Engine(cfg, batch=2, max_len=32, seed=0, device=cuda)
    warm.admit(Request(0, prompt_a, 8), 0)
    for _ in range(4):
        warm.step()
    assert run_b(warm) == run_b(Engine(cfg, batch=2, max_len=32, seed=0,
                                       device=cuda))


def test_lm_full_width_bf16_forward_matches_f32(cuda):
    """Qwen3-4B at its published widths, cut to 2 layers: the bf16 forward
    (weights as their bf16 copies) within 2e-2 of the f32 forward's
    largest logit."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models import model as TM
    cfg = dataclasses.replace(ARCHS["qwen3-4b"].CONFIG, num_layers=2)
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32,
                              cache_dtype=torch.float32)
    g = torch.Generator(cuda).manual_seed(0)
    params = TM.init(cfg, g)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=g,
                         device=cuda)
    want, _ = TM.forward(f32, params, {"tokens": toks})
    got, _ = TM.forward(cfg, TM.cast_weights(params, torch.bfloat16),
                        {"tokens": toks})
    assert got.dtype == torch.bfloat16
    err = float((got.float() - want).abs().max() / want.abs().max())
    assert err <= 2e-2, err


def test_lm_path_reduces_bf16_products_in_f32(cuda, monkeypatch):
    """cuBLAS's reduced-precision bf16 reduction is off at every product of
    the LM path, even when the process had it on."""
    import dataclasses

    from repro_torch.launch.serve import Engine, Request
    from repro_torch.models import layers as TL
    seen, real = [], TL.matmul

    def spy(x, w, dtype):
        seen.append(
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
        return real(x, w, dtype)

    monkeypatch.setattr(TL, "matmul", spy)
    cfg = dataclasses.replace(_lm_smoke(), compute_dtype=torch.bfloat16,
                              cache_dtype=torch.bfloat16)
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    try:
        eng = Engine(cfg, batch=2, max_len=32, device=cuda)
        eng.admit(Request(0, np.arange(1, 6, dtype=np.int32), 4), 0)
        eng.step()
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            flag
    assert seen and not any(seen)


# ---------------------------------------------------------------------------
# The remaining LM families: MLA, MoE, Mamba-2, Jamba, the Whisper encoder
# ---------------------------------------------------------------------------

LM_FAMILIES = ["minicpm3-4b", "granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b",
               "mamba2-2.7b", "jamba-1.5-large-398b", "whisper-large-v3"]


def _family_logits(cfg, params, toks, frames, dev):
    """A 12-token prefill and four per-slot decode steps' logits, float32
    on the host."""
    from repro_torch.models import model as TM
    toks = toks.to(dev)
    batch = {"tokens": toks[:, :12]}
    if frames is not None:
        batch["enc_frames"] = frames.to(dev)
    logits, cache = TM.forward(cfg, TM.to_device(params, dev), batch,
                               make_cache_len=20)
    outs = [logits]
    for t in range(12, 16):
        pos = torch.tensor([[t], [t - 3]], device=dev)
        lg, cache = TM.decode_step(cfg, TM.to_device(params, dev),
                                   toks[:, t:t + 1], cache, pos)
        outs.append(lg)
    return torch.cat(outs, 1).float().cpu()


def _routed(monkeypatch, picks=None):
    """``models.moe._route`` recording each call's expert picks into the
    returned list, or taking them from ``picks`` (the router's own
    probabilities gathered at them): a top-k flips at a near-tie with the
    last bit of a bf16 product, which the card's and the CPU's BLAS round
    apart, so bf16 logits are compared on one side's picks."""
    from repro_torch.models import moe as tmoe
    seen = []
    real = getattr(tmoe._route, "__wrapped__", tmoe._route)

    def route(p, xt, cfg):
        if picks is None:
            vals, idx = real(p, xt, cfg)
        else:
            idx = picks[len(seen)].to(xt.device)
            probs = torch.softmax(torch.matmul(xt.float(),
                                               p["router"].float()), -1)
            vals = torch.gather(probs, -1, idx)
            vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
        seen.append(idx.cpu())
        return vals, idx
    route.__wrapped__ = real
    monkeypatch.setattr(tmoe, "_route", route)
    return seen


def _layer_io(monkeypatch, feed=None):
    """``models.model._apply_layer`` recording each call's input and
    output hidden states (float32, on the host), or running each call on
    ``feed``'s recorded input in place of its own."""
    from repro_torch.models import model as TM
    ins, outs = [], []
    real = getattr(TM._apply_layer, "__wrapped__", TM._apply_layer)

    def apply(cfg, spec, p, h, *args, **kw):
        if feed is not None:
            h = feed[len(outs)].to(h.device, h.dtype)
        ins.append(h.cpu())
        out = real(cfg, spec, p, h, *args, **kw)
        outs.append(out[0].float().cpu())
        return out
    apply.__wrapped__ = real
    monkeypatch.setattr(TM, "_apply_layer", apply)
    return ins, outs


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", LM_FAMILIES)
def test_lm_family_on_card_matches_cpu(cuda, arch, dtype, monkeypatch):
    """Each family at the smoke size on the same weights and tokens.  f32:
    the card's prefill and decode logits within 1e-4 of the CPU's largest
    logit, an MoE family picking the CPU's experts on its own.  bf16: a
    last-bit difference in a bf16 product (the card's and the CPU's BLAS
    sum in another order) moves the 16-layer Jamba smoke model's logits by
    up to 0.48 of the largest on the CPU alone, so each layer runs on the
    card from the CPU's input hidden state and on the CPU's expert picks,
    and its output, and the logits, must lie within 2e-2 of the CPU's."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models import model as TM
    cfg = ARCHS[arch].smoke_config()
    dt, tol = ((torch.float32, 1e-4) if dtype == "f32"
               else (torch.bfloat16, 2e-2))
    cfg = dataclasses.replace(cfg, compute_dtype=dt, cache_dtype=dt)
    g = torch.Generator().manual_seed(5)
    params = TM.cast_weights(TM.init(cfg, g), dt)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    frames = (torch.randn(2, cfg.encoder_seq, cfg.d_model, generator=g)
              if cfg.is_encdec else None)
    bf16 = dtype == "bf16"
    cpu_picks = _routed(monkeypatch)
    cpu_in, cpu_out = _layer_io(monkeypatch)
    want = _family_logits(cfg, params, toks, frames, "cpu")
    card_picks = _routed(monkeypatch, cpu_picks if bf16 else None)
    _, card_out = _layer_io(monkeypatch, cpu_in if bf16 else None)
    got = _family_logits(cfg, params, toks, frames, cuda)
    assert len(card_picks) == len(cpu_picks)
    assert len(card_out) == len(cpu_out) == 5 * cfg.num_layers
    if not bf16:
        assert all(torch.equal(a, b) for a, b in zip(card_picks, cpu_picks))
    for i, (a, b) in enumerate(zip(card_out, cpu_out) if bf16 else []):
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= tol, (i, err)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= tol, err


def test_lm_moe_capacity_path_on_card_matches_cpu(cuda):
    """The grouped capacity dispatch (t = 1024, two groups, capacity factor
    1.0 so that picks are dropped) on the card: the same kept picks and
    output as on the CPU."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models import moe as tmoe
    cfg = dataclasses.replace(ARCHS["granite-moe-1b-a400m"].smoke_config(),
                              moe_capacity_factor=1.0)
    g = torch.Generator().manual_seed(6)
    p = tmoe.moe_init(cfg, generator=g)
    x = torch.randn(2, 512, cfg.d_model, generator=g)
    want = tmoe.moe_apply(p, x, cfg, torch.float32)
    pc = {k: v.to(cuda) for k, v in p.items()}
    got = tmoe.moe_apply(pc, x.to(cuda), cfg, torch.float32).cpu()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    keeps = []
    for params, xx in ((p, x), (pc, x.to(cuda))):
        _, idx = tmoe._route(params, xx.reshape(2, 512, -1), cfg)
        keeps.append(tmoe.capacity_slots(idx, cfg.num_experts, 256)[1].cpu())
    assert torch.equal(keeps[0], keeps[1]) and not bool(keeps[0].all())


@pytest.mark.parametrize("arch", ["minicpm3-4b", "mamba2-2.7b",
                                  "jamba-1.5-large-398b"])
def test_lm_splice_leaves_the_other_slots_alone(cuda, arch):
    """Admitting a request into one slot rewrites that slot's row of every
    cache leaf (MLA latent, SSM state and conv windows) with the prefill's
    and leaves every other slot's bits as they were."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.serve import Engine, Request
    from repro_torch.models import model as TM
    cfg = ARCHS[arch].smoke_config()
    eng = Engine(cfg, batch=3, max_len=32, seed=0, device=cuda)
    g = torch.Generator(cuda).manual_seed(7)
    for t in TM.leaves(eng.cache["blocks"]):
        t.copy_(torch.randn(t.shape, generator=g, device=cuda))
    before = [t.clone() for t in TM.leaves(eng.cache["blocks"])]
    prompt = np.arange(1, 9, dtype=np.int32)
    eng.admit(Request(0, prompt, 4), 1)
    _, fresh = TM.forward(cfg, eng.params, {"tokens": torch.as_tensor(
        prompt, dtype=torch.int64, device=cuda)[None]}, make_cache_len=32)
    for old, new, one in zip(before, TM.leaves(eng.cache["blocks"]),
                             TM.leaves(fresh["blocks"])):
        assert torch.equal(new[0], old[0]) and torch.equal(new[2], old[2])
        assert torch.equal(new[1], one[0])


@pytest.mark.parametrize("arch", ["minicpm3-4b", "granite-moe-1b-a400m",
                                  "phi3.5-moe-42b-a6.6b", "mamba2-2.7b",
                                  "jamba-1.5-large-398b"])
def test_lm_served_repeat_gives_equal_tokens(cuda, arch):
    """The same stream served twice on the card (the smoke config, a round
    deadline of three steps so that requests are evicted and re-prefilled)
    gives the same tokens."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as TM
    params = TM.init(ARCHS[arch].smoke_config(),
                     torch.Generator(cuda).manual_seed(8))
    runs = []
    for _ in range(2):
        reqs = serve(arch, requests=4, batch=2, max_new=6, prompt_len=5,
                     max_len=32, quiet=True, seed=2, max_rounds=3,
                     max_evictions=10, params=params, device=cuda)
        runs.append({r.rid: r.out for r in reqs})
    assert runs[0] == runs[1] and sorted(runs[0]) == list(range(4))


# ---------------------------------------------------------------------------
# The LM training path
# ---------------------------------------------------------------------------

def _train_batch(cfg, dev, rows=2, seq=16, seed=3):
    from repro_torch.data.loader import LoaderConfig, TokenLoader
    from repro_torch.launch import train as ttrain
    batch = TokenLoader(LoaderConfig(cfg.vocab_size, rows, seq, seed=seed),
                        device=dev).batch_at(0)
    if cfg.is_encdec:
        batch["enc_frames"] = ttrain.enc_frames(cfg, rows, seed, 0, dev)
    return batch


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-1b-a400m",
                                  "mamba2-2.7b", "whisper-large-v3",
                                  "qwen1.5-110b"])
def test_lm_train_step_on_card_matches_cpu(cuda, arch):
    """One smoke-size train step (the config's optimizer) on the card
    against the CPU from the same state and batch: loss, grad norm and
    every grad leaf within 1e-4 of its largest magnitude (loss and norm
    rel 1e-5); after the step, the parameters and first moments within
    1e-4, the statistics of squared grads within 2e-4, of the CPU's
    optimizer applied to the card's grads (its own grads would move an
    element whose grad is near zero by up to lr: the first step divides
    each grad by statistics of its own size)."""
    from repro_torch import tree as T
    from repro_torch.configs import ARCHS
    from repro_torch.models import model as TM
    from repro_torch.models import steps as TS
    from repro_torch.optim import adafactor, adamw
    cfg = ARCHS[arch].smoke_config()
    lr = 1e-3
    state = TS.init_train_state(cfg, torch.Generator().manual_seed(4))
    card = T.map_tree(lambda x: x.to(cuda, copy=True), state)
    batch = _train_batch(cfg, "cpu")
    cbatch = {k: v.to(cuda) for k, v in batch.items()}
    _, gc = TS.loss_and_grads(cfg, card.params, cbatch)
    lh, gh = TS.loss_and_grads(cfg, state.params, batch)
    gc = [g.cpu() for g in gc]
    for a, b in zip(gc, gh):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    card, mc = TS.make_train_step(cfg, lr=lr)(card, cbatch)
    torch.testing.assert_close(mc["loss"].cpu(), lh, rtol=1e-5, atol=0)
    torch.testing.assert_close(mc["grad_norm"].cpu(), adamw.global_norm(gh),
                               rtol=1e-5, atol=0)
    if cfg.optimizer == "adafactor":
        opt, _ = adafactor.apply(
            gc, state.opt, T.leaves(state.params), lr,
            groups=adafactor.layout(state.params, TM.ref_layout(cfg)))
    else:
        opt, _ = adamw.apply(gc, state.opt, T.leaves(state.params), lr)
    for name in opt._fields[:-1]:
        tol = 1e-4 if name == "mu" else 2e-4
        for a, b in zip(T.leaves(getattr(card.opt, name)),
                        T.leaves(getattr(opt, name))):
            assert float((a.cpu() - b).abs().max()) <= tol * float(
                b.abs().max()), name
    for a, b in zip(T.leaves(card.params), T.leaves(state.params)):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(
            b.abs().max())
    assert int(card.step) == int(opt.count) == 1


def test_lm_train_runs_are_deterministic_on_card(cuda, tmp_path):
    """Two equal smoke-size runs of ``train`` (MoE, so the embedding's and
    the gather's backward take the deterministic kernels) give the same
    losses and the same final state bit for bit, and a killed run resumes
    onto them."""
    from repro_torch import tree as T
    from repro_torch.launch import train as ttrain
    kw = dict(smoke=True, steps=6, batch=2, seq=16, lr=1e-3, save_every=2,
              log_every=100, device=cuda)
    arch = "granite-moe-1b-a400m"
    s1, l1 = ttrain.train(arch, ckpt_dir=tmp_path / "a", **kw)
    s2, l2 = ttrain.train(arch, ckpt_dir=tmp_path / "b", **kw)
    assert l1 == l2
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(s1),
                                                 T.leaves(s2)))
    with pytest.raises(ttrain.SimulatedFailure):
        ttrain.train(arch, ckpt_dir=tmp_path / "c", simulate_failure_at=3,
                     **kw)
    _, l3 = ttrain.train(arch, ckpt_dir=tmp_path / "c", **kw)
    assert l3 == l1[2:]
    assert not torch.are_deterministic_algorithms_enabled()


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-1b-a400m",
                                  "mamba2-2.7b"])
def test_lm_train_step_makes_no_host_sync(cuda, arch):
    """Inside ``steps.STEP_RANGE`` (autograd through the model, the clip
    and the optimizer, with deterministic algorithms on, as ``train`` runs
    it) nothing waits on the card and nothing is copied from it."""
    import os

    from repro_torch.configs import ARCHS
    from repro_torch.models import steps as TS
    from repro_torch.optim import schedule
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = ARCHS[arch].smoke_config()
    box = {"state": TS.init_train_state(cfg, torch.Generator(
        cuda).manual_seed(0))}
    step = TS.make_train_step(cfg, lr=schedule.warmup_cosine(1e-3, 2, 10))
    batch = _train_batch(cfg, cuda)

    def run():
        box["state"], box["m"] = step(box["state"], batch)
    torch.use_deterministic_algorithms(True)
    try:
        waits, n_ranges, dtoh = _host_waits(run, TS.STEP_RANGE)
    finally:
        torch.use_deterministic_algorithms(False)
    assert (waits, n_ranges, dtoh) == ([], 1, [])


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-1b-a400m",
                                  "mamba2-2.7b", "whisper-large-v3"])
def test_lm_remat_is_bit_identical_on_card(cuda, arch):
    """Per-group remat on the card, in bf16 with deterministic algorithms
    (as ``train`` runs): the loss and every grad of the run without it,
    bit for bit."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.launch import train as ttrain
    from repro_torch.models import steps as TS
    cfg = dataclasses.replace(ARCHS[arch].smoke_config(),
                              compute_dtype=torch.bfloat16)
    params = TS.init_train_state(cfg, torch.Generator(cuda).manual_seed(
        2)).params
    batch = _train_batch(cfg, cuda)
    runs = []
    with ttrain.deterministic(cuda):
        for remat in (False, True):
            loss, grads = TS.loss_and_grads(
                dataclasses.replace(cfg, remat=remat), params, batch)
            runs.append([loss, *grads])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_dtensor_one_rank_step_matches_plain(cuda):
    """Qwen3-4B's published widths cut to 2 layers, float32, on one NCCL
    rank with every leaf a DTensor placed by the sharding rules on a
    (1, 1) mesh: a prefill's logits, every grad, and one AdamW train
    step's loss and grad norm equal the plain tensors' on the card to
    1e-5 of each one's largest."""
    import dataclasses

    from repro_torch import tree as T
    from repro_torch.configs import ARCHS
    from repro_torch.dist import ranks
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as TM
    from repro_torch.models import sharding as SH
    from repro_torch.models import steps as TS
    cfg = dataclasses.replace(ARCHS["qwen3-4b"].CONFIG, num_layers=2,
                              compute_dtype=torch.float32)
    g = torch.Generator(device=cuda).manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=g,
                         device=cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    pol = SH.ShardingPolicy()
    runs = []
    with ranks.one_rank("nccl"):
        mesh = make_mesh((1, 1), ("data", "model"), device=cuda)
        for sharded in (False, True):
            state = TS.init_train_state(cfg, torch.Generator(
                device=cuda).manual_seed(1))
            b = batch
            if sharded:
                state = SH.distribute_tree(state, SH.train_state_specs(
                    state, SH.param_specs(state.params, mesh, pol), mesh),
                    mesh)
                b = SH.distribute_tree(batch, SH.batch_specs(batch, mesh,
                                                             pol), mesh)
            with (SH.activation_axes(mesh, pol) if sharded
                  else contextlib.nullcontext()):
                with torch.no_grad():
                    logits, _ = TM.forward(cfg, state.params,
                                           {"tokens": b["tokens"]},
                                           make_cache_len=80)
                _, grads = TS.loss_and_grads(cfg, state.params, b)
                state, m = TS.make_train_step(cfg, lr=1e-3)(state, b)
            full = lambda x: x.full_tensor() if SH.is_sharded(x) else x  # noqa: E731,E501
            runs.append([full(logits), full(m["loss"]), full(m["grad_norm"])]
                        + [full(x) for x in grads])
    for i, (a, b) in enumerate(zip(*runs)):
        assert float((b - a).abs().max()) <= 1e-5 * float(a.abs().max()), i


def test_dryrun_cell_on_card_fake_tensors(cuda, tmp_path, monkeypatch):
    """A dry-run cell with fake tensors of the card's device type, on a
    fake process group of 8 ranks (2 x 4), returns "ok" with the argument
    bytes its specs give."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import dryrun as D
    monkeypatch.setattr(D, "RESULTS", tmp_path)
    for arch, shape in (("qwen3-4b", "decode_32k"),
                        ("granite-moe-1b-a400m", "train_4k")):
        rec = D.run_cell(arch, shape, "host", device=cuda,
                         cfg_override=ARCHS[arch].smoke_config(),
                         mesh=((2, 4), ("data", "model")))
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["device_type"] == "cuda"
        mem = rec["memory"]
        assert mem["argument_bytes"] == mem["argument_bytes_from_specs"]


# ---------------------------------------------------------------------------
# Kernel #2 on a design with an overflow store (BlockedCSC.from_csc)
# ---------------------------------------------------------------------------

def _skewed_csc(n=3000, d=4000, seed=8):
    """A heavy-tailed design in CSC (numpy): two columns in every row, a
    few hundred rows deep in a dozen more, the rest at density 0.5%."""
    rng = np.random.default_rng(seed)
    p = np.full(d, 0.005)
    p[rng.permutation(d)[:14]] = np.r_[1.0, 1.0, np.full(12, 0.2)]
    cols, rows = [], []
    for j in range(d):
        r = np.nonzero(rng.random(n) < p[j])[0]
        rows.append(r)
        cols.append(np.full(r.size, j))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    col_ptr = np.r_[0, np.cumsum(np.bincount(cols, minlength=d))]
    vals = rng.standard_normal(rows.size).astype(np.float32)
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    return col_ptr, rows.astype(np.int32), vals, n, d, y


def _tall_csc(dev, n=2_200_000, d=4096, seed=11):
    """A tall heavy-tailed design in CSC on ``dev`` (torch): three columns
    in every row, twelve at 10%, the rest at 0.05%.  Its 8,594 row items a
    round give each warp of the OVF launch's grid (2,112 on an H100) four
    or more, and a drawn full column gives an item a segment longer than a
    window of staged slots."""
    g = torch.Generator(device=dev).manual_seed(seed)
    perm = torch.randperm(d, generator=g, device=dev)
    keys = []
    for c, p in zip(perm[:15].tolist(), [1.0] * 3 + [0.1] * 12):
        hit = torch.nonzero(torch.rand(n, generator=g, device=dev) < p)
        keys.append(c * n + hit.reshape(-1))
    light = perm[15:]
    cnt = torch.binomial(torch.full((light.numel(),), float(n), device=dev),
                         torch.full((light.numel(),), 5e-4, device=dev),
                         generator=g).long()
    col = torch.repeat_interleave(light, cnt)
    keys.append(col * n + torch.randint(0, n, (col.numel(),), generator=g,
                                        device=dev))
    key = torch.unique(torch.cat(keys))
    col, rows = key // n, (key % n).to(torch.int32)
    col_ptr = torch.searchsorted(col, torch.arange(d + 1, device=dev))
    vals = torch.randn(rows.numel(), generator=g, device=dev)
    y = torch.where(torch.rand(n, generator=g, device=dev) < 0.5, 1.0, -1.0)
    return col_ptr, rows, vals, n, d, y


def _ovf_problem(dev, loss, tile=8, shape="small"):
    col_ptr, rows, vals, n, d, y = (_skewed_csc() if shape == "small"
                                    else _tall_csc(dev))
    S = tsp.BlockedCSC.from_csc(col_ptr, rows, vals, n, d, tile=tile,
                                device=dev)
    name = "lasso" if loss == "lasso" else "logistic"
    if name == "lasso":
        y = np.random.default_rng(9).standard_normal(n).astype(np.float32)
    prob = tobj.make_problem(S, y, 1.0, loss=name, device=dev)
    return prob._replace(lam=0.1 * tobj.lambda_max(prob.A, prob.y, name))


@pytest.mark.parametrize("shape", ["small", "tall"])
@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("loss", ["lasso", "logistic", "logistic_newton"])
def test_overflow_fused_matches_plain_and_repeats_bitwise(cuda, loss, store,
                                                          shape):
    """The OVF instantiation of #2 against its plain version on the same
    store (on the CPU; "tall", 2.2 M rows, on the card), a duplicate draw
    included, at k_eff = K and K − 1; bit for bit on a repeat; its guard;
    its stamps, three barriers a round; and its BC item counters under a
    profiler: every warp past its first item loads the next one's inputs
    under the current one, none at the small shape."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    ref, card = ((_ovf_problem(dev, loss) for dev in ("cpu", cuda))
                 if shape == "small" else [_ovf_problem(cuda, loss,
                                                        shape=shape)] * 2)
    A = {k: (p.A.astype(torch.bfloat16) if store == "bf16" else p.A)
         for k, p in (("ref", ref), ("cuda", card))}
    assert A["cuda"].ovf is not None and A["cuda"].ovf.seg_slots > 1
    rng = np.random.default_rng(4)
    idx = np.stack([rng.permutation(A["ref"].nblk)[:6] for _ in range(8)])
    idx[3, -1] = idx[3, 0]                             # duplicate draw
    idx = torch.from_numpy(idx.astype(np.int32))
    x = torch.zeros(A["ref"].d_pad)
    x[torch.from_numpy(rng.permutation(A["ref"].d)[:300])] = 0.02
    on_ref = A["ref"].rows.device
    x, idx = x.to(on_ref), idx.to(on_ref)
    z = A["ref"].matvec(x)
    S = A["cuda"]
    args = (S.rows, S.vals, z.to(cuda), x.to(cuda), idx.to(cuda), card.lam,
            card.beta, card.y)
    kw = dict(loss=loss, order=S.scatter_order(), rstart=S.range_starts(),
              ovf=S.ovf)
    tol = 1e-3 if store == "bf16" else 1e-4
    for k_eff in (None, 5):
        want = tss.fused_sparse_shotgun_rounds_plain(
            A["ref"].rows, A["ref"].vals, z, x, idx, ref.lam, ref.beta,
            ref.y, loss=loss, k_eff=k_eff, ovf=A["ref"].ovf)
        tss.reset_launches()
        got = tss.fused_sparse_shotgun_rounds(*args, **kw, k_eff=k_eff)
        assert tss.LAUNCHES["fused_sparse_shotgun_rounds"] == 1
        for u, v in zip(got[:3], want[:3]):
            torch.testing.assert_close(u.cpu(), v.cpu(), rtol=tol, atol=tol)
        assert float(got[4]) == float(want[4]) == 0.0
        again = tss.fused_sparse_shotgun_rounds(*args, **kw, k_eff=k_eff)
        for u, v in zip(got, again):
            assert torch.equal(u, v)
    *_, h = tss.fused_sparse_shotgun_rounds(*args, **kw, guard_f=0.0)
    assert float(h) == 1.0
    R = idx.shape[0]
    stamps = torch.zeros(3 * R + 6, dtype=torch.int64, device=cuda)
    timed = tss.fused_sparse_shotgun_rounds(*args, **kw, k_eff=k_eff,
                                            stamps=stamps)
    assert all(torch.equal(u, v) for u, v in zip(timed, got))
    st = stamps[:3 * R + 4]
    assert int(st[0]) > 0 and bool(torch.all(st[1:] > st[:-1]))
    assert 0 < int(stamps[-1] - stamps[-2])
    with pytest.raises(ValueError, match="stamps must be an int64"):
        tss.fused_sparse_shotgun_rounds(*args, **kw, stamps=stamps[:-1])
    obs.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            tss.fused_sparse_shotgun_rounds(*args, **kw)
        counters = obs.totals()["counters"]
    finally:
        obs.reset()
    n_lt = -(-S.n // 256)
    warps = tss._ovf_warps(tss.resolve_loss(loss), S.vals.dtype, cuda)
    assert warps % 8 == 0 and warps >= 8 * torch.cuda.get_device_properties(
        cuda).multi_processor_count
    assert counters["solver.overflow_bc_items"] == R * n_lt
    piped = counters["solver.overflow_bc_pipelined_items"]
    assert piped == R * max(0, n_lt - warps)
    assert (piped > 0) == (shape == "tall")


def test_overflow_guarded_newton_solve_on_card_matches_cpu(cuda):
    """``block_shotgun_solve`` takes a design with an overflow store through
    its fused path, guard and Newton steps on: the card's trace and iterate
    against the CPU's, and bit for bit on a repeat."""
    from repro_torch.core.health import GuardConfig
    spec = SolverSpec(loss="logistic", P=512, rounds=16, fused=True,
                      newton=True, guard=GuardConfig(factor=10.0, p_min=1))
    rng = np.random.default_rng(0)
    idx = np.stack([rng.permutation(32)[:4] for _ in range(16)]).astype(
        np.int32)
    res = {}
    for dev in ("cpu", cuda):
        prob = _ovf_problem(dev, "logistic")
        res[str(dev)] = [tops.block_shotgun_solve(prob, spec=spec,
                                                  blk_idx=idx)
                         for _ in range(2)]
    cpu, (gpu, again) = res["cpu"][0], res["cuda"]
    torch.testing.assert_close(gpu.trace.objective.cpu(),
                               cpu.trace.objective, rtol=1e-4, atol=0)
    torch.testing.assert_close(gpu.x.cpu(), cpu.x, rtol=1e-4, atol=1e-4)
    assert int(gpu.status) == int(cpu.status)
    assert torch.equal(gpu.x, again.x) and torch.equal(gpu.z, again.z)


def _news20_tiles(seed=5, n=20000, d=100000, density=3.36e-4):
    """A news20-shaped design as raw tiles (numpy), with its draws, an
    iterate and labels."""
    rng = np.random.default_rng(seed)
    counts = np.minimum(rng.binomial(n, density, d), 24)
    tile = 24
    nblk = -(-d // 128)
    rows = np.zeros((nblk * 128, tile), np.int32)
    vals = np.zeros((nblk * 128, tile), np.float32)
    for j in np.nonzero(counts)[0]:
        r = np.sort(rng.choice(n, counts[j], replace=False))
        rows[j, :counts[j]] = r
        vals[j, :counts[j]] = rng.exponential(1.0, counts[j])
    rows = rows.reshape(nblk, 128, tile).transpose(0, 2, 1).copy()
    vals = vals.reshape(nblk, 128, tile).transpose(0, 2, 1).copy()
    y = rng.standard_normal(n).astype(np.float32)
    ylab = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    idx = np.stack([rng.permutation(nblk)[:32] for _ in range(8)]).astype(
        np.int32)
    x = np.zeros(nblk * 128, np.float32)
    hot = rng.permutation(d)[:2000]
    x[hot] = 0.05 * rng.standard_normal(2000)
    return rows, vals, n, d, y, ylab, idx, x


# sha256 of (x, z, f, nnz, health) from kernel #2 of the tree before the
# overflow store, on an H100 (the same inputs, raw tiles).
PARENT_BITS = {
    "lasso": "18e2a0b1463e727fda3f1545f3250072eb5ac5cf0c79f5ffbac4d9beb2825f0d",
    "logistic_newton":
        "284f6e76dcfa5be37b828d483d85b1cfe4d0256f486f2b8a19fea1666f0bd5c9"}


def test_no_overflow_design_keeps_the_parents_bits(cuda):
    """A news20-shaped design with no column deeper than its tile has no
    overflow store, and #2 gives it the bits the kernel gave it before the
    store existed (``from_csc`` packs the same tiles)."""
    import hashlib
    rows, vals, n, d, y, ylab, idx, x = _news20_tiles()
    S = tsp.BlockedCSC(rows=torch.from_numpy(rows).to(cuda),
                       vals=torch.from_numpy(vals).to(cuda), n=n, d=d)
    cr = rows.transpose(0, 2, 1).reshape(-1, rows.shape[1])[:d]
    cv = vals.transpose(0, 2, 1).reshape(-1, rows.shape[1])[:d]
    live = (cr != 0) | (cv != 0)
    C = tsp.BlockedCSC.from_csc(np.r_[0, np.cumsum(live.sum(1))], cr[live],
                                cv[live], n, d, tile=rows.shape[1],
                                device=cuda)
    assert C.ovf is None
    assert torch.equal(C.rows, S.rows) and torch.equal(C.vals, S.vals)
    xt = torch.from_numpy(x).to(cuda)
    z = S.matvec(xt)
    for loss, store, yy in (("lasso", torch.float32, y),
                            ("logistic_newton", torch.bfloat16, ylab)):
        A = S.astype(store)
        got = tss.fused_sparse_shotgun_rounds(
            A.rows, A.vals, z, xt, torch.from_numpy(idx).to(cuda), 0.05,
            0.25 if loss != "lasso" else 1.0, torch.from_numpy(yy).to(cuda),
            loss=loss, order=A.scatter_order(), rstart=A.range_starts())
        h = hashlib.sha256()
        for t in got:
            h.update(t.cpu().numpy().tobytes())
        assert h.hexdigest() == PARENT_BITS[loss], loss
