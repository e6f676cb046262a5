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
    """The profiler sees one kernel and nothing else per scatter call (no
    memset, copy or allocation kernel); the gather likewise."""
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
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        ev = [e.name for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(ev) == 3 and all(name in e for e in ev), ev


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
    Counted on the runtime calls that enqueue device work: in this test
    process the profiler returned one device record for three back-to-back
    cooperative launches (seen on the H100; a script alone gets three)."""
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
    assert ev and all("fused_sparse_kernel" in e for e in ev), ev


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
