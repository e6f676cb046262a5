"""The port's batched slice on the CPU against the JAX package, on the same
numpy inputs and block draws: the batched fused kernels (#9 dense, #10
BlockedCSC; their plain versions against the Pallas kernels vmapped in
interpret mode), the stacked fixed-budget solve, admission (normalize and
stack), the warm-start cache, the launch-boundary convergence test, the
slot board and the stacked-state conversion.

Tolerances: f32 outputs rtol 1e-5 against JAX (the level
tests/test_fused_kernels.py:41 holds the Pallas kernels to), with atol
1e-5 scaled by max(1, the output's largest magnitude): these small
underdetermined problems reach |x| ≈ 100 after a few rounds, where one
last-bit difference in a sum taken in another order than XLA's is 1e-4
absolute.  nnz and health equal.  Inside the port the invariants are bit
for bit (``torch.equal``): a batched slot equals the unbatched kernel and
the standalone solve, a frozen slot returns its inputs."""
import random
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import batched as jcb  # noqa: E402
from repro.core import objectives as jobj  # noqa: E402
from repro.core.spec import SolverSpec as JSpec  # noqa: E402
from repro.data.sparse import BlockedCSC as JBlockedCSC  # noqa: E402
from repro.data.sparse import bcsc_matvec as jbcsc_matvec  # noqa: E402
from repro.kernels import batched as jkb  # noqa: E402
from repro.launch.slots import SlotBoard as JSlotBoard  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import batched as tcb  # noqa: E402
from repro_torch.core.spec import SolverSpec  # noqa: E402
from repro_torch.data import sparse as tsp  # noqa: E402
from repro_torch.kernels import batched as tkb  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import shotgun_block as tsb  # noqa: E402
from repro_torch.kernels import shotgun_sparse as tss  # noqa: E402
from repro_torch.launch.slots import SlotBoard as TSlotBoard  # noqa: E402

BLOCK = 128
K, ROUNDS, R = 2, 8, 4
TOL = 1e-5
LOSSES = ["lasso", "logistic", "logistic_newton"]
INF = float("inf")


def _name(loss):
    return "lasso" if loss == "lasso" else "logistic"


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.nanmax(np.abs(want), initial=0.0)))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * scale)


def _same_outputs(tout, jout):
    """Port (x, z, f, nnz, health) against JAX's."""
    for g, w in zip(tout[:3], jout[:3]):
        _close(g.numpy(), w)
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    np.testing.assert_array_equal(tout[4].numpy(), np.asarray(jout[4]))


def _slot_scalars(loss, S=3):
    """Per-slot λ, β, k_eff (all live, some, none) and a guard that trips
    on slot 1 only (0 < every F)."""
    base = 1.0 if loss == "lasso" else 0.25
    lam = 0.05 if loss == "lasso" else 2.0     # keeps logistic x moderate
    return (np.array([lam, 2 * lam, 4 * lam], np.float32)[:S],
            np.array([base, 1.5 * base, 2.0 * base], np.float32)[:S],
            np.array([K, 1, 0], np.float32)[:S],
            np.array([INF, 0.0, INF], np.float32)[:S])


def _draws(S, nblk, seed=3, rounds=R, k=K):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, nblk, (S, rounds, k)).astype(np.int32)
    idx[:, rounds // 2, -1] = idx[:, rounds // 2, 0]     # duplicate draws
    return idx


# ---------------------------------------------------------------------------
# Kernel #9: batched_fused_shotgun_rounds
# ---------------------------------------------------------------------------

def _dense_inputs(loss, shared, S=3, n=192, n_pad=512, d=384, seed=0):
    rng = np.random.default_rng(seed)
    shape = (n, d) if shared else (S, n, d)
    A = np.zeros(shape[:-2] + (n_pad, d), np.float32)
    A[..., :n, :] = rng.standard_normal(shape).astype(np.float32) / 14.0
    mask = np.zeros((S, n_pad), np.float32)
    mask[:, :n] = 1.0
    y = np.zeros((S, n_pad), np.float32)
    y[:, :n] = (rng.standard_normal((S, n)) if _name(loss) == "lasso"
                else np.sign(rng.standard_normal((S, n))))
    x = (rng.standard_normal((S, d)) * 0.05
         * (rng.random((S, d)) < 0.3)).astype(np.float32)
    z = np.einsum("nd,sd->sn" if shared else "snd,sd->sn", A, x)
    return A, z.astype(np.float32), x, y, mask


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("loss", LOSSES)
def test_batched_dense_kernel_matches_jax(loss, shared):
    A, z, x, y, mask = _dense_inputs(loss, shared)
    S = z.shape[0]
    lam, beta, k_eff, guard = _slot_scalars(loss)
    idx = _draws(S, A.shape[-1] // BLOCK)
    jout = jkb.batched_fused_shotgun_rounds(
        *(jnp.asarray(v) for v in (A, z, x, idx, lam, beta, y, mask, k_eff,
                                   guard)),
        loss=loss, interpret=True, shared_design=shared)
    t = [torch.tensor(v) for v in (A, z, x, idx, lam, beta, y, mask, k_eff,
                                   guard)]
    tout = tkb.batched_fused_shotgun_rounds(*t, loss=loss,
                                            shared_design=shared)
    _same_outputs(tout, jout)
    assert tout[4].tolist() == [0.0, 1.0, 0.0]          # slot 1's guard
    # the frozen slot returns its inputs exactly; the others moved
    assert torch.equal(tout[0][2], t[2][2]) and torch.equal(tout[1][2], t[1][2])
    assert not torch.equal(tout[0][0], t[2][0])
    # slot s == the unbatched kernel on slot s's state, bit for bit
    for s in range(S):
        one = tsb.fused_shotgun_rounds(
            t[0] if shared else t[0][s], t[1][s], t[2][s], t[3][s], t[4][s],
            t[5][s], t[6][s], t[7][s], loss=loss, k_eff=t[8][s],
            guard_f=t[9][s])
        assert all(torch.equal(a[s], b) for a, b in zip(tout, one)), s
    # the guard raises health only: unguarded, every output is the same
    free = tkb.batched_fused_shotgun_rounds(*t[:9], torch.full((S,), INF),
                                            loss=loss, shared_design=shared)
    assert all(torch.equal(a, b) for a, b in zip(tout[:4], free[:4]))
    assert free[4].tolist() == [0.0, 0.0, 0.0]


def test_batched_dense_kernel_rejects_bad_shapes():
    A, z, x, y, mask = _dense_inputs("lasso", False)
    t = [torch.tensor(v) for v in (A, z, x, _draws(3, 3))]
    scal = (0.1, 1.0, K, INF)
    with pytest.raises(ValueError, match="shared_design"):
        tkb.batched_fused_shotgun_rounds(t[0][0], t[1], t[2], t[3], *scal[:2],
                                         torch.tensor(y), torch.tensor(mask),
                                         *scal[2:])
    with pytest.raises(ValueError, match="blk_idx"):
        tkb.batched_fused_shotgun_rounds(t[0], t[1], t[2], t[3][0], *scal[:2],
                                         torch.tensor(y), torch.tensor(mask),
                                         *scal[2:])


# ---------------------------------------------------------------------------
# Kernel #10: batched_fused_sparse_shotgun_rounds
# ---------------------------------------------------------------------------

def _sparse_problems(loss, S=3, n=192, d=384, seed=0, densities=None,
                     tile=None):
    """JAX BlockedCSC problems; with ``tile=None`` their auto tiles differ
    (padded to the stream's tile at admission)."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(S):
        dens = (densities or [0.2, 0.12, 0.2])[s]
        A = rng.standard_normal((n, d)).astype(np.float32)
        A[rng.random((n, d)) >= dens] = 0.0
        y = (rng.standard_normal(n) if _name(loss) == "lasso"
             else np.sign(rng.standard_normal(n))).astype(np.float32)
        p = jobj.make_problem(jnp.asarray(A), jnp.asarray(y), lam=0.1,
                              loss=_name(loss))
        out.append(p._replace(A=JBlockedCSC.from_dense(p.A, block=BLOCK,
                                                       tile=tile)))
    return out


def _to_port(p):
    """The port's Problem from a JAX Problem (dense or BlockedCSC)."""
    A = p.A
    if isinstance(A, JBlockedCSC):
        A = convert.bcsc_from_numpy(np.asarray(A.rows), np.asarray(A.vals),
                                    A.n, A.d, device="cpu")
    else:
        A = np.asarray(A)
    return convert.problem_from_numpy(A, np.asarray(p.y), float(p.lam),
                                      p.loss, device="cpu")


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("loss", LOSSES)
def test_batched_sparse_kernel_matches_jax(loss, shared):
    probs = _sparse_problems(loss)
    assert len({p.A.tile for p in probs}) > 1      # a slot padded at admission
    meta, st = jcb.stack_problems(probs)
    rows, vals = np.asarray(st.rows), np.asarray(st.vals)
    if shared:
        rows, vals = rows[0], vals[0]
    S, n = 3, meta.n
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((S, meta.d_pad)) * 0.05
         * (rng.random((S, meta.d_pad)) < 0.3)).astype(np.float32)
    z = np.stack([np.asarray(jbcsc_matvec(
        jnp.asarray(rows if shared else rows[s]),
        jnp.asarray(vals if shared else vals[s]), jnp.asarray(x[s]), n))
        for s in range(S)])
    y = np.asarray(st.y)
    lam, beta, k_eff, guard = _slot_scalars(loss)
    idx = _draws(S, meta.nblk)
    jout = jkb.batched_fused_sparse_shotgun_rounds(
        *(jnp.asarray(v) for v in (rows, vals, z, x, idx, lam, beta, y, k_eff,
                                   guard)),
        loss=loss, interpret=True, shared_design=shared)
    t = [torch.tensor(v) for v in (rows, vals, z, x, idx, lam, beta, y, k_eff,
                                   guard)]
    tout = tkb.batched_fused_sparse_shotgun_rounds(*t, loss=loss,
                                                   shared_design=shared)
    _same_outputs(tout, jout)
    assert tout[4].tolist() == [0.0, 1.0, 0.0]
    assert torch.equal(tout[0][2], t[3][2]) and torch.equal(tout[1][2], t[2][2])
    for s in range(S):
        one = tss.fused_sparse_shotgun_rounds(
            t[0] if shared else t[0][s], t[1] if shared else t[1][s], t[2][s],
            t[3][s], t[4][s], t[5][s], t[6][s], t[7][s], loss=loss,
            k_eff=t[8][s], guard_f=t[9][s])
        assert all(torch.equal(a[s], b) for a, b in zip(tout, one)), s
    free = tkb.batched_fused_sparse_shotgun_rounds(
        *t[:9], torch.full((S,), INF), loss=loss, shared_design=shared)
    assert all(torch.equal(a, b) for a, b in zip(tout[:4], free[:4]))


def test_stacked_scatter_order_is_per_slot():
    probs = [_to_port(p) for p in _sparse_problems("lasso")]
    _, st = tcb.stack_problems(probs)
    od = tkb.stacked_scatter_order(st.rows, st.vals)
    for s in range(3):
        one = tss.scatter_order(st.rows[s], st.vals[s])
        assert all(torch.equal(a[s], b) for a, b in zip(od, one))
        assert all(torch.equal(a[s], b) for a, b in zip(st.order, one))


def test_stacked_range_starts_are_per_slot():
    """The stacked range-start tables equal each slot's own ``range_starts``
    over its padded tiles (the auto tiles differ, so the slots are padded
    to the canvas's tile; padding slots are left out of the table, so it
    is also the unpadded design's), and ``stack_problems`` carries them;
    3-D (shared) tiles give the design's own table."""
    probs = [_to_port(p) for p in _sparse_problems("lasso")]
    meta, st = tcb.stack_problems(probs)
    assert len({p.A.tile for p in probs}) > 1
    od = tkb.stacked_scatter_order(st.rows, st.vals)
    rs = tkb.stacked_range_starts(st.rows, od, meta.n_pad)
    nq1 = -(-meta.n_pad // tsp.RANGE_ROWS) + 1
    assert rs.dtype == torch.int32 and rs.shape == (3, meta.nblk, nq1)
    assert torch.equal(rs, st.rstart)
    for s in range(3):
        one = tss.scatter_order(st.rows[s], st.vals[s])
        assert torch.equal(rs[s], tsp.range_starts(st.rows[s], one,
                                                   meta.n_pad))
        assert torch.equal(rs[s], probs[s].A.range_starts())
        shared = tkb.stacked_range_starts(st.rows[s], one, meta.n_pad)
        assert torch.equal(shared, rs[s])


@pytest.mark.parametrize("shared", [False, True])
def test_batched_sparse_kernel_rejects_a_wrong_range_table(shared):
    """#10's wrapper takes a (S, nblk, ·) table for stacked tiles and an
    (nblk, ·) one for a shared design, on the operands' device, checked
    before it dispatches."""
    probs = [_to_port(p) for p in _sparse_problems("lasso")]
    meta, st = tcb.stack_problems(probs)
    rows, vals = (st.rows[0], st.vals[0]) if shared else (st.rows, st.vals)
    args = (rows, vals, torch.zeros(3, meta.n_pad), torch.zeros(3, meta.d_pad),
            torch.zeros(3, 2, 1, dtype=torch.int32), 0.1, 1.0, st.y, 1.0,
            INF)
    good, bad = ((st.rstart[0], st.rstart) if shared
                 else (st.rstart, st.rstart[0]))
    for table in (bad, good.long(), good[..., :-1].contiguous(),
                  good.to("meta")):
        with pytest.raises(ValueError, match="rstart"):
            tkb.batched_fused_sparse_shotgun_rounds(
                *args, shared_design=shared, rstart=table)
    got = tkb.batched_fused_sparse_shotgun_rounds(*args, shared_design=shared,
                                                  rstart=good)
    want = tkb.batched_fused_sparse_shotgun_rounds(*args,
                                                   shared_design=shared)
    assert all(torch.equal(u, v) for u, v in zip(got, want))


def test_batched_draw_blocks_follow_the_standalone_stream():
    idx = tkb.batched_draw_blocks([3, torch.Generator().manual_seed(4)], 6,
                                  2, 5, device="cpu")
    assert idx.shape == (2, 6, 2) and idx.dtype == torch.int32
    for s, seed in enumerate((3, 4)):
        want = tops.draw_blocks(torch.Generator().manual_seed(seed), 6, 2, 5,
                                "cpu")
        assert torch.equal(idx[s], want)
        assert all(len(set(r.tolist())) == 2 for r in idx[s])
    with pytest.raises(ValueError, match="K=6"):
        tkb.batched_draw_blocks([0], 1, 6, 5, device="cpu")


# ---------------------------------------------------------------------------
# Stacked solve: against JAX, and slot i == the standalone solve
# ---------------------------------------------------------------------------

def _dense_probs(num=3, n=192, d=384, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for s in range(num):
        A = rng.standard_normal((n, d)).astype(np.float32)
        y = rng.standard_normal(n).astype(np.float32)
        out.append(jobj.make_problem(jnp.asarray(A), jnp.asarray(y),
                                     lam=0.1 * (s + 1)))
    return out


def _jax_draws(keys, nblk, rounds=ROUNDS):
    keys_r = jax.vmap(lambda k: jax.random.split(k, rounds))(jnp.stack(keys))
    return np.asarray(jkb.batched_draw_blocks(keys_r, K, nblk))


@pytest.mark.parametrize("kind", ["dense", "bcsc", "hetero"])
def test_batched_solve_matches_jax_and_standalone(kind):
    if kind == "dense":
        jprobs = _dense_probs()
    else:   # equal tiles, or auto tiles of two depths (padded at admission)
        jprobs = _sparse_problems(
            "lasso", S=2, densities=[0.2, 0.2 if kind == "bcsc" else 0.12],
            tile=64 if kind == "bcsc" else None)
    keys = [jax.random.PRNGKey(7 + s) for s in range(len(jprobs))]
    jres = jcb.batched_block_shotgun_solve(
        jprobs, keys, spec=JSpec(loss="lasso", P=K * BLOCK, rounds=ROUNDS),
        rounds_per_launch=R, interpret=True)
    meta, _ = jcb.stack_problems(jprobs)
    if kind == "hetero":
        assert len({p.A.tile for p in jprobs}) == 2
    idx = _jax_draws(keys, meta.nblk)
    tprobs = [_to_port(p) for p in jprobs]
    spec = SolverSpec(loss="lasso", P=K * BLOCK, rounds=ROUNDS)
    tres = tcb.batched_block_shotgun_solve(tprobs, spec=spec,
                                           blk_idx=torch.tensor(idx),
                                           rounds_per_launch=R)
    _close(tres.trace.objective.numpy(), np.asarray(jres.trace.objective))
    np.testing.assert_array_equal(tres.trace.nnz.numpy(),
                                  np.asarray(jres.trace.nnz))
    fused = SolverSpec(loss="lasso", P=K * BLOCK, rounds=ROUNDS, fused=True)
    for s, (jp, tp) in enumerate(zip(jprobs, tprobs)):
        _close(tres.x[s][: tp.d].numpy(), np.asarray(jres.x[s][: jp.d]))
        if kind == "hetero" and tp.A.tile < meta.tile:
            A = tp.A
            pad = (0, 0, 0, meta.tile - A.tile)
            tp = tp._replace(A=type(A)(
                rows=torch.nn.functional.pad(A.rows, pad),
                vals=torch.nn.functional.pad(A.vals, pad), n=A.n, d=A.d))
        ref = tops.block_shotgun_solve(tp, spec=fused, blk_idx=idx[s],
                                       rounds_per_launch=R)
        assert torch.equal(tres.x[s][: tp.d], ref.x), s
        assert torch.equal(tres.trace.objective[s], ref.trace.objective), s
    assert tres.status.tolist() == np.asarray(jres.status).tolist()


def test_batched_solve_needs_spec_and_matching_draws():
    tprobs = [_to_port(p) for p in _dense_probs(num=2)]
    spec = SolverSpec(loss="lasso", P=K * BLOCK, rounds=ROUNDS)
    with pytest.raises(TypeError, match="spec="):
        tcb.batched_block_shotgun_solve(tprobs)
    with pytest.raises(ValueError, match="not divisible"):
        tcb.batched_block_shotgun_solve(tprobs, spec=spec,
                                        rounds_per_launch=3)
    with pytest.raises(ValueError, match="1 generators for 2 problems"):
        tcb.batched_block_shotgun_solve(tprobs, [torch.Generator()],
                                        spec=spec)
    with pytest.raises(ValueError, match="does not match"):
        tcb.batched_block_shotgun_solve(
            tprobs, spec=SolverSpec(loss="logistic", rounds=ROUNDS))


def test_batched_solve_generators_and_warm_start():
    """Generator draws equal the same streams given as blk_idx; a warm
    start equals the standalone warm-started solve bit for bit."""
    tprobs = [_to_port(p) for p in _dense_probs(num=2)]
    spec = SolverSpec(loss="lasso", P=K * BLOCK, rounds=ROUNDS)
    gens = [torch.Generator().manual_seed(s) for s in (1, 2)]
    res = tcb.batched_block_shotgun_solve(tprobs, gens, spec=spec,
                                          rounds_per_launch=R)
    idx = torch.stack([tops.draw_blocks(torch.Generator().manual_seed(s),
                                        ROUNDS, K, 3, "cpu") for s in (1, 2)])
    x0s = [None, torch.linspace(-0.1, 0.1, tprobs[1].d)]
    again = tcb.batched_block_shotgun_solve(tprobs, spec=spec, blk_idx=idx,
                                            rounds_per_launch=R)
    assert torch.equal(res.x, again.x)
    warm = tcb.batched_block_shotgun_solve(tprobs, spec=spec, blk_idx=idx,
                                           x0s=x0s, rounds_per_launch=R)
    fused = SolverSpec(loss="lasso", P=K * BLOCK, rounds=ROUNDS, fused=True)
    for s in range(2):
        ref = tops.block_shotgun_solve(tprobs[s], spec=fused, blk_idx=idx[s],
                                       x0=x0s[s], rounds_per_launch=R)
        assert torch.equal(warm.x[s][: tprobs[s].d], ref.x), s


def test_frozen_slot_is_bit_exact_noop():
    tprobs = [_to_port(p) for p in _dense_probs(num=2)]
    meta, stacked = tcb.stack_problems(tprobs)
    x0 = torch.zeros((2, meta.d_pad))
    z0 = torch.zeros((2, meta.n_pad))
    idx = torch.tensor(_draws(2, meta.nblk))
    x, z, _, _, _ = tcb.launch_rounds(meta, stacked, z0, x0, idx,
                                      torch.tensor([0.0, float(K)]))
    assert torch.equal(x[0], x0[0]) and torch.equal(z[0], z0[0])
    assert bool(torch.any(x[1] != 0))


# ---------------------------------------------------------------------------
# Admission: the same canvases and the same refusals as JAX
# ---------------------------------------------------------------------------

def _np_fields(sa):
    return [None if v is None else np.asarray(v) for v in sa[:7]]


def _same_canvas(tsa, jsa):
    for got, want in zip(_np_fields(tsa), _np_fields(jsa)):
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["dense", "bcsc"])
def test_normalize_and_stack_match_jax(kind):
    jprobs = (_dense_probs(num=2) + _dense_probs(num=1, d=300, seed=5)
              if kind == "dense" else _sparse_problems("lasso"))
    tprobs = [_to_port(p) for p in jprobs]
    jmeta, jst = jcb.stack_problems(jprobs)
    tmeta, tst = tcb.stack_problems(tprobs)
    assert tuple(tmeta) == tuple(jmeta)
    assert tcb.batch_meta_of(tprobs[0]) == tuple(jcb.batch_meta_of(jprobs[0]))
    _same_canvas(tst, jst)
    for jp, tp in zip(jprobs, tprobs):
        _same_canvas(tcb.normalize_problem(tp, tmeta),
                     jcb.normalize_problem(jp, jmeta))


def _admission_cases():
    """(what, JAX argument, port argument, JAX meta)."""
    dense = _dense_probs(num=1)[0]
    sparse = _sparse_problems("lasso", S=1)[0]
    small = _dense_probs(num=1, n=64, d=128, seed=9)[0]
    wide = _dense_probs(num=1, d=1000, seed=2)[0]
    td, ts = _to_port(dense), _to_port(sparse)
    dense_meta = jcb.batch_meta_of(dense)
    sparse_meta = jcb.batch_meta_of(sparse)
    return [
        ("stack", [dense, sparse], [td, ts], None),
        ("stack", [], [], None),
        ("normalize", small, _to_port(small), dense_meta),
        ("normalize", sparse, ts, dense_meta),
        ("normalize", dense._replace(loss="logistic"),
         td._replace(loss="logistic"), dense_meta),
        ("normalize", wide, _to_port(wide), dense_meta),
        ("normalize", sparse, ts, sparse_meta._replace(tile=8)),
        ("normalize", sparse, ts, sparse_meta._replace(d_pad=128)),
        ("normalize", sparse, ts, sparse_meta._replace(block=64)),
    ]


def test_admission_raises_as_jax():
    for what, jarg, targ, meta in _admission_cases():
        with pytest.raises(ValueError) as jerr:
            if what == "stack":
                jcb.stack_problems(jarg)
            else:
                jcb.normalize_problem(jarg, meta)
        with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
            if what == "stack":
                tcb.stack_problems(targ)
            else:
                tcb.normalize_problem(targ, tcb.BatchMeta(*meta))
    with pytest.raises(ValueError, match="heterogeneous stream"):
        tcb.stack_problems([_to_port(_dense_probs(num=1)[0]),
                            _to_port(_sparse_problems("lasso", S=1)[0])])


# ---------------------------------------------------------------------------
# Stacked-state conversion drives both launch_rounds to one answer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "bcsc"])
def test_slot_arrays_from_numpy_drives_launch_rounds_like_jax(kind):
    jprobs = _dense_probs() if kind == "dense" else _sparse_problems("lasso")
    jmeta, jst = jcb.stack_problems(jprobs)
    tmeta, tst = convert.slot_arrays_from_numpy(tuple(jmeta), _np_fields(jst),
                                                device="cpu")
    _same_canvas(tst, jst)
    _, own = tcb.stack_problems([_to_port(p) for p in jprobs])
    if kind == "bcsc":
        assert all(torch.equal(a, b) for a, b in zip(tst.order, own.order))
    S = len(jprobs)
    rng = np.random.default_rng(8)
    x0 = (rng.standard_normal((S, jmeta.d_pad)) * 0.01).astype(np.float32)
    z0 = np.asarray(jcb.init_margin(jmeta, jst, jnp.asarray(x0)))
    idx = _draws(S, jmeta.nblk)
    k_eff = np.array([K, 1, 0][:S], np.float32)
    guard = np.array([INF, 0.0, INF][:S], np.float32)
    jout = jcb.launch_rounds(jmeta, jst, jnp.asarray(z0), jnp.asarray(x0),
                             jnp.asarray(idx), jnp.asarray(k_eff),
                             guard_f=jnp.asarray(guard), interpret=True)
    tz0 = tcb.init_margin(tmeta, tst, torch.tensor(x0))
    _close(tz0.numpy(), z0)
    tout = tcb.launch_rounds(tmeta, tst, torch.tensor(z0), torch.tensor(x0),
                             torch.tensor(idx), torch.tensor(k_eff),
                             guard_f=torch.tensor(guard))
    _same_outputs(tout, jout)


# ---------------------------------------------------------------------------
# Warm-start cache and the launch-boundary convergence test
# ---------------------------------------------------------------------------

def test_warm_cache_sequence_matches_jax():
    jc, tc = jcb.WarmStartCache(), tcb.WarmStartCache()
    rng = np.random.default_rng(0)
    lams = [0.5, 0.9, 0.5 + 1e-9, 2.0, 0.7]
    for step in range(40):
        pid = int(rng.integers(0, 3))
        lam = float(lams[int(rng.integers(0, len(lams)))])
        loss = ["lasso", "logistic"][int(rng.integers(0, 2))]
        if rng.random() < 0.4:
            x = rng.standard_normal(4).astype(np.float32)
            jc.put(pid, lam, jnp.asarray(x), loss=loss)
            tc.put(pid, lam, torch.tensor(x), loss=loss)
        else:
            (jx, jk), (tx, tk) = (jc.get(pid, lam, loss=loss),
                                  tc.get(pid, lam, loss=loss))
            assert jk == tk, step
            assert (jx is None) == (tx is None), step
            if jx is not None:
                np.testing.assert_array_equal(tx, np.asarray(jx))
    assert (tc.stats.hits_exact, tc.stats.hits_near, tc.stats.misses) == (
        jc.stats.hits_exact, jc.stats.hits_near, jc.stats.misses)
    assert tc.stats.hit_rate == jc.stats.hit_rate and len(tc) == len(jc)


def test_warm_cache_nearest_lambda_fallback():
    cache = tcb.WarmStartCache()
    x5, x9 = np.full(4, 5.0), np.full(4, 9.0)
    cache.put("p", 0.5, x5)
    cache.put("p", 0.9, torch.tensor(x9))
    got, kind = cache.get("p", 0.5)
    assert kind == "exact" and np.array_equal(got, x5)
    got, kind = cache.get("p", 0.55)
    assert kind == "near" and np.array_equal(got, x5)
    got, kind = cache.get("p", 5.0)
    assert kind == "near" and np.array_equal(got, x9)
    got, kind = cache.get("q", 0.5)
    assert got is None and kind == "miss"
    assert cache.stats.misses == 1 and cache.stats.hits_exact == 1


def test_warm_cache_keeps_a_device_tensor_on_its_device():
    """A put of a tensor off the CPU (``meta`` stands in for the card)
    stores a float32 copy on that device and moves no bytes to the host;
    a CPU tensor and a numpy array are still stored as float32 host numpy
    and counted as before."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    cache = tcb.WarmStartCache()
    on_dev = torch.ones(6, dtype=torch.float64, device="meta")
    on_cpu = torch.full((6,), 2.0, dtype=torch.float64)
    as_np = np.full(6, 3.0, np.float64)
    obs.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            cache.put("p", 0.5, on_dev)
            c_dev = obs.totals()["counters"]
            cache.put("p", 0.7, on_cpu)
            c_cpu = obs.totals()["counters"]
            cache.put("p", 0.9, as_np)
            c_np = obs.totals()["counters"]
    finally:
        obs.reset()
    assert c_dev == {"serve.cache_host_bytes": 0}
    assert c_cpu == {"serve.cache_host_bytes": on_cpu.nbytes}
    assert c_np == c_cpu                      # numpy was never counted
    got, kind = cache.get("p", 0.5)
    assert kind == "exact" and isinstance(got, torch.Tensor)
    assert got is not on_dev and got.device.type == "meta"
    assert got.dtype == torch.float32 and got.shape == on_dev.shape
    for lam, want in ((0.7, 2.0), (0.9, 3.0)):
        got, kind = cache.get("p", lam)
        assert kind == "exact" and isinstance(got, np.ndarray)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, np.full(6, want, np.float32))


def test_launch_converged_matches_jax_on_a_grid():
    prevs = [100.0, 0.5, -3.0, 0.0, INF]
    ends = [100.0, 100.001, 150.0, 50.0, 0.5000001, -3.0001, 0.0, 1e-7,
            float("nan"), INF]
    for f_prev in prevs:
        for f_end in ends:
            for tol in (0.0, 1e-4, 1e-3, 0.6):
                launch = np.array([f_prev, f_end], np.float32)
                want = jcb.launch_converged(f_prev, launch, tol)
                assert tcb.launch_converged(f_prev, launch, tol) == want
                assert tcb.launch_converged(
                    f_prev, torch.tensor(launch), tol) == want
    assert tcb.launch_converged(100.0, np.array([100.0, 100.001]), 1e-3)
    assert not tcb.launch_converged(100.0, np.array([100.0, 150.0]), 1e-3)
    assert not tcb.launch_converged(100.0, np.array([100.0, np.nan]), 1e-3)


# ---------------------------------------------------------------------------
# SlotBoard
# ---------------------------------------------------------------------------

class _Req:
    def __init__(self, rid):
        self.rid = rid
        self.done = False
        self.evictions = 0


def test_slotboard_refill_order_and_age_reset():
    b = TSlotBoard(2)
    b.queue.extend(_Req(i) for i in range(4))
    admitted = []
    b.refill(lambda r, s: (admitted.append((r.rid, s)), b.place(r, s)))
    assert admitted == [(0, 0), (1, 1)]
    b.tick()
    assert b.age == [1, 1] and b.occupancy() == 1.0
    b.slots[0].done = True
    b.refill(lambda r, s: b.place(r, s))
    assert b.slots[0].rid == 2 and b.age[0] == 0 and b.age[1] == 1
    assert [r.rid for r in b.finished] == [0]


def test_slotboard_eviction_requeues_at_tail_then_gives_up():
    b = TSlotBoard(1, max_rounds=1, max_evictions=1)
    r0, r1 = _Req(0), _Req(1)
    b.queue.extend([r0, r1])
    b.refill(lambda r, s: b.place(r, s))
    b.tick()
    assert b.evict_stale() == [0]
    assert b.queue == [r1, r0] and r0.evictions == 1    # tail re-queue
    b.refill(lambda r, s: b.place(r, s))
    assert b.slots[0] is r1
    b.tick()
    b.evict_stale()
    b.refill(lambda r, s: b.place(r, s))
    b.tick()
    b.evict_stale()                                     # r0's 2nd eviction
    assert r0.done and r0 in b.finished                 # gave up
    assert not b.pending() or b.queue == [r1]


def test_slotboard_drain_collects_remaining():
    b = TSlotBoard(2)
    r = _Req(0)
    b.place(r, 1)
    out = b.drain()
    assert out == [r] and b.slots == [None, None]


def test_slotboard_random_sequence_matches_jax():
    """One seeded random sequence of refill, tick, finish, evict and drain
    on both boards leaves the same slots, ages, queue, finished list and
    evictions."""
    rng = random.Random(5)
    boards = [JSlotBoard(3, max_rounds=2, max_evictions=2),
              TSlotBoard(3, max_rounds=2, max_evictions=2)]
    reqs = [[_Req(i) for i in range(12)] for _ in boards]
    for b, rs in zip(boards, reqs):
        b.queue.extend(rs[:6])

    def state(b):
        ids = lambda xs: [None if r is None else r.rid for r in xs]  # noqa: E731
        return (ids(b.slots), list(b.age), ids(b.queue), ids(b.finished),
                [(r.rid, r.evictions, r.done) for r in b.finished + b.queue],
                b.occupancy(), b.pending(), b.live(), b.free_slots())

    for step in range(60):
        op = rng.choice(["refill", "tick", "finish", "evict", "enqueue"])
        arg = rng.randrange(12)
        outs = []
        for b, rs in zip(boards, reqs):
            if op == "refill":
                outs.append(b.refill(lambda r, s, b=b: b.place(r, s)))
            elif op == "tick":
                outs.append(b.tick())
            elif op == "finish":
                slot = b.slots[arg % 3]
                if slot is not None:
                    slot.done = True
            elif op == "evict":
                outs.append(b.evict_stale())
            elif not any(r is rs[arg] for r in b.queue + b.slots
                         + b.finished):
                b.queue.append(rs[arg])
        assert outs[:1] == outs[1:], (step, op)
        assert state(boards[0]) == state(boards[1]), (step, op)
    assert [r.rid for r in boards[0].drain()] == [
        r.rid for r in boards[1].drain()]
    assert state(boards[0]) == state(boards[1])
