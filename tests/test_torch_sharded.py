"""The port's sharded Shotgun driver (``repro_torch.core.sharded``) on gloo
ranks on the CPU, against the JAX package.

The JAX ``shotgun_sharded_solve`` cannot be the oracle on this tree (its
``out_specs`` fault, ROADMAP Queue 3), but its round engines run alone: the
reference is a host-level loop of JAX ``engine.run`` per shard (the recipe
of tests/test_async_pipeline.py), with the driver's key schedule — keys
split per round, folded with the shard index on more than one shard (and
always for the scalar engine) — whose draws the port gets as ``blk_idx``.

  * one rank, in this process (a gloo group of size 1 on a FileStore):
    every engine against the JAX loop; ``merge="round"`` against the port's
    fused ``block_shotgun_solve``; ``merge="launch"`` against
    ``merge="round"`` thinned to the same points; pipelined against
    synchronous; warm start; checkpointed kill and resume; every
    ``ValueError`` of the reference's argument checks;
  * two and four ranks, in child processes spawned once per module
    (``python -c`` with a FileStore under the test's temp dir, a join
    timeout; the children import ``repro_torch`` only, the parent computes
    the JAX references and passes numpy files): fused and sparse-fused
    engines, synchronous and pipelined, against the JAX loop; 2 × 2
    hierarchical against flat; corrupt-only faults against clean; a bf16
    wire against f32; a guarded pipelined solve; kill and resume, also
    resumed on one rank after a two-rank save.

Tolerances: traces rtol 1e-5 against the JAX loop and between merge
algebras (f32 sums of the same terms in another order), x and z rtol/atol
1e-4; against the fused block solve F rtol 2e-5 (tests/test_sharded_engines
.py:40), x and z 1e-4; faults with enough retries and checkpoint resumes bit
for bit; a bf16 wire's final F within 1% of f32's."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engines as jeng  # noqa: E402
from repro.core import objectives as jobj  # noqa: E402
from repro.core.sharded import pad_features as jpad_features  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.data.sparse import pad_feature_blocks as jpad_blocks  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import sharded as tsh  # noqa: E402
from repro_torch.core.health import GuardConfig, SolverFailure  # noqa: E402
from repro_torch.core.spec import SolverSpec  # noqa: E402
from repro_torch.dist import ranks  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

BLOCK = 128
LAM = 0.5
GEN = dict(seed=0, n=500, d=1000, density=0.01)
R, ROUNDS, TRACE = 4, 32, 2             # merge="launch" cells
KEY = 7


# ---------------------------------------------------------------------------
# Problems and the JAX reference loop
# ---------------------------------------------------------------------------

def _jax_problem(layout):
    A, y, _ = jsyn.large_sparse(layout=layout, **GEN)
    return jobj.make_problem(A, y, lam=LAM)


@pytest.fixture(scope="module")
def jprobs():
    return {"dense": _jax_problem("dense"), "sparse": _jax_problem("bcsc")}


def _port_problem(jp):
    A = jp.A
    if not isinstance(A, jax.Array):
        A = convert.bcsc_from_numpy(np.asarray(A.rows), np.asarray(A.vals),
                                    A.n, A.d, device="cpu")
    else:
        A = np.asarray(A)
    return convert.problem_from_numpy(A, np.asarray(jp.y), float(jp.lam),
                                      jp.loss, device="cpu")


def _draw_fn(engine, width, limit):
    if engine == "scalar":
        return lambda k: jax.random.randint(k, (width,), 0, limit)
    return lambda k: jax.random.choice(k, limit, (width,), replace=False)


def jax_loop(jp, engine, shards, *, K=2, P_local=4, R=R, rounds=ROUNDS,
             trace_every=TRACE, pipeline=False, x0=None):
    """The driver's schedule on the host over JAX ``engine.run`` per shard.
    Returns dict(f, x, z, draws (shards, rounds, width))."""
    sparse = engine.startswith("sparse")
    if sparse:
        S = jpad_blocks(jp.A, shards)
        nb = S.nblk // shards
        parts = [(S.rows[s * nb:(s + 1) * nb], S.vals[s * nb:(s + 1) * nb])
                 for s in range(shards)]
        y, mask = jp.y, jnp.ones(jp.n, jnp.float32)
        d_local, d_full = nb * BLOCK, S.d_pad
        matvec = S.matvec
    else:
        if engine == "scalar":
            A, y = jpad_features(jp.A, shards), jp.y
            mask = jnp.ones(jp.n, jnp.float32)
        else:
            A, y, mask = jops.pad_problem(jp.A, jp.y)
            A = jpad_features(A, shards * BLOCK)
            mask = mask.astype(jnp.float32)
        d_full = A.shape[1]
        d_local = d_full // shards
        parts = [A[:, s * d_local:(s + 1) * d_local] for s in range(shards)]
        matvec = lambda x: A @ x  # noqa: E731
    width = P_local if engine == "scalar" else K
    limit = d_local if engine == "scalar" else d_local // BLOCK
    eng = jeng.make_engine(engine, loss=jp.loss, P_local=P_local, K=K,
                           interpret=True)
    p_eff = jnp.int32(eng.p_full)

    def run(part, zv, xs, ks):
        a = types.SimpleNamespace(rows=part[0], vals=part[1]) if sparse \
            else part
        return eng.run(a, y, mask, jp.lam, jp.beta, zv, xs, ks, p_eff)

    run = jax.jit(run)
    n_merges = rounds // R
    keys = jax.random.split(jax.random.PRNGKey(KEY), rounds).reshape(
        n_merges, R, -1)
    fold = engine == "scalar" or shards > 1
    xf = (jnp.zeros(d_full, jnp.float32) if x0 is None
          else jnp.pad(jnp.asarray(x0), (0, d_full - jp.d)))
    x_l = [xf[s * d_local:(s + 1) * d_local] for s in range(shards)]
    z = matvec(xf)
    w_pend = [jnp.zeros_like(z) for _ in range(shards)]
    draws = np.zeros((shards, rounds, width), np.int32)
    fs = []
    for m in range(n_merges):
        dz_new = []
        for s in range(shards):
            ks = (jax.vmap(lambda kt: jax.random.fold_in(kt, s))(keys[m])
                  if fold else keys[m])
            draws[s, m * R:(m + 1) * R] = np.asarray(
                jax.vmap(_draw_fn(engine, width, limit))(ks))
            view = z + w_pend[s] if pipeline else z
            x_l[s], dz, _ = run(parts[s], view, x_l[s], ks)
            dz_new.append(dz)
        if pipeline:
            z = z + sum(w_pend)
            w_pend = dz_new
        else:
            z = z + sum(dz_new)
        if (m + 1) % trace_every == 0:
            x_all = jnp.concatenate(x_l)
            fs.append(float(jobj.masked_data_loss(z, y, mask, jp.loss)
                            + jp.lam * jnp.sum(jnp.abs(x_all))))
    if pipeline:
        z = z + sum(w_pend)
    return dict(f=np.asarray(fs, np.float32),
                x=np.asarray(jnp.concatenate(x_l))[: jp.d],
                z=np.asarray(z)[: jp.n], draws=draws)


def _assert_matches(got_f, got_x, got_z, want):
    np.testing.assert_allclose(got_f, want["f"], rtol=1e-5)
    np.testing.assert_allclose(got_x, want["x"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_z, want["z"], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# One rank, in this process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    store = dist.FileStore(str(tmp_path_factory.mktemp("store") / "st"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _solve(prob, engine, spec, **kw):
    kw.setdefault("rounds_per_launch", R)
    return tsh.shotgun_sharded_solve(prob, spec=spec, engine=engine, **kw)


ONE_RANK = [("scalar", dict(P_local=4)), ("block", dict(K=2)),
            ("fused", dict(K=2)), ("sparse_block", dict(K=2)),
            ("sparse_fused", dict(K=2))]


@pytest.mark.parametrize("engine,kw", ONE_RANK)
def test_one_rank_engine_matches_jax_loop(one_rank, jprobs, engine, kw):
    jp = jprobs["sparse" if engine.startswith("sparse") else "dense"]
    want = jax_loop(jp, engine, 1, **kw)
    spec = SolverSpec(P=kw.get("P_local", 8), rounds=ROUNDS, merge="launch")
    r = _solve(_port_problem(jp), engine, spec, K=kw.get("K", 2),
               trace_every=TRACE, blk_idx=want["draws"])
    _assert_matches(r.trace.objective.numpy(), r.x.numpy(), r.z.numpy(),
                    want)
    assert int(r.status) == 0


def _one_rank_draws(prob, K=2, rounds=ROUNDS, seed=3):
    nblk = -(-prob.d // BLOCK)
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(nblk)[:K] for _ in range(rounds)]
                    ).astype(np.int32)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_one_rank_round_merge_equals_fused_block_solve(one_rank, jprobs,
                                                       kind):
    prob = _port_problem(jprobs[kind])
    idx = _one_rank_draws(prob)
    ref = tops.block_shotgun_solve(
        prob, spec=SolverSpec(P=256, rounds=ROUNDS, fused=True), blk_idx=idx)
    r = _solve(prob, "sparse_fused" if kind == "sparse" else "fused",
               SolverSpec(rounds=ROUNDS, merge="round"), K=2,
               blk_idx=idx[None])
    np.testing.assert_allclose(r.trace.objective.numpy(),
                               ref.trace.objective.numpy(), rtol=2e-5)
    np.testing.assert_array_equal(r.trace.nnz.numpy(), ref.trace.nnz.numpy())
    for a, b in ((r.x, ref.x), (r.z, ref.z)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_one_rank_launch_merge_equals_round_merge(one_rank, jprobs, kind):
    prob = _port_problem(jprobs[kind])
    engine = "sparse_fused" if kind == "sparse" else "fused"
    idx = _one_rank_draws(prob)[None]
    rnd = _solve(prob, engine, SolverSpec(rounds=ROUNDS, merge="round"), K=2,
                 trace_every=R, blk_idx=idx)
    lau = _solve(prob, engine, SolverSpec(rounds=ROUNDS, merge="launch"),
                 K=2, trace_every=1, blk_idx=idx)
    np.testing.assert_allclose(lau.trace.objective.numpy(),
                               rnd.trace.objective.numpy(), rtol=2e-5)
    np.testing.assert_allclose(lau.x.numpy(), rnd.x.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_one_rank_pipeline_equals_sync(one_rank, jprobs, kind):
    prob = _port_problem(jprobs[kind])
    engine = "sparse_fused" if kind == "sparse" else "fused"
    idx = _one_rank_draws(prob)[None]
    sync = _solve(prob, engine, SolverSpec(rounds=ROUNDS, merge="launch"),
                  K=2, blk_idx=idx)
    pipe = _solve(prob, engine, SolverSpec(rounds=ROUNDS, merge="launch",
                                           pipeline=True), K=2, blk_idx=idx)
    # identical views on one rank -> identical updates
    assert torch.equal(sync.x, pipe.x)
    np.testing.assert_allclose(pipe.z.numpy(), sync.z.numpy(), rtol=1e-5,
                               atol=1e-5)
    # trace points report F at the stale margin: one point behind
    f_s, f_p = sync.trace.objective.numpy(), pipe.trace.objective.numpy()
    assert f_p[0] > f_s[0] and np.all(np.isfinite(f_p))


def test_one_rank_warm_start_matches_jax_loop(one_rank, jprobs):
    jp = jprobs["dense"]
    x0 = (np.random.default_rng(8).standard_normal(jp.d) * 0.05
          ).astype(np.float32)
    want = jax_loop(jp, "fused", 1, x0=x0)
    r = _solve(_port_problem(jp), "fused",
               SolverSpec(rounds=ROUNDS, merge="launch"), K=2,
               trace_every=TRACE, blk_idx=want["draws"], x0=x0)
    _assert_matches(r.trace.objective.numpy(), r.x.numpy(), r.z.numpy(),
                    want)


def test_one_rank_guard_rolls_back_beyond_pstar(one_rank, jprobs):
    """K = 8 blocks (every coordinate each round) diverges unguarded; the
    guard rolls back and halves p_eff, ending finite and recovered."""
    prob = _port_problem(jprobs["sparse"])._replace(lam=torch.tensor(0.05))
    base = dict(rounds=64, merge="launch")
    bad = _solve(prob, "sparse_fused", SolverSpec(**base), K=8, seed=1)
    assert int(bad.status) == 2
    ok = _solve(prob, "sparse_fused",
                SolverSpec(guard=GuardConfig(p_min=1), **base), K=8, seed=1)
    f = ok.trace.objective.numpy()
    assert np.all(np.isfinite(f)) and int(ok.status) == 1
    assert f[-1] < f[0]


def test_one_rank_segmented_kill_and_resume_is_bitwise(one_rank, jprobs,
                                                       tmp_path):
    prob = _port_problem(jprobs["dense"])
    kw = dict(K=2, trace_every=1, ckpt_every=2, seed=4)
    spec = SolverSpec(rounds=ROUNDS, merge="launch", pipeline=True)
    ref = _solve(prob, "fused", spec, **kw)
    with pytest.raises(SolverFailure):
        _solve(prob, "fused", spec, ckpt_dir=tmp_path, fail_at_merge=4, **kw)
    res = _solve(prob, "fused", spec, ckpt_dir=tmp_path, resume=True, **kw)
    assert torch.equal(ref.trace.objective, res.trace.objective)
    assert torch.equal(ref.x, res.x) and torch.equal(ref.z, res.z)
    # a resume after the final segment rebuilds z from the saved x
    again = _solve(prob, "fused", spec, ckpt_dir=tmp_path, resume=True, **kw)
    assert torch.equal(again.x, ref.x)
    torch.testing.assert_close(again.z, ref.z, rtol=1e-5, atol=1e-5)


def test_arguments_are_checked(one_rank, jprobs):
    dense, sparse = (_port_problem(jprobs[k]) for k in ("dense", "sparse"))
    spec = SolverSpec(rounds=ROUNDS)
    bad = [
        (dict(engine="warp"), "unknown engine"),
        (dict(spec=SolverSpec(rounds=ROUNDS, merge="async")),
         "unknown merge"),
        (dict(compression="zip"), "unknown compression"),
        (dict(engine="sparse_fused"), "needs a BlockedCSC design"),
        (dict(engine="fused", K=9), "local blocks"),
        (dict(engine="fused", spec=SolverSpec(rounds=30, merge="launch")),
         "not divisible by merge_rounds"),
        (dict(trace_every=5), "not divisible by trace_every"),
        (dict(hierarchical=True), "needs a FeatureGroup"),
        (dict(ckpt_dir="/nonexistent"), "need ckpt_every"),
        (dict(ckpt_every=3), "must be a multiple of trace_every"),
        (dict(engine="fused", blk_idx=np.zeros((2, ROUNDS, 2), np.int32)),
         "blk_idx shape"),
        (dict(engine="fused", blk_idx=np.full((1, ROUNDS, 2), 99, np.int32)),
         r"must lie in \[0, 8\)"),
        (dict(engine="block", spec=SolverSpec(rounds=ROUNDS, fused=True,
                                              newton=True)),
         "newton=True requires a fused"),
    ]
    for kw, msg in bad:
        kw = {"engine": "scalar", "spec": spec, **kw}
        with pytest.raises(ValueError, match=msg):
            tsh.shotgun_sharded_solve(dense, **kw)
    with pytest.raises(ValueError, match="needs a dense design"):
        tsh.shotgun_sharded_solve(sparse, spec=spec, engine="fused")
    with pytest.raises(ValueError, match="does not match problem loss"):
        tsh.shotgun_sharded_solve(dense, spec=SolverSpec(loss="logistic"))
    with pytest.raises(TypeError, match="spec="):
        tsh.shotgun_sharded_solve(dense)


def test_uninitialized_process_group_raises(monkeypatch):
    monkeypatch.setattr(tsh.dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="not initialized"):
        tsh.make_feature_group()


# ---------------------------------------------------------------------------
# Two and four gloo ranks, in child processes
# ---------------------------------------------------------------------------

WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import convert
from repro_torch.core.health import GuardConfig, SolverFailure
from repro_torch.core.sharded import make_feature_group, shotgun_sharded_solve
from repro_torch.core.spec import SolverSpec
from repro_torch.dist.faults import FaultPlan

rank, world = int(sys.argv[1]), int(sys.argv[2])
store, inp, out = sys.argv[3], sys.argv[4], sys.argv[5]
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
d = np.load(inp)
R, ROUNDS, TRACE, K = (int(v) for v in d["cfg"])
dense = convert.problem_from_numpy(d["A"], d["y"], float(d["lam"]), "lasso",
                                   device="cpu")
S = convert.bcsc_from_numpy(d["rows"], d["vals"], int(d["n"]), int(d["d"]),
                            device="cpu")
sparse = convert.problem_from_numpy(S, d["y"], float(d["lam"]), "lasso",
                                    device="cpu")
res = {}


def run(tag, prob, engine, pipeline=False, guard=None, **kw):
    spec = SolverSpec(rounds=ROUNDS, merge="launch", pipeline=pipeline,
                      guard=guard)
    r = shotgun_sharded_solve(prob, spec=spec, engine=engine, K=K,
                              rounds_per_launch=R, trace_every=TRACE, **kw)
    res[tag + "_f"] = r.trace.objective.numpy()
    res[tag + "_nnz"] = r.trace.nnz.numpy()
    res[tag + "_x"] = r.x.numpy()
    res[tag + "_z"] = r.z.numpy()
    res[tag + "_status"] = np.int32(r.status)


for pipe in (False, True):
    tag = "pipe" if pipe else "sync"
    run("dense_" + tag, dense, "fused", pipe, blk_idx=d["dense_draws"])
    run("sparse_" + tag, sparse, "sparse_fused", pipe,
        blk_idx=d["sparse_draws"])
plan = FaultPlan(corrupt_prob=0.3, max_retries=8)
if world == 2:
    run("faults", dense, "fused", faults=plan, blk_idx=d["dense_draws"])
    run("bf16", dense, "fused", compression="bf16", blk_idx=d["dense_draws"])
    run("guarded", sparse, "sparse_fused", True, GuardConfig(),
        blk_idx=d["sparse_draws"])
    ck = dict(ckpt_every=2, seed=5)
    run("ckpt_ref", dense, "fused", True, **ck)
    for tag, kill in (("resumed", out + "/ck_resume"), ("saved", out + "/ck_1")):
        try:
            run(tag, dense, "fused", True, ckpt_dir=kill, fail_at_merge=4,
                **ck)
        except SolverFailure:
            res[tag + "_died"] = np.int32(1)
    run("resumed", dense, "fused", True, ckpt_dir=out + "/ck_resume",
        resume=True, **ck)
else:
    fg = make_feature_group(inner=2)
    run("hier", dense, "fused", group=fg, hierarchical=True,
        blk_idx=d["dense_draws"])
    run("hier_faults", dense, "fused", group=fg, hierarchical=True,
        faults=plan, blk_idx=d["dense_draws"])
    run("hier_pipe", dense, "fused", True, group=fg, hierarchical=True,
        blk_idx=d["dense_draws"])
if rank == 0:
    np.savez(out + "/result.npz", **res)
dist.destroy_process_group()
"""


def _spawn(world, tmp, payload):
    np.savez(tmp / "in.npz", **payload)
    ranks.spawn_code(WORKER, world, str(tmp / "in.npz"), str(tmp),
                     timeout_s=240)
    return dict(np.load(tmp / "result.npz"))


def _ranks(world, jprobs, tmp_path_factory):
    K = 2 if world == 2 else 1
    refs = {}
    for kind in ("dense", "sparse"):
        engine = "sparse_fused" if kind == "sparse" else "fused"
        for pipe in (False, True):
            refs[f"{kind}_{'pipe' if pipe else 'sync'}"] = jax_loop(
                jprobs[kind], engine, world, K=K, pipeline=pipe)
    jd, js = jprobs["dense"], jprobs["sparse"]
    payload = dict(
        A=np.asarray(jd.A), y=np.asarray(jd.y), lam=np.float32(jd.lam),
        rows=np.asarray(js.A.rows), vals=np.asarray(js.A.vals),
        n=np.int64(js.A.n), d=np.int64(js.A.d),
        cfg=np.array([R, ROUNDS, TRACE, K]),
        dense_draws=refs["dense_sync"]["draws"],
        sparse_draws=refs["sparse_sync"]["draws"])
    tmp = tmp_path_factory.mktemp(f"ranks{world}")
    return refs, _spawn(world, tmp, payload), tmp


@pytest.fixture(scope="module")
def two_ranks(jprobs, tmp_path_factory):
    return _ranks(2, jprobs, tmp_path_factory)


@pytest.fixture(scope="module")
def four_ranks(jprobs, tmp_path_factory):
    return _ranks(4, jprobs, tmp_path_factory)


CELLS = ["dense_sync", "dense_pipe", "sparse_sync", "sparse_pipe"]


@pytest.mark.parametrize("cell", CELLS)
def test_two_ranks_match_jax_loop(two_ranks, cell):
    refs, res, _ = two_ranks
    _assert_matches(res[cell + "_f"], res[cell + "_x"], res[cell + "_z"],
                    refs[cell])


@pytest.mark.parametrize("cell", CELLS)
def test_four_ranks_match_jax_loop(four_ranks, cell):
    refs, res, _ = four_ranks
    _assert_matches(res[cell + "_f"], res[cell + "_x"], res[cell + "_z"],
                    refs[cell])


def test_two_ranks_corrupt_faults_with_retries_equal_clean(two_ranks):
    _, res, _ = two_ranks
    for what in ("f", "x", "z"):
        np.testing.assert_array_equal(res["faults_" + what],
                                      res["dense_sync_" + what])


def test_two_ranks_bf16_wire_within_one_percent(two_ranks):
    _, res, _ = two_ranks
    f16, f32 = float(res["bf16_f"][-1]), float(res["dense_sync_f"][-1])
    assert abs(f16 - f32) / abs(f32) < 0.01
    assert not np.array_equal(res["bf16_x"], res["dense_sync_x"])


def test_two_ranks_guarded_pipeline_is_healthy(two_ranks):
    _, res, _ = two_ranks
    f = res["guarded_f"]
    assert int(res["guarded_status"]) == 0
    assert np.all(np.isfinite(f)) and f[-1] < f[0]


def test_two_ranks_kill_and_resume_is_bitwise(two_ranks):
    _, res, _ = two_ranks
    assert int(res["resumed_died"]) == 1 and int(res["saved_died"]) == 1
    for what in ("f", "nnz", "x", "z"):
        np.testing.assert_array_equal(res["resumed_" + what],
                                      res["ckpt_ref_" + what])


def test_resume_on_one_rank_after_two_rank_save(one_rank, two_ranks,
                                                jprobs):
    """The two-rank run died after merge 4 with its checkpoint saved; one
    rank resumes it: the saved trace prefix comes back bit for bit and the
    rest converges to the two-rank run's optimum."""
    _, res, tmp = two_ranks
    prob = _port_problem(jprobs["dense"])
    r = _solve(prob, "fused", SolverSpec(rounds=ROUNDS, merge="launch",
                                         pipeline=True),
               K=2, trace_every=TRACE, ckpt_every=2, seed=5,
               ckpt_dir=tmp / "ck_1", resume=True)
    f, ref = r.trace.objective.numpy(), res["ckpt_ref_f"]
    n_pre = 4 // TRACE
    np.testing.assert_array_equal(f[:n_pre], ref[:n_pre])
    assert np.all(np.isfinite(f)) and int(r.status) == 0
    assert np.all(np.diff(f[n_pre - 1:]) < 0)       # the solve goes on


def test_four_ranks_hierarchical_equals_flat(four_ranks):
    _, res, _ = four_ranks
    for tag in ("hier", "hier_faults"):
        np.testing.assert_allclose(res[tag + "_f"], res["dense_sync_f"],
                                   rtol=1e-5)
        np.testing.assert_allclose(res[tag + "_x"], res["dense_sync_x"],
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(res["hier_pipe_f"], res["dense_pipe_f"],
                               rtol=1e-5)
