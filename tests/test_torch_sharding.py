"""The port's sharding layer (``repro_torch.models.sharding``,
``launch/mesh.py``, ``launch/specs.py``) against the JAX package's.

- Rules: every leaf's parameter, cache, batch and train-state spec equals
  the reference's (its group axis dropped for a per-layer leaf) for the
  ten configurations at full shape (meta tensors, eval_shape) and at the
  smoke size, on the (16, 16), (2, 16, 16) and (2, 4) meshes, under the
  default policy and with each flag flipped alone.  Both sides read a
  mesh only through its axis names and sizes, so stand-in meshes carry no
  devices.
- Placements: on a fake process group, each placed leaf's local shape is
  the shard shape of the reference's spec.
- Stand-ins: every ``launch/specs.py`` tensor has the reference's shape
  and dtype.
- Numerics across ranks: four gloo ranks on a (2, 2) mesh run the Qwen3
  and Granite-MoE smoke configs on the reference's weights — one train
  step, a prefill and two per-slot decode steps — against the JAX
  single-device runs, at the tolerances of ``test_torch_lm_families.py``
  (logits 1e-5 of the largest) and ``test_torch_train_step.py`` (loss
  1e-5, grad norm 1e-6 of the float64 norm, moments 1e-4 and 2e-4,
  parameters 1e-4 or 4·lr where the grad is near zero).
- Constraints are no-ops on plain tensors: a forward with and without
  ``activation_axes`` is the same bit for bit."""
import contextlib
import dataclasses
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import sharding as JSH  # noqa: E402
from repro.models import steps as JS  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.dist import ranks  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as MS  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import sharding as SH  # noqa: E402
from repro_torch.models import steps as S  # noqa: E402
import test_torch_lm_families as FAM  # noqa: E402
import test_torch_train_step as TRS  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
FLAGS = [f.name for f in dataclasses.fields(SH.ShardingPolicy)]
POLICIES = [{}] + [{f: not getattr(SH.ShardingPolicy(), f)} for f in FLAGS]
SIZES = ("full", "smoke")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def jmesh(name):
    shape, names = MESHES[name]
    return types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, shape)))


def tmesh(name):
    shape, names = MESHES[name]
    return types.SimpleNamespace(mesh_dim_names=names, shape=shape)


def configs(arch, size):
    if size == "full":
        return JARCHS[arch].CONFIG, ARCHS[arch].CONFIG
    return JARCHS[arch].smoke_config(), ARCHS[arch].smoke_config()


def jflat(tree):
    """{``/``-joined path: spec} of a reference spec tree."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {JSH._path_str(p): tuple(v) for p, v in leaves}


@functools.lru_cache(maxsize=None)
def jparams(arch, size):
    return JSP.param_specs_shapes(configs(arch, size)[0])


@functools.lru_cache(maxsize=None)
def tparams(arch, size):
    return SP.param_specs_shapes(configs(arch, size)[1])


def per_layer(ref, stacked):
    return ref[1:] if stacked else ref


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_reference(arch, mesh):
    for size in SIZES:
        _, tc = configs(arch, size)
        layout = M.ref_layout(tc)
        for kw in POLICIES:
            want = jflat(JSH.param_specs(jparams(arch, size), jmesh(mesh),
                                         JSH.ShardingPolicy(**kw)))
            got = SH.param_specs(tparams(arch, size), tmesh(mesh),
                                 SH.ShardingPolicy(**kw))
            assert sorted(want) == sorted(layout)
            for ref, (stacked, paths) in layout.items():
                for path in paths:
                    assert tuple(T.get(got, path)) == per_layer(
                        want[ref], stacked), (size, kw, ref, path)


def _cache_pair(arch, batch, seq):
    jc, tc = configs(arch, "full")
    return (jax.eval_shape(lambda: JM.init_cache(jc, batch, seq)),
            M.init_cache(tc, batch, seq, device="meta"), tc)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_and_batch_specs_match_reference(arch):
    for batch, seq in ((128, 32768), (1, 524288), (6, 64)):
        jcache, tcache, tc = _cache_pair(arch, batch, seq)
        P = len(tc.pattern)
        for mesh in MESHES:
            for kw in POLICIES:
                want = jflat(JSH.cache_specs(jcache, jmesh(mesh),
                                             JSH.ShardingPolicy(**kw)))
                got = SH.cache_specs(tcache, tmesh(mesh),
                                     SH.ShardingPolicy(**kw))
                items = list(T.items(got))
                assert items
                for path, spec in items:
                    layer, sub = path[1], path[2:]
                    ref = "/".join(("blocks", f"l{layer % P}") + sub)
                    assert tuple(spec) == want[ref][1:], (mesh, kw, path)
    jc, tc = configs(arch, "full")
    for name, info in SHAPES.items():
        seq, batch = info["seq"], info["batch"]
        for jfn, tfn in ((JSP.train_batch_specs, SP.train_batch_specs),
                         (JSP.prefill_batch_specs, SP.prefill_batch_specs)):
            for mesh in MESHES:
                for kw in POLICIES:
                    want = jflat(JSH.batch_specs(jfn(jc, seq, batch),
                                                 jmesh(mesh),
                                                 JSH.ShardingPolicy(**kw)))
                    got = SH.batch_specs(tfn(tc, seq, batch), tmesh(mesh),
                                         SH.ShardingPolicy(**kw))
                    assert {k: tuple(v) for k, v in got.items()} == want


@functools.lru_cache(maxsize=None)
def _states(arch, opt):
    jc, tc = configs(arch, "full")
    jc = dataclasses.replace(jc, optimizer=opt)
    tc = dataclasses.replace(tc, optimizer=opt)
    js = jax.eval_shape(lambda: JS.init_train_state(jc,
                                                    jax.random.PRNGKey(0)))
    return js, S.init_train_state(tc, device="meta"), tc


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_state_specs_match_reference(arch, opt):
    js, ts, tc = _states(arch, opt)
    layout = M.ref_layout(tc)
    for mesh in MESHES:
        for kw in ({}, {"fsdp": False}):
            jp = JSH.param_specs(js.params, jmesh(mesh),
                                 JSH.ShardingPolicy(**kw))
            want = JSH.train_state_specs(js, jp, jmesh(mesh))
            tp = SH.param_specs(ts.params, tmesh(mesh),
                                SH.ShardingPolicy(**kw))
            got = SH.train_state_specs(ts, tp, tmesh(mesh),
                                       stacks=layout if opt == "adafactor"
                                       else None)
            assert tuple(got.step) == tuple(want.step) == ()
            assert tuple(got.opt.count) == tuple(want.opt.count)
            if opt == "adamw":
                for name in ("mu", "nu"):
                    ref = jflat(getattr(want.opt, name))
                    for key, (stacked, paths) in layout.items():
                        for path in paths:
                            assert tuple(T.get(getattr(got.opt, name),
                                               path)) == per_layer(
                                ref[key], stacked), (mesh, name, key)
            else:
                for name in ("vr", "vc", "v"):
                    ref = jflat(getattr(want.opt, name))
                    mine = getattr(got.opt, name)
                    assert sorted(mine) == sorted(ref)
                    for key in ref:
                        assert tuple(mine[key]) == ref[key], (mesh, name,
                                                              key)


def test_placements_give_the_reference_shard_shapes():
    """On a fake process group of 8 ranks: every leaf of a full-width
    Qwen3 layer, Granite's experts, a head-major KV cache and an embedding
    split over two axes, placed by its spec, has the local shape of the
    reference's spec."""
    cases = []
    for arch in ("qwen3-4b", "granite-moe-1b-a400m"):
        jc, tc = configs(arch, "full")
        cut = dataclasses.replace(tc, num_layers=1, vocab_size=512)
        jcut = dataclasses.replace(jc, num_layers=1, vocab_size=512)
        want = jflat(JSH.param_specs(JSP.param_specs_shapes(jcut),
                                     jmesh("2x4"), JSH.ShardingPolicy()))
        params = SP.param_specs_shapes(cut, device="cpu")
        for ref, (stacked, paths) in M.ref_layout(cut).items():
            cases.append((T.get(params, paths[0]),
                          per_layer(want[ref], stacked)))
        for kw in POLICIES:
            jcache = jax.eval_shape(lambda: JM.init_cache(jcut, 4, 64))
            wc = jflat(JSH.cache_specs(jcache, jmesh("2x4"),
                                       JSH.ShardingPolicy(**kw)))
            tcache = M.init_cache(cut, 4, 64, device="cpu")
            for path, leaf in T.items(tcache):
                cases.append((leaf, wc["/".join(("blocks", "l0")
                                                + path[2:])][1:]))
    sizes = dict(zip(*reversed(MESHES["2x4"])))
    with D.fake_group(8):
        mesh = D.make_mesh(*MESHES["2x4"], device="cpu")
        for leaf, spec in cases:
            names = [a for e in spec if e is not None
                     for a in (e if isinstance(e, tuple) else (e,))]
            if len(names) != len(set(names)):
                # batch and sequence both on data (cache_seq_on_fsdp with
                # a batch that divides): NamedSharding refuses it as well
                with pytest.raises(ValueError, match="twice"):
                    SH.distribute(leaf, SH.P(*spec), mesh)
                continue
            placed = SH.distribute(leaf, SH.P(*spec), mesh)
            shard = tuple(
                n // int(np.prod([sizes[a] for a in (
                    e if isinstance(e, tuple) else (e,))]))
                if e is not None else n for n, e in zip(leaf.shape, spec))
            assert tuple(placed.to_local().shape) == shard, spec
            assert placed.shape == leaf.shape
            assert placed.stride() == leaf.stride()


def _dtype(x):
    return str(x.dtype).replace("torch.", "")


def _same(t, j, what):
    assert tuple(t.shape) == tuple(j.shape), what
    assert _dtype(t) == str(j.dtype), what


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_stand_ins_match_reference(arch):
    jc, tc = configs(arch, "full")
    P = len(tc.pattern)
    for name, info in SHAPES.items():
        seq, batch = info["seq"], info["batch"]
        for jfn, tfn in ((JSP.train_batch_specs, SP.train_batch_specs),
                         (JSP.prefill_batch_specs, SP.prefill_batch_specs)):
            want, got = jfn(jc, seq, batch), tfn(tc, seq, batch)
            assert sorted(want) == sorted(got)
            for k in want:
                _same(got[k], want[k], (name, k))
                assert got[k].device.type == "meta"
        want = JSP.decode_arg_specs(jc, seq, batch)
        got = SP.decode_arg_specs(tc, seq, batch)
        assert sorted(want) == sorted(got)
        for k in want:
            if k != "cache":
                _same(got[k], want[k], (name, k))
        wc = _sds(want["cache"])
        for path, leaf in T.items(got["cache"]):
            ref = "/".join(("blocks", f"l{path[1] % P}") + path[2:])
            assert tuple(leaf.shape) == wc[ref][0][1:], (name, path)
            assert _dtype(leaf) == wc[ref][1], (name, path)
    layout = M.ref_layout(tc)
    js, ts = JSP.state_specs(jc), SP.state_specs(tc)
    want = _sds(js.params)
    for ref, (stacked, paths) in layout.items():
        for path in paths:
            leaf = T.get(ts.params, path)
            assert tuple(leaf.shape) == per_layer(want[ref][0], stacked)
            assert _dtype(leaf) == want[ref][1]
    assert _dtype(ts.step) == str(js.step.dtype)
    wp = _sds(JSP.param_specs_shapes(jc))
    tp = SP.param_specs_shapes(tc)
    for ref, (stacked, paths) in layout.items():
        leaf = T.get(tp, paths[0])
        assert tuple(leaf.shape) == per_layer(wp[ref][0], stacked)


def _sds(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {JSH._path_str(p): (tuple(x.shape), str(x.dtype))
            for p, x in leaves}


# ---------------------------------------------------------------------------
# numerics on four gloo ranks
# ---------------------------------------------------------------------------

RANKS_CODE = r'''
import dataclasses
import sys
import numpy as np
import torch
from repro_torch.dist import ranks
rank, world, store, tmp, *archs = (int(sys.argv[1]), int(sys.argv[2]),
                                   *sys.argv[3:])
torch.set_num_threads(1)
ranks.join_group(rank, world, store)
from repro_torch import convert, tree as T
from repro_torch.configs import ARCHS
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as M, sharding as SH, steps as S
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
pol = SH.ShardingPolicy()
rows = SH.P("data", None)


def run(arch, z):
    cfg = ARCHS[arch].smoke_config()
    flat = lambda pre: {k[2:]: z[k] for k in z.files if k.startswith(pre)}
    params = convert.lm_params_from_numpy(cfg, flat("p/"), device="cpu")
    dp = SH.distribute_tree(params, SH.param_specs(params, mesh, pol), mesh)
    toks = torch.from_numpy(z["tokens"].astype(np.int64))
    half, smax = 12, 24
    found = {}
    # decode with the cache's heads' dims on model, then with its
    # sequence on model (the partitioned softmax)
    for tag, policy in (("", pol), ("_seq", SH.ShardingPolicy(
            cache_seq_on_tensor=True))):
        with SH.activation_axes(mesh, policy), torch.no_grad():
            prefill, cache = M.forward(
                cfg, dp, {"tokens": SH.distribute(toks[:, :half], rows,
                                                  mesh)},
                make_cache_len=smax)
            logs = []
            for t in range(half, half + 2):
                pos = SH.distribute(torch.tensor([[t], [t - 7]]), rows, mesh)
                tok = SH.distribute(toks[:, t:t + 1], rows, mesh)
                lg, cache = M.decode_step(cfg, dp, tok, cache, pos)
                logs.append(lg.full_tensor())
        found["decode" + tag] = torch.cat(logs, 1).numpy()
    state = convert.train_state_from_numpy(cfg, flat("s/"), device="cpu")
    pspecs = SH.param_specs(state.params, mesh, pol)
    ds = SH.distribute_tree(state, SH.train_state_specs(
        state, pspecs, mesh, stacks=M.ref_layout(cfg)
        if cfg.optimizer == "adafactor" else None), mesh)
    tb = {k: torch.from_numpy(v.astype(np.int64))
          for k, v in flat("b/").items()}
    db = SH.distribute_tree(tb, SH.batch_specs(tb, mesh, pol), mesh)
    with SH.activation_axes(mesh, pol):
        ds, metrics = S.make_train_step(cfg, lr=float(z["lr"]))(ds, db)
    full = T.unflatten(ds, [x.full_tensor() for x in T.leaves(ds)])
    found.update(prefill=prefill.full_tensor().numpy(),
                 loss=float(metrics["loss"].full_tensor()),
                 gnorm=float(metrics["grad_norm"].full_tensor()))
    if rank == 0:
        got = convert.train_state_to_numpy(cfg, full)
        np.savez(f"{tmp}/{arch}.out.npz", **found,
                 **{"s/" + k: v for k, v in got.items()})


def capacity(z):
    """Granite's loss and grads on the MoE capacity path (a group of 512
    tokens a data rank, picks dropped)."""
    cfg = dataclasses.replace(ARCHS["granite-moe-1b-a400m"].smoke_config(),
                              moe_capacity_factor=0.25)
    state = convert.train_state_from_numpy(
        cfg, {k[2:]: z[k] for k in z.files if k.startswith("s/")},
        device="cpu")
    dp = SH.distribute_tree(state.params, SH.param_specs(state.params, mesh,
                                                         pol), mesh)
    tb = {k[2:]: torch.from_numpy(z[k].astype(np.int64))
          for k in z.files if k.startswith("b/")}
    db = SH.distribute_tree(tb, SH.batch_specs(tb, mesh, pol), mesh)
    with SH.activation_axes(mesh, pol):
        loss, grads = S.loss_and_grads(cfg, dp, db)
    loss, grads = float(loss.full_tensor()), [g.full_tensor() for g in grads]
    if rank == 0:
        got = convert.lm_params_to_numpy(cfg, T.unflatten(dp, grads))
        np.savez(f"{tmp}/capacity.out.npz", loss=loss, **got)


for arch in archs:
    run(arch, np.load(f"{tmp}/{arch}.npz"))
capacity(np.load(f"{tmp}/capacity.npz"))
'''


RANK_ARCHS = ("qwen3-4b", "granite-moe-1b-a400m")
# Granite at 2 x 512 tokens takes the MoE capacity path, a group a data
# rank; a capacity factor of 0.25 drops picks
CAPACITY_ARCH, CAPACITY = "granite-moe-1b-a400m", {"moe_capacity_factor": 0.25}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """{arch: the four ranks' prefill and decode logits and one train
    step}, on the reference's weights and ``TRS.batch_pair``'s batch,
    from one set of ranks."""
    tmp = str(tmp_path_factory.mktemp("ranks"))
    for arch in RANK_ARCHS:
        _, _, jp, _ = FAM.carried(arch)
        _, _, _, state_flat = TRS.carried(arch)
        jb, _ = TRS.batch_pair(ARCHS[arch].smoke_config())
        np.savez(f"{tmp}/{arch}.npz",
                 tokens=FAM.reference_runs(arch)["tokens"], lr=TRS.LR,
                 **{"p/" + k: v for k, v in FAM.flat(jp).items()},
                 **{"s/" + k: v for k, v in state_flat.items()},
                 **{"b/" + k: np.asarray(v) for k, v in jb.items()})
    _, tc, _, state_flat = TRS.carried(CAPACITY_ARCH, **CAPACITY)
    _, tb = TRS.batch_pair(tc, rows=2, seq=512)
    np.savez(f"{tmp}/capacity.npz",
             **{"s/" + k: v for k, v in state_flat.items()},
             **{"b/" + k: v.numpy() for k, v in tb.items()})
    ranks.spawn_code(RANKS_CODE, 4, tmp, *RANK_ARCHS, timeout_s=300)
    return {arch: dict(np.load(f"{tmp}/{arch}.out.npz"))
            for arch in RANK_ARCHS + ("capacity",)}


@pytest.mark.parametrize("arch", RANK_ARCHS)
def test_four_ranks_match_reference(arch, four_ranks):
    got = four_ranks[arch]
    ref = FAM.reference_runs(arch)
    FAM.close(got["prefill"], ref["prefill"], FAM.TOL[FAM.F32])
    FAM.close(got["decode"], ref["vector"][0][:, :2], FAM.TOL[FAM.F32])
    FAM.close(got["decode_seq"], ref["vector"][0][:, :2], FAM.TOL[FAM.F32])
    step = TRS.ref_step(arch)
    grads = TRS.ref_grads(arch)
    exact = np.sqrt(sum((np.asarray(g, np.float64) ** 2).sum()
                        for g in grads["grads"].values()))
    loss, gnorm = float(got["loss"]), float(got["gnorm"])
    assert abs(gnorm - exact) <= 1e-6 * exact, (gnorm, exact)
    assert abs(loss - step["loss"]) <= 1e-5 * abs(step["loss"])
    state = {k[2:]: v for k, v in got.items() if k.startswith("s/")}
    assert sorted(state) == sorted(step["state"])
    mine, theirs = TRS.clip_scale(gnorm), TRS.clip_scale(step["gnorm"])
    for k, want in step["state"].items():
        name = k.split("/")[1] if k.startswith("opt/") else None
        if name == "mu":
            TRS.leaf_close(state[k] / mine, want / theirs, 1e-4, k)
        elif name in ("nu", "vr", "vc", "v"):
            TRS.leaf_close(state[k] / mine ** 2, want / theirs ** 2, 2e-4, k)
        elif k.startswith("params/"):
            g = np.abs(grads["grads"][k[len("params/"):]])
            sharp = g >= 1e-3 * g.max()
            err = np.abs(np.asarray(state[k], np.float64) - want)
            assert err[sharp].max(initial=0) <= 1e-4 * np.abs(want).max(), k
            assert err[~sharp].max(initial=0) <= 4 * TRS.LR, k


def test_four_ranks_capacity_path_grads_match_reference(four_ranks):
    """The sharded MoE capacity path (each data rank's group, the experts'
    input products split over D on model, their outputs over E): the loss
    and every grad against the reference's, as
    ``test_torch_train_step_families`` holds the plain path."""
    got = four_ranks["capacity"]
    ref = TRS.ref_grads(CAPACITY_ARCH, rows=2, seq=512, **CAPACITY)
    assert abs(float(got["loss"]) - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    assert sorted(k for k in got if k != "loss") == sorted(ref["grads"])
    for k, want in ref["grads"].items():
        TRS.leaf_close(got[k], want, 1e-4, k)


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-1b-a400m"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_rank_grads_are_bit_for_bit(arch, dtype):
    """On a (1, 1) mesh every DTensor op runs the plain op on the whole
    tensor, so the loss and every grad equal the plain tensors' bit for
    bit (a local computation's grad keeps its layout)."""
    cfg = dataclasses.replace(ARCHS[arch].smoke_config(),
                              compute_dtype=dtype)
    toks = torch.randint(0, cfg.vocab_size, (2, 17),
                         generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    pol = SH.ShardingPolicy()
    params = M.init(cfg, torch.Generator().manual_seed(1))
    want = S.loss_and_grads(cfg, params, batch)
    with ranks.one_rank("gloo"):
        mesh = MS.make_mesh((1, 1), ("data", "model"), device="cpu")
        dp = SH.distribute_tree(params, SH.param_specs(params, mesh, pol),
                                mesh)
        db = SH.distribute_tree(batch, SH.batch_specs(batch, mesh, pol),
                                mesh)
        with SH.activation_axes(mesh, pol):
            loss, grads = S.loss_and_grads(cfg, dp, db)
        got = [loss.full_tensor()] + [g.full_tensor() for g in grads]
    for a, b in zip(got, [want[0]] + want[1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-1b-a400m",
                                  "jamba-1.5-large-398b"])
def test_constraints_are_no_ops_without_a_mesh(arch):
    """``activation_axes`` over plain tensors changes no bit of a forward
    (Granite at 1024 tokens: the MoE capacity path), a prefill and a
    decode step."""
    cfg = ARCHS[arch].smoke_config()
    params = M.init(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (4, 256),
                         generator=torch.Generator().manual_seed(1))
    runs = []
    for on in (False, True):
        ctx = (SH.activation_axes(tmesh("2x4"), SH.ShardingPolicy()) if on
               else contextlib.nullcontext())
        with ctx, torch.no_grad():
            full, _ = M.forward(cfg, params, {"tokens": toks})
            pre, cache = M.forward(cfg, params, {"tokens": toks[:, :128]},
                                   make_cache_len=160)
            dec, _ = M.decode_step(cfg, params, toks[:, 128:129], cache,
                                   torch.tensor([128, 100, 128, 7]))
        runs.append((full, pre, dec))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_mesh_needs_a_process_group_of_its_size():
    with pytest.raises(RuntimeError, match="initialized process group"):
        MS.make_mesh((2, 2), ("data", "model"), device="cpu")
    with D.fake_group(8):
        with pytest.raises(RuntimeError, match="8"):
            MS.make_production_mesh(device="cpu")
        m = MS.make_host_mesh(model=4, device="cpu")
        assert m.mesh_dim_names == ("data", "model") and tuple(m.shape) == (
            2, 4)
