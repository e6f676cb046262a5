"""Multi-pod dry-run (port of ``repro.launch.dryrun``): every (arch x
input-shape x mesh) cell's step run once on a fake process group, with
rank 0's view of its cost turned into the three roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Where the reference lowers and compiles each cell on 512 fake host devices
and reads XLA's cost and memory analysis, the port has no compiler to ask:
it initializes a fake process group of 256 (single) or 512 (multi) ranks
in this process, builds every parameter, state, batch and cache leaf as a
DTensor placed by ``models.sharding``'s rules under ``FakeTensorMode``
(nothing is allocated), runs the step once, and records what rank 0 does:

- flops: the local products' (``torch.utils.flop_counter``'s formulas on
  the local shapes — a DTensor-level count would give the global product);
- bytes: operand plus result bytes of every local operation that is not
  a view — an unfused, eager count, where XLA's counts fused kernels;
- collectives: the result bytes of each ``c10d_functional`` collective,
  by kind, as the reference's ``collective_bytes`` sums them;
- memory: argument bytes (the local shards of the inputs), output bytes,
  and the peak of the bytes allocated during the step and still live.

The terms use the H100 SXM data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s
HBM3, 450 GB/s of NVLink a direction.  Results go to ``build/dryrun/``.
The device type is the card's (``--device cuda``, the default) or the
CPU's (``--device cpu``); the fake tensors allocate on neither.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import sys
import time
import weakref

import torch
import torch.distributed as dist
from torch._guards import active_fake_mode
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch import tree as T
from repro_torch.configs import ARCHS
from repro_torch.configs.common import SHAPES
from repro_torch.device import resolve_device
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as M
from repro_torch.models import sharding as SH
from repro_torch.models import steps as S

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"

# NVIDIA H100 SXM data sheet
PEAK_FLOPS = 989e12          # dense bf16 FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
LINK_BW = 450e9              # NVLink bytes/s, one direction

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}

# c10d_functional collective -> the reference's HLO name for it
COLLECTIVES = {"all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "all_reduce": "all-reduce",
               "all_reduce_coalesced": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all",
               "broadcast": "collective-permute"}


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


class _Depth:
    """A reusable context manager counting how deep it is entered: the
    blocks whose operations are DTensor's propagation, not the step's
    (see ``_dtensor_under_fake``)."""

    def __init__(self):
        self.depth = 0

    def __enter__(self):
        self.depth += 1

    def __exit__(self, *exc):
        self.depth -= 1


class StepCost(TorchDispatchMode):
    """Counts this rank's local work under ``fake`` (or, with ``fake``
    None, on real tensors): DTensor ops are passed on (``NotImplemented``)
    so that their local operations come back here; operations that
    DTensor's sharding propagation runs in a fake mode of its own are not
    counted."""

    def __init__(self, fake: FakeTensorMode | None = None):
        super().__init__()
        self.fake = fake
        self.flops = 0
        self.bytes = 0
        self.coll: dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self._seen: dict[int, weakref.ref] = {}
        self.propagating = _Depth()

    def _track(self, out) -> None:
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            ref = self._seen.get(key)
            if ref is not None and ref() is st:
                continue
            n = st.nbytes()
            self._seen[key] = weakref.ref(st, self._freed(key, n))
            self.live += n
            self.peak = max(self.peak, self.live)

    def _freed(self, key, n):
        def cb(_):
            self.live -= n
            self._seen.pop(key, None)
        return cb

    def known(self, tree) -> None:
        """Storages alive before the step (its arguments): not counted as
        allocated during it."""
        for t in tree_leaves(tree):
            if isinstance(t, DTensor):
                t = t.to_local()
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                self._seen[id(st)] = weakref.ref(st)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if self.fake is not None and \
                func is torch.ops._c10d_functional.wait_tensor.default:
            return args[0]      # a fake wait would make a new tensor
        out = func(*args, **kwargs)
        if self.propagating.depth or active_fake_mode() is not self.fake:
            return out
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns == "_c10d_functional":
            kind = COLLECTIVES.get(name)     # not waits and wrappers
            if kind is not None:
                self.coll[kind] = self.coll.get(kind, 0) + sum(
                    _nbytes(t) for t in tree_leaves(out))
        elif not func.is_view and ns == "aten":
            count = flop_registry.get(func._overloadpacket)
            if count is not None:
                self.flops += count(*args, **kwargs, out_val=out)
            self.bytes += sum(_nbytes(t) for t in tree_leaves((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in tree_leaves(out))
        self._track(out)
        return out


@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks, this process rank 0, for
    the ``with`` block (collectives move nothing)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry-run needs a process without a process "
                           "group of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def model_flops(cfg, seq, batch, kind):
    """(6·N_active·D (train) or 2·N_active·D (inference), N total,
    N active): N without the embedding and the head, an expert counted at
    top_k / E."""
    total = active = 0
    for path, leaf in T.items(SP.param_specs_shapes(cfg)):
        pstr = SH.ref_path(path)
        n = math.prod(leaf.shape)
        total += n
        if "embed" in pstr or "head" in pstr:
            continue
        if "moe/" in pstr and "router" not in pstr:
            n = n * cfg.moe_top_k // max(cfg.num_experts, 1)
        active += n
    tokens = batch * (1 if kind == "decode" else seq)
    mult = 6.0 if kind == "train" else 2.0
    return mult * active * tokens, total, active


def build_lowerable(cfg, shape_name, mesh, policy: SH.ShardingPolicy,
                    grad_accum=None, *, device="meta"):
    """(fn, args, specs): the step, its stand-in arguments on ``device``
    and their specs, ready for ``place``.  A decode step's position is
    the cache's last (a Python int: the port's scalar decode reads it on
    the host)."""
    info = SHAPES[shape_name]
    seq, batch, kind = info["seq"], info["batch"], info["kind"]

    if kind == "train":
        if grad_accum is None:
            grad_accum = 8 if cfg.d_model >= 8192 else 4
        state = SP.state_specs(cfg, device=device)
        pspecs = SH.param_specs(state.params, mesh, policy)
        stacks = M.ref_layout(cfg) if cfg.optimizer == "adafactor" else None
        sspecs = SH.train_state_specs(state, pspecs, mesh, stacks=stacks)
        bshapes = SP.train_batch_specs(cfg, seq, batch, device=device)
        fn = S.make_train_step(cfg, grad_accum=grad_accum)
        return fn, (state, bshapes), (sspecs, SH.batch_specs(bshapes, mesh,
                                                             policy))

    params = SP.param_specs_shapes(cfg, device=device)
    pspecs = SH.param_specs(params, mesh, policy)
    if kind == "prefill":
        bshapes = SP.prefill_batch_specs(cfg, seq, batch, device=device)
        fn = S.make_prefill_step(cfg, cache_len=seq)
        return fn, (params, bshapes), (pspecs, SH.batch_specs(bshapes, mesh,
                                                              policy))

    dec = SP.decode_arg_specs(cfg, seq, batch, device=device)
    raw_step = S.make_decode_step(cfg)
    extras = [dec[k] for k in ("enc_out", "positions3") if k in dec]

    def fn(params, tokens, cache, *extra):
        kw = dict(zip([k for k in ("enc_out", "positions3") if k in dec],
                      extra))
        return raw_step(params, tokens, cache, seq - 1, **kw)

    args = (params, dec["tokens"], dec["cache"], *extras)
    specs = (pspecs, SH.batch_specs(dec["tokens"], mesh, policy),
             SH.cache_specs(dec["cache"], mesh, policy),
             *[SH.batch_specs(x, mesh, policy) for x in extras])
    return fn, args, specs


def place(args, specs, mesh):
    """Every leaf of ``args`` as a DTensor placed by its spec."""
    return tuple(SH.distribute_tree(a, s, mesh) for a, s in zip(args, specs))


def spec_bytes(args, specs, mesh) -> int:
    """Rank 0's bytes of ``args`` placed by ``specs``, from the specs."""
    return sum(math.prod(SH.shard_shape(x.shape, s, mesh)) * x.element_size()
               for a, sp in zip(args, specs)
               for x, s in zip(T.leaves(a), T.leaves(sp)))


@contextlib.contextmanager
def _dtensor_under_fake(cost: "StepCost"):
    """Two adjustments to DTensor for a step under ``FakeTensorMode``.

    - Its sharding propagation runs each new op once on fake tensors of
      the global shapes, in the active fake mode: those runs are marked so
      that ``cost`` does not count them (``_fake_mode_lock``, the hook it
      wraps them in, where this PyTorch has it; else DTensor is given no
      fake mode to find, and makes one of its own, which ``cost`` skips).
    - It computes a strided shard's offsets (a dimension folded from two
      sharded ones) with tensors it reads back, which a fake mode cannot
      read: it computes them outside the fake mode."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _sharding_prop, placement_types
    restore = []

    def patch(obj, name, value):
        restore.append((obj, name, obj.__dict__[name]))
        setattr(obj, name, value)

    prop = _sharding_prop.ShardingPropagator
    if "_fake_mode_lock" in prop.__dict__:
        patch(prop, "_fake_mode_lock", cost.propagating)
    else:
        patch(_sharding_prop, "detect_fake_mode", lambda *a: None)
    strided = getattr(placement_types, "_StridedShard", None)
    orig = None if strided is None else strided.__dict__.get(
        "local_shard_size_and_offset")
    if orig is not None:
        def outside(self, *args, **kw):
            with unset_fake_temporarily():
                return orig(self, *args, **kw)
        patch(strided, "local_shard_size_and_offset", outside)
    try:
        yield
    finally:
        for obj, name, value in reversed(restore):
            setattr(obj, name, value)


def step_cost(cfg, shape_name, mesh, policy, grad_accum=None, *,
              device) -> dict:
    """Run the cell's step once on fake DTensors; rank 0's counts."""
    with FakeTensorMode() as fake:
        cost = StepCost(fake)
        with _dtensor_under_fake(cost):
            fn, args, specs = build_lowerable(cfg, shape_name, mesh, policy,
                                              grad_accum, device=device)
            placed = place(args, specs, mesh)
            arg_bytes = sum(_nbytes(x.to_local()) for x in tree_leaves(placed)
                            if isinstance(x, DTensor))
            cost.known(placed)
            with SH.activation_axes(mesh, policy), cost:
                out = fn(*placed)
        out_bytes = sum(_nbytes(x.to_local() if isinstance(x, DTensor)
                                else x) for x in tree_leaves(out))
    return {"flops": float(cost.flops), "bytes": float(cost.bytes),
            "coll": {k: float(v) for k, v in cost.coll.items()},
            "memory": {"argument_bytes": arg_bytes,
                       "argument_bytes_from_specs": spec_bytes(args, specs,
                                                               mesh),
                       "output_bytes": out_bytes,
                       "temp_bytes": cost.peak}}


def _terms(flops, bytes_acc, coll_total) -> dict:
    return {"compute_s": flops / PEAK_FLOPS, "memory_s": bytes_acc / HBM_BW,
            "collective_s": coll_total / LINK_BW}


def _skip(arch, shape_name, mesh_kind, tag, out_path):
    supports = ARCHS[arch].SUPPORTS[shape_name]
    if not isinstance(supports, str):
        return None
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "tag": tag,
           "status": "skip", "reason": supports}
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def _cell(arch, shape_name, mesh_kind, policy, tag, mesh):
    """(config, policy, mesh shape and axes, the record's head)."""
    policy = policy or SH.ShardingPolicy()
    if SHAPES[shape_name]["kind"] == "decode":
        # production default: decode caches are kv-seq-sharded
        policy = dataclasses.replace(policy, cache_seq_on_tensor=True)
    shape, axes = mesh or MESHES[mesh_kind]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "tag": tag,
           "policy": dataclasses.asdict(policy),
           "devices": math.prod(shape)}
    return policy, shape, axes, rec


def _finish(rec, cfg, info, flops, bytes_acc, coll, devices) -> None:
    coll_total = float(sum(coll.values()))
    mf, n_total, n_active = model_flops(cfg, info["seq"], info["batch"],
                                        info["kind"])
    terms = _terms(flops, bytes_acc, coll_total)
    rec.update({
        "status": "ok",
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": bytes_acc,
        "collective_bytes_per_device": coll_total,
        "collectives": coll,
        "terms": terms,
        "bottleneck": max(terms, key=terms.get),
        "model_flops_global": mf,
        "model_flops_per_device": mf / devices,
        "params_total": n_total,
        "params_active": n_active,
        "useful_flops_ratio": (mf / devices) / flops if flops else 0.0,
    })


def _write(rec, out_path):
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             policy: SH.ShardingPolicy | None = None, tag: str = "baseline",
             force: bool = False, *, device="cuda", cfg_override=None,
             mesh=None) -> dict:
    """One cell at its configured depth, on a fake process group of the
    mesh's size made in this process (``mesh``: a (shape, axes) pair in
    place of the production mesh of ``mesh_kind``; ``cfg_override``: a
    config in place of the arch's)."""
    out_path = RESULTS / f"{arch}__{shape_name}__{mesh_kind}__{tag}.json"
    skipped = _skip(arch, shape_name, mesh_kind, tag, out_path)
    if skipped:
        return skipped
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    cfg = cfg_override or ARCHS[arch].CONFIG
    policy, shape, axes, rec = _cell(arch, shape_name, mesh_kind, policy,
                                     tag, mesh)
    dev = resolve_device(device)
    rec["device_type"] = dev.type
    t0 = time.time()
    try:
        with fake_group(math.prod(shape)):
            m = make_mesh(shape, axes, device=dev)
            c = step_cost(cfg, shape_name, m, policy, device=dev)
        rec["run_s"] = round(time.time() - t0, 1)
        rec["memory"] = c["memory"]
        _finish(rec, cfg, SHAPES[shape_name], c["flops"], c["bytes"],
                c["coll"], rec["devices"])
    except Exception as e:  # noqa: BLE001 — a failed cell is a recorded bug
        import traceback
        rec.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
    return _write(rec, out_path)


# ---------------------------------------------------------------------------
# Roofline measurement: an eager step at full depth costs minutes of Python
# dispatch for the largest configs.  Instead, as the reference does: run
# 1-group and 2-group variants with grad_accum 1, fit cost = overhead +
# G * per_group, and extrapolate to the real depth — exact for costs linear
# in depth, which layer flops, bytes and collectives are (embed, head,
# loss and optimizer live in the overhead term).  Every group costs the
# same because the model pins the residual stream's layout at each group
# boundary (``sharding.shard_btd``, where the reference's scan carry has one
# sharding): a decode step's residual otherwise leaves the first group
# Partial and enters every later group so, and the later groups' reductions
# differ from the first's.
# ---------------------------------------------------------------------------

def _shallow(cfg, k: int):
    kw = dict(num_layers=k * len(cfg.pattern), unroll_scan=True)
    if cfg.encoder_layers:
        # whisper: encoder depth == decoder depth, so scaling both keeps
        # the per-increment delta = (enc layer + dec layer)
        kw["encoder_layers"] = k
    return dataclasses.replace(cfg, **kw)


def extrapolate(a: float, b: float, groups: int) -> float:
    """The cost at ``groups`` groups from the 1-group cost ``a`` and the
    2-group cost ``b``, never below ``b``."""
    per = b - a
    return max(max(a - per, 0.0) + groups * per, b, 0.0)


def measure_cell(arch: str, shape_name: str, mesh_kind: str = "single",
                 policy: SH.ShardingPolicy | None = None,
                 tag: str = "roofline", force: bool = False,
                 cfg_override=None, *, device="cuda", mesh=None) -> dict:
    out_path = RESULTS / f"{arch}__{shape_name}__{mesh_kind}__{tag}.json"
    skipped = _skip(arch, shape_name, mesh_kind, tag, out_path)
    if skipped:
        return skipped
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    cfg = cfg_override or ARCHS[arch].CONFIG
    policy, shape, axes, rec = _cell(arch, shape_name, mesh_kind, policy,
                                     tag, mesh)
    dev = resolve_device(device)
    rec.update(device_type=dev.type, method="2-point layer extrapolation "
               "from 1 and 2 groups, grad_accum=1")
    t0 = time.time()
    try:
        with fake_group(math.prod(shape)):
            m = make_mesh(shape, axes, device=dev)
            c1 = step_cost(_shallow(cfg, 1), shape_name, m, policy,
                           grad_accum=1, device=dev)
            c2 = step_cost(_shallow(cfg, 2), shape_name, m, policy,
                           grad_accum=1, device=dev)
            _, args, specs = build_lowerable(cfg, shape_name, m, policy,
                                             grad_accum=1)
            full_args = spec_bytes(args, specs, m)
        G = cfg.num_groups
        coll = {op: extrapolate(c1["coll"].get(op, 0.0),
                                c2["coll"].get(op, 0.0), G)
                for op in sorted(set(c1["coll"]) | set(c2["coll"]))}
        # memory extrapolated as the costs are (exact for the arguments,
        # which the full depth's specs also give)
        mem = {k: extrapolate(c1["memory"][k], c2["memory"][k], G)
               for k in ("argument_bytes", "output_bytes", "temp_bytes")}
        mem["argument_bytes_from_specs"] = full_args
        rec.update(measure_s=round(time.time() - t0, 1), one_group=c1,
                   two_group=c2, num_groups=G, memory=mem)
        _finish(rec, cfg, SHAPES[shape_name],
                extrapolate(c1["flops"], c2["flops"], G),
                extrapolate(c1["bytes"], c2["bytes"], G), coll,
                rec["devices"])
        terms = rec["terms"]
        rec["step_time_s"] = max(terms.values())
        rec["roofline_fraction"] = terms["compute_s"] / rec["step_time_s"]
    except Exception as e:  # noqa: BLE001
        import traceback
        rec.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
    return _write(rec, out_path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--measure", action="store_true",
                    help="roofline terms by the 2-point layer "
                         "extrapolation (default: the step at full depth)")
    ap.add_argument("--device", default="cuda",
                    help="device type of the fake tensors (default: cuda)")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                if args.measure:
                    tag = args.tag if args.tag != "baseline" else "roofline"
                    rec = measure_cell(arch, shape, mk, tag=tag,
                                       force=args.force, device=args.device)
                else:
                    rec = run_cell(arch, shape, mk, tag=args.tag,
                                   force=args.force, device=args.device)
                status = rec["status"]
                if status == "ok":
                    t = rec["terms"]
                    print(f"[{status}] {arch} {shape} {mk}: "
                          f"compute {t['compute_s']:.3e}s memory "
                          f"{t['memory_s']:.3e}s collective "
                          f"{t['collective_s']:.3e}s -> {rec['bottleneck']}"
                          f" ({rec.get('run_s', rec.get('measure_s', 0))}s)",
                          flush=True)
                elif status == "skip":
                    print(f"[skip] {arch} {shape} {mk}: "
                          f"{rec['reason'][:60]}", flush=True)
                else:
                    failures += 1
                    print(f"[ERR ] {arch} {shape} {mk}: {rec['error']}",
                          flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
