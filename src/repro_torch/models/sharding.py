"""Sharding rules (port of ``repro.models.sharding``): the specs of the
parameters, the train state, a batch and the cache on a named
``DeviceMesh``, their DTensor placements, and the activation constraints.

Logical axes, as the reference names them:
    fsdp    parameter + optimizer-state sharding   -> ('data',) or ('pod','data')
    tensor  heads / d_ff / experts                 -> 'model'
    batch   data parallelism of the activations    -> ('pod','data')

A spec (``P``) is the reference's ``PartitionSpec``: one entry a tensor
dimension, ``None``, a mesh dimension's name, or a tuple of names (the
dimension split over each of them, major first).  ``placements``
turns a spec into DTensor placements on a mesh, ``distribute`` places a
tensor by it.  A mesh is read only through ``mesh_dim_names`` and
``shape``, so the rules run on any object with those two (a
``DeviceMesh``, or the dry-run's shape of a production mesh).

The port holds the decoder layers as a list of per-layer leaves
(``models.model``), where the reference stacks them over a leading group
axis that no rule shards: a port leaf's spec is the reference's with that
leading ``None`` dropped.  The rules match the reference's path of each
leaf (``models.model.ref_layout``; a list index reads as the reference's
``l{i}``, which no rule names).  Adafactor's statistics stay in the
reference's stacked layout, so ``train_state_specs`` gives them the
reference's stacked specs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import tree as T


class P:
    """A partition spec: its entries, one a tensor dimension (``None``, a
    mesh dimension's name or a tuple of names).  Not a tuple, so that a
    tree of specs (``repro_torch.tree``) has one at each leaf; it iterates,
    indexes and compares equal to the tuple of its entries."""
    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        return tuple(self) == tuple(other) if isinstance(
            other, (P, tuple)) else NotImplemented

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"P{self.entries!r}"


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    fsdp: bool = True            # shard params over the data axis too
    seq_shard: bool = False      # sequence parallelism for activations
    cache_heads_on_tensor: bool = False   # else head_dim on tensor
    cache_seq_on_fsdp: bool = False       # long context: cache S on data
    cache_seq_on_tensor: bool = False     # decode: cache S on model
    batch_on_pod: bool = True    # include 'pod' in the batch axes


def mesh_sizes(mesh) -> dict:
    """{mesh dimension name: its size}."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def axes(mesh, policy: ShardingPolicy):
    has_pod = "pod" in mesh.mesh_dim_names
    fsdp = (("pod", "data") if has_pod else ("data",)) if policy.fsdp else None
    batch = ("pod", "data") if (has_pod and policy.batch_on_pod) else ("data",)
    return dict(fsdp=fsdp, tensor="model", batch=batch)


def _flat(*names):
    """Flatten possibly-tuple logical axes into one spec entry."""
    out = []
    for a in names:
        if a is None:
            continue
        out.extend(a if isinstance(a, tuple) else (a,))
    return tuple(out) if out else None


# (regex on the reference's path, spec builder taking (fsdp, tensor) ->
# the spec without the reference's leading group axis), in the
# reference's order: the first match wins.
_RULES = [
    (r"embed$",                 lambda f, t: (None, _flat(f, t))),   # (V, D)
    (r"head$",                  lambda f, t: (f, t)),          # (D, V)
    (r"(final_norm|norm)/(scale|bias)$", lambda f, t: None),   # replicated
    (r"(pre_norm|post_norm|cross_norm|q_norm|k_norm|kv_norm)/(scale|bias)$",
     lambda f, t: None),
    # attention (GQA + cross)
    (r"w[qkv]$",                lambda f, t: (f, t)),          # (D, H*dh)
    (r"wo$",                    lambda f, t: (t, f)),          # (H*dh, D)
    (r"b[qkv]$",                lambda f, t: (t,)),
    # MLA
    (r"wdq$",                   lambda f, t: (f, None)),
    (r"wuq$",                   lambda f, t: (None, t)),
    (r"wdkv$",                  lambda f, t: (f, None)),
    (r"wukv$",                  lambda f, t: (None, t)),
    (r"wkr$",                   lambda f, t: (f, None)),
    # MLP
    (r"(wi|wg)$",               lambda f, t: (f, t)),          # (D, F)
    # MoE (E, D, F) / (E, F, D): experts on tensor, fsdp inside an expert
    (r"moe/router$",            lambda f, t: (f, None)),
    (r"moe/(wi|wg)$",           lambda f, t: (t, f, None)),
    (r"moe/wo$",                lambda f, t: (t, None, f)),
    # Mamba (split input projections)
    (r"(wz|wx|wbc|wdt)$",       lambda f, t: (f, t)),
    (r"out_proj$",              lambda f, t: (t, f)),
    (r"conv_w_(x|bc)$",         lambda f, t: (None, t)),
    (r"conv_b_(x|bc)$",         lambda f, t: (t,)),
    (r"(A_log|D|dt_bias)$",     lambda f, t: None),
]


def _prod(mesh, names) -> int:
    if names is None:
        return 1
    sizes = mesh_sizes(mesh)
    k = 1
    for nm in (names if isinstance(names, tuple) else (names,)):
        k *= sizes[nm]
    return k


def _divisible(dim_size, entry, mesh) -> bool:
    return entry is None or dim_size % _prod(mesh, entry) == 0


def _canon(spec) -> P:
    """Singleton tuples as bare names, as the reference prints them."""
    return P(*(s[0] if isinstance(s, tuple) and len(s) == 1 else s
               for s in spec))


def ref_path(path) -> str:
    """The reference's ``/``-joined path of a port leaf: a list index (a
    layer) reads as ``l{i}``."""
    return "/".join(f"l{k}" if isinstance(k, int) else str(k) for k in path)


def leaf_spec(ps: str, shape, mesh, policy: ShardingPolicy) -> P:
    """The spec of one parameter of shape ``shape`` at reference path
    ``ps``, without the reference's group axis: the first rule that
    matches, padded with ``None``, an entry that does not divide its
    dimension dropped; replicated when no rule matches."""
    ax = axes(mesh, policy)
    for pat, builder in _RULES:
        if re.search(pat, ps):
            spec = tuple(builder(ax["fsdp"], ax["tensor"]) or ())
            spec = spec + (None,) * (len(shape) - len(spec))
            return _canon(s if _divisible(shape[i], s, mesh) else None
                          for i, s in enumerate(spec))
    return P(*(None,) * len(shape))


def param_specs(params, mesh, policy: ShardingPolicy):
    """The spec tree of ``params`` (a tree of tensors, meta ones too)."""
    return T.unflatten(params, [leaf_spec(ref_path(path), p.shape, mesh,
                                          policy)
                                for path, p in T.items(params)])


def train_state_specs(state, pspecs, mesh, *, stacks=None):
    """Specs of a ``steps.TrainState``: the params' are ``pspecs``; AdamW's
    moments mirror them; Adafactor's statistics, keyed by reference path
    in the reference's stacked layout, take the reference's rule on the
    stacked spec (``stacks``: ``models.model.ref_layout(cfg)``, as the
    train step passes it; without it every leaf stands alone) — ``vr``
    drops the last entry, ``vc`` the one before it, and ``v`` is the
    stacked spec for a leaf of < 2 dims, replicated otherwise."""
    from repro_torch.optim.adafactor import AdafactorState, layout
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.models.steps import TrainState
    scalar = P()
    opt = state.opt
    if isinstance(opt, AdamWState):
        opt_spec = AdamWState(mu=pspecs, nu=pspecs, count=scalar)
    else:
        specs = T.leaves(pspecs)
        shapes = [tuple(p.shape) for p in T.leaves(state.params)]
        vr, vc, v = {}, {}, {}
        for key, stacked, ids in layout(state.params, stacks):
            sp, nd = specs[ids[0]], len(shapes[ids[0]])
            if stacked:
                sp, nd = (None,) + tuple(sp), nd + 1
            vr[key] = P(*tuple(sp)[:-1]) if nd >= 2 else scalar
            vc[key] = (P(*tuple(sp)[:-2] + tuple(sp)[-1:]) if nd >= 2
                       else scalar)
            v[key] = scalar if nd >= 2 else P(*sp)
        opt_spec = AdafactorState(vr=vr, vc=vc, v=v, count=scalar)
    return TrainState(params=pspecs, opt=opt_spec, step=scalar)


def batch_specs(batch, mesh, policy: ShardingPolicy,
                shard_batch_dim: bool = True):
    """Each batch leaf's leading (row) dimension on the batch axes where
    it divides, the rest replicated."""
    b = axes(mesh, policy)["batch"]

    def one(leaf):
        nd = len(leaf.shape)
        if not shard_batch_dim or not nd or leaf.shape[0] % _prod(mesh, b):
            return P()
        return _canon((b,) + (None,) * (nd - 1))

    return T.map_tree(one, batch)


def cache_leaf_spec(ps: str, shape, mesh, policy: ShardingPolicy) -> P:
    """The reference's spec of one cache leaf, over its logical dimensions
    (KV: (B, S, Hkv, Dh); MLA: ckv (B, S, r), k_rope (B, S, 1, dr); SSM:
    (B, heads, p, n); conv windows (B, W-1, C)): batch on the batch axes;
    KV's S on model (``cache_seq_on_tensor``) or data
    (``cache_seq_on_fsdp``), else its heads (``cache_heads_on_tensor``),
    else its last dimension on model; MLA's latent S on model or its last
    dimension; the SSM heads and the conv channels on model."""
    ax = axes(mesh, policy)
    b, t = ax["batch"], ax["tensor"]
    nd = len(shape)
    spec = [None] * nd
    if nd and shape[0] % _prod(mesh, b) == 0:
        spec[0] = b
    if "kv/k" in ps or "kv/v" in ps or "k_rope" in ps:
        if policy.cache_seq_on_tensor and _divisible(shape[1], t, mesh):
            spec[1] = t
        elif policy.cache_seq_on_fsdp and _divisible(shape[1], ("data",),
                                                     mesh):
            spec[1] = "data"
        elif policy.cache_heads_on_tensor and _divisible(shape[2], t, mesh):
            spec[2] = t
        elif _divisible(shape[-1], t, mesh):
            spec[-1] = t
    elif "ckv" in ps:
        if policy.cache_seq_on_tensor and _divisible(shape[1], t, mesh):
            spec[1] = t
        elif _divisible(shape[-1], t, mesh):
            spec[-1] = t
    elif "ssm/ssm" in ps:
        if _divisible(shape[1], t, mesh):
            spec[1] = t
    elif "ssm/conv" in ps:
        if _divisible(shape[-1], t, mesh):
            spec[-1] = t
    return _canon(spec)


def cache_specs(cache, mesh, policy: ShardingPolicy):
    """The spec tree of a cache (``models.model.init_cache``'s), over each
    leaf's logical dimensions, as the reference gives them with its group
    axis dropped (``enc_out``, where present, is a batch leaf)."""
    out = []
    for path, leaf in T.items(cache):
        ps = ref_path(path)
        if path[0] == "enc_out":
            out.append(T.leaves(batch_specs([leaf], mesh, policy))[0])
        else:
            out.append(cache_leaf_spec(ps, leaf.shape, mesh, policy))
    return T.unflatten(cache, out)


# ---------------------------------------------------------------------------
# Placements
# ---------------------------------------------------------------------------

def placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: a mesh dimension named
    in the entry of tensor dimension d is ``Shard(d)``, the others
    ``Replicate()``.  A tuple entry splits its dimension over its names
    major first, as JAX does, which is DTensor's mesh order: the names of
    one entry must come in the mesh's order."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(nm) for nm in group]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"order {tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} names {names[i]} twice")
            out[i] = Shard(d)
    return out


def shard_shape(shape, spec, mesh) -> tuple:
    """The local shape of a tensor of ``shape`` placed by ``spec`` (a
    spec shorter than the shape leaves the rest whole)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n // _prod(mesh, e) for n, e in zip(shape, spec))


def distribute(tensor, spec, mesh):
    """``tensor`` (the same on every rank) as a DTensor placed by ``spec``
    over its logical dimensions.  A tensor that is a permuted view of a
    buffer (the KV cache's (B, S, Hkv, Dh) view of a head-major buffer)
    is placed as its buffer, the spec's entries moved onto the buffer's
    dimensions, and comes back as the same view of the placed buffer."""
    order = sorted(range(tensor.dim()), key=lambda d: -tensor.stride(d))
    phys = tensor.permute(order)
    if order == sorted(order) or not phys.is_contiguous():
        return distribute_tensor(tensor, mesh, placements(spec, mesh))
    placed = distribute_tensor(phys, mesh,
                               placements(P(*(spec[d] for d in order)), mesh))
    return placed.permute([order.index(d) for d in range(tensor.dim())])


def distribute_tree(tree, specs, mesh):
    """Every leaf of ``tree`` placed by the spec at the same place of
    ``specs``."""
    return T.unflatten(tree, [distribute(x, s, mesh) for x, s in
                              zip(T.leaves(tree), T.leaves(specs))])


# ---------------------------------------------------------------------------
# Activation constraints: redistribute a DTensor activation to the layout
# the reference pins with ``with_sharding_constraint``.  Outside an
# ``activation_axes`` context, or on a plain tensor, each is a no-op.
# ---------------------------------------------------------------------------

_ACT: dict | None = None


@contextlib.contextmanager
def activation_axes(mesh, policy: ShardingPolicy):
    """Enable the activation constraints on ``mesh`` in this context.  A
    plain tensor the model makes on the way (positions, masks, RoPE
    angles: the same on every rank) meets DTensors as a replicated one
    (``implicit_replication``)."""
    global _ACT
    ax = axes(mesh, policy)
    prev = _ACT
    _ACT = {"mesh": mesh, "policy": policy, "fsdp": ax["fsdp"],
            "batch": ax["batch"],
            "tensor": ax["tensor"],
            "seq": ax["tensor"] if policy.seq_shard else None,
            "kv_seq_sharded": policy.cache_seq_on_tensor}
    try:
        with implicit_replication():
            yield
    finally:
        _ACT = prev


def is_sharded(x) -> bool:
    return isinstance(x, DTensor)


def gather_fsdp(w):
    """A weight DTensor gathered over the fsdp axes (its tensor-axis
    shards kept), as ZeRO-3 gathers a layer's weights at their use; its
    backward reduce-scatters the grad.  Left to itself, DTensor's
    product strategy gathers the activations instead (the whole batch's
    rows on every rank).  A plain tensor, or outside ``activation_axes``,
    as it is."""
    if _ACT is None or not isinstance(w, DTensor) or _ACT["fsdp"] is None:
        return w
    names = set(_ACT["fsdp"])
    want = [Replicate() if nm in names and isinstance(p, Shard) else p
            for nm, p in zip(w.device_mesh.mesh_dim_names, w.placements)]
    return redistribute(w, want)


def sum_squares(x):
    """⟨x, x⟩ in float32 over all of ``x``: ``torch.vdot`` of the
    flattened tensor; of a DTensor, each rank's shard's, summed over the
    ranks that split it — DTensor has no ``vdot``, and a flattened
    doubly-sharded DTensor cannot be gathered under ``FakeTensorMode``."""
    if not isinstance(x, DTensor):
        f = x.reshape(-1).float()
        return torch.vdot(f, f)
    from torch.distributed.tensor import Partial
    x = reduce_partials(x)
    f = x.to_local().reshape(-1).float()
    return DTensor.from_local(
        torch.vdot(f, f), x.device_mesh,
        [Partial() if isinstance(p, Shard) else p for p in x.placements],
        run_check=False)


def vocab_gather(logits, idx):
    """The gold logits ``logits[b, s, idx[b, s]]`` (B, S).  Of DTensor
    logits with V on the tensor axis, each rank gathers the labels in its
    vocabulary shard and the partial sums are reduced: the gather of
    DTensor's own strategy comes back in a layout its select cannot take,
    and its backward fills a whole (B, S, V) gradient on every rank."""
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, idx[..., None])[..., 0]
    rows = axis("batch", logits.shape[0])
    vocab = axis("tensor", logits.shape[-1])

    def local(lg, i, v0):
        v = lg.shape[-1]
        j = i - v0
        inside = (j >= 0) & (j < v)
        g = torch.gather(lg, -1, j.clamp(0, v - 1)[..., None])[..., 0]
        return torch.where(inside, g, torch.zeros_like(g))

    gold = local_call(lambda lg, i: local(lg, i, first_index(
        vocab, logits.shape[-1])), (logits, idx),
        ((rows, None, vocab), (rows, None)), (rows, None), partial=vocab)
    return reduce_partials(gold)


def reduce_partials(x):
    """A DTensor with its pending partial sums reduced (its shards kept);
    a plain tensor as it is."""
    if not isinstance(x, DTensor) or not any(p.is_partial()
                                             for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def split_count(x, d: int) -> int:
    """How many ways ``x``'s dimension ``d`` is split (1 for a plain
    tensor)."""
    if not isinstance(x, DTensor):
        return 1
    sizes = tuple(x.device_mesh.shape)
    return math.prod(sizes[i] for i, p in enumerate(x.placements)
                     if isinstance(p, Shard) and p.dim == d)


def split_last(x, sizes):
    """``x`` (..., F) viewed as (..., *sizes).  DTensor cannot split a
    shard of F whose count does not divide sizes[0] (8 KV heads of a
    16-way model axis): such an ``x`` is gathered over F first."""
    if sizes[0] % split_count(x, x.dim() - 1):
        d = x.dim() - 1
        x = redistribute(x, [Replicate() if isinstance(p, Shard) and
                             p.dim == d else p for p in x.placements])
    return x.reshape(*x.shape[:-1], *sizes)


def axis(name: str, size: int):
    """The mesh axes of the logical axis ``name`` ('batch' or 'tensor') in
    ``activation_axes``, or None where they do not divide ``size``."""
    entry = _ACT[name]
    return entry if _divisible(size, entry, _ACT["mesh"]) else None


def first_index(entry, size: int) -> int:
    """This rank's first index of a dimension of ``size`` split over the
    mesh axes ``entry`` (major first; 0 for None)."""
    if entry is None:
        return 0
    mesh = _ACT["mesh"]
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    idx = 0
    for nm in (entry if isinstance(entry, tuple) else (entry,)):
        idx = idx * mesh_sizes(mesh)[nm] + coord[nm]
    return idx * (size // _prod(mesh, entry))


def _dense_order(t):
    """``t``'s dimensions from the outermost to the innermost, if ``t`` is
    a dense permutation of its shape (else None)."""
    order = sorted(range(t.dim()), key=lambda d: (-t.stride(d), d))
    return order if t.permute(order).is_contiguous() else None


class _ToLocal(torch.autograd.Function):
    """``x.to_local()`` whose backward wraps the local grad in the
    placements ``grad``, with a global stride in the grad's own dimension
    order: a local computation's grad can come back transposed
    (attention's key grad), the plain tensors' backward goes on with it
    so, and a copy to another layout would change the rounding of the
    products after it."""

    @staticmethod
    def forward(ctx, x, grad):
        ctx.mesh, ctx.grad, ctx.shape = x.device_mesh, grad, x.shape
        return x.to_local().view_as(x.to_local())

    @staticmethod
    def backward(ctx, g):
        order = _dense_order(g)
        if order is None:
            g, order = g.contiguous(), list(range(g.dim()))
        stride, n = [0] * g.dim(), 1
        for d in reversed(order):
            stride[d], n = n, n * ctx.shape[d]
        return DTensor.from_local(g, ctx.mesh, ctx.grad, run_check=False,
                                  shape=ctx.shape, stride=tuple(stride)), None


class _FromLocal(torch.autograd.Function):
    """``DTensor.from_local`` whose backward hands back the grad in the
    placements ``grad`` (a partial sum's grad is the same on every rank);
    PyTorch's own ``from_local`` takes ``grad_placements`` only from 2.12
    on, and before it turned a replicated grad back into a partial one."""

    @staticmethod
    def forward(ctx, local, mesh, place, grad):
        ctx.mesh, ctx.grad = mesh, grad
        return DTensor.from_local(local, mesh, place, run_check=False)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.grad).to_local(), None, None, None


def local_call(fn, args, layouts, outs, partial=None):
    """``fn(*args)`` on each rank's shards: the DTensor counterpart of a
    computation written for whole tensors, where sharding propagation
    cannot follow it (views that fold a sharded dimension into another,
    Python loops over chunks) or where the layout it needs is known — the
    grouped attention heads, the SSD's heads.  ``layouts[i]``: the spec
    entries (mesh axes or None, one a dimension) ``args[i]`` is
    redistributed to, or None for an argument passed as it is (a plain
    tensor is taken as replicated first); ``outs``: the layout of the
    result, or a tuple of layouts for a tuple of results; ``partial``:
    the mesh axes over which the results are partial sums."""
    if _ACT is None:
        raise RuntimeError("local_call outside activation_axes")
    from torch.distributed.tensor import Partial
    mesh = _ACT["mesh"]
    summed = set() if partial is None else set(
        partial if isinstance(partial, tuple) else (partial,))
    wants = [None if lay is None else placements(P(*lay), mesh)
             for lay in layouts]
    # a mesh dimension some argument is split over splits the work: the
    # grad of an argument replicated over it is each rank's part of a sum
    split = {i for want in wants if want for i, p in enumerate(want)
             if isinstance(p, Shard)}

    def local(t, want):
        if want is None or t is None:
            return t
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        grad = [Partial() if i in split and not isinstance(p, Shard) else p
                for i, p in enumerate(want)]
        return _ToLocal.apply(redistribute(t, want), grad)

    def wrap(r, lay):
        place = [Partial() if nm in summed else pl for nm, pl in
                 zip(mesh.mesh_dim_names, placements(P(*lay), mesh))]
        grad = [Replicate() if p.is_partial() else p for p in place]
        return _FromLocal.apply(r, mesh, place, grad)

    res = fn(*[local(a, want) for a, want in zip(args, wants)])
    if isinstance(res, tuple):
        return tuple(wrap(r, lay) for r, lay in zip(res, outs))
    return wrap(res, outs)


def write_split_rows(buf, new, at: int):
    """``buf[:, at:at + S] = new`` for a DTensor ``buf`` whose dimension 1
    is split across ranks (an S-sharded cache): each rank writes the rows
    that fall in its shard of its own tensor — DTensor writes no slice of a
    split dimension in place, and would gather the whole buffer to take
    one."""
    names = buf.device_mesh.mesh_dim_names
    split = tuple(nm for nm, p in zip(names, buf.placements)
                  if isinstance(p, Shard) and p.dim == 1)
    new = redistribute(new.to(buf.dtype), [
        Replicate() if isinstance(p, Shard) and p.dim == 1 else p
        for p in buf.placements]).to_local()
    local = buf.to_local()
    s0, n = first_index(split if len(split) > 1 else split[0],
                        buf.shape[1]), local.shape[1]
    lo, hi = max(at, s0), min(at + new.shape[1], s0 + n)
    if lo < hi:
        local[:, lo - s0:hi - s0] = new[:, lo - at:hi - at]


def take_rows(table, idx):
    """``table[idx]``, the embedding's token gather.  On a DTensor table,
    each rank gathers from its shard of the columns with the indices
    whole (the reference's "indices pass through, operand offset-dim
    sharded"): DTensor's own ``index`` has no strategy for rows sharded
    on the batch axes over columns sharded on them too, and in PyTorch
    2.11 its ``index_put`` backward makes a placement it then refuses."""
    if not isinstance(table, DTensor):
        return table[idx]
    cols = [[] for _ in range(table.dim() - 1)]
    for nm, p in zip(table.device_mesh.mesh_dim_names, table.placements):
        if isinstance(p, Shard) and p.dim % table.dim():
            cols[p.dim % table.dim() - 1].append(nm)
    rest = tuple(None if not c else c[0] if len(c) == 1 else tuple(c)
                 for c in cols)
    whole = (None,) * idx.dim()
    return local_call(lambda t, i: t[i], (table, idx),
                      ((None,) + rest, whole), whole + rest)


def microbatch(x, k: int, n: int):
    """Microbatch ``k`` of ``n`` of a batch leaf: rows k·B/n : (k+1)·B/n
    of a plain tensor; of a DTensor, the k-th of n row chunks of every
    rank's shard (its placements kept), so a batch sharded on its rows
    stays sharded — slicing the global rows would gather them.  The two
    coincide when the rows are not split across ranks."""
    if not isinstance(x, DTensor):
        mb = x.shape[0] // n
        return x[k * mb:(k + 1) * mb]
    local = x.to_local()
    mb = local.shape[0] // n
    return DTensor.from_local(local[k * mb:(k + 1) * mb], x.device_mesh,
                              x.placements, run_check=False)


def place_cache(tree, prefix: tuple, like):
    """A cache subtree made inside the model (the prefill's KV buffers at
    ``prefix``, e.g. ``("blocks", 3, "kv")``) placed by
    ``cache_leaf_spec`` when ``like`` (the activations) is a DTensor;
    unchanged otherwise."""
    if _ACT is None or not isinstance(like, DTensor):
        return tree
    mesh, policy = _ACT["mesh"], _ACT["policy"]
    return T.unflatten(tree, [
        distribute(x, cache_leaf_spec(ref_path(prefix + path), x.shape,
                                      mesh, policy), mesh)
        for path, x in T.items(tree)])


class _Redistribute(torch.autograd.Function):
    """``x.redistribute(mesh, want)`` whose backward hands back a grad with
    a contiguous local tensor: DTensor's own backward of a gather over
    the last dimension slices the grad's columns, and the product's
    backward after it cannot view them."""

    @staticmethod
    def forward(ctx, x, want):
        # the grad of a partial sum is the same on every rank; a shard's
        # dimension counted from the front (PyTorch 2.11 refuses Shard(-1))
        ctx.placements = [Replicate() if p.is_partial() else
                          Shard(p.dim % x.dim()) if isinstance(p, Shard)
                          else p for p in x.placements]
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        g = g.redistribute(g.device_mesh, ctx.placements)
        return DTensor.from_local(g.to_local().contiguous(), g.device_mesh,
                                  g.placements, run_check=False,
                                  shape=g.shape, stride=g.stride()), None


def redistribute(x, want):
    """``x`` (a DTensor) in the placements ``want`` (see
    ``_Redistribute``)."""
    if list(x.placements) == list(want):
        return x
    return _Redistribute.apply(x, tuple(want))


def _constrain(x, spec):
    if _ACT is None or not isinstance(x, DTensor):
        return x
    mesh = _ACT["mesh"]
    spec = tuple(e if e is None or _divisible(x.shape[d], e, mesh) else None
                 for d, e in enumerate(spec))
    return redistribute(x, placements(spec, mesh))


def shard_btd(x):
    """(B, S, D) residual-stream activations -> (batch, seq?, None)."""
    if _ACT is None:
        return x
    return _constrain(x, (_ACT["batch"], _ACT["seq"], None))


def shard_btv(x):
    """(B, S, V) logits -> (batch, None, tensor)."""
    if _ACT is None:
        return x
    return _constrain(x, (_ACT["batch"], None, _ACT["tensor"]))


def shard_as(x, *dims):
    """Each dim 'batch' | 'tensor' | None."""
    if _ACT is None:
        return x
    return _constrain(x, tuple(_ACT[d] if isinstance(d, str) else None
                               for d in dims))


def kv_seq_axis(size: int):
    """The mesh axes a decode step splits the key sequence of ``size``
    over: the tensor axis with the policy's ``cache_seq_on_tensor`` where
    it divides, else None (the sequence whole)."""
    if _ACT is None or not _ACT["kv_seq_sharded"]:
        return None
    return axis("tensor", size)


def decode_attn_logits_constraint(logits):
    """Decode attention logits (B, H, 1, S_kv) with an S-sharded KV cache:
    the kv-seq dimension on the tensor axis."""
    if _ACT is None or not _ACT.get("kv_seq_sharded"):
        return logits
    return _constrain(logits, (_ACT["batch"], None, None, _ACT["tensor"]))
