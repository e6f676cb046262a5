"""Continuous-batched multi-problem solving: stacked slots, one kernel per
stream (port of ``repro.core.batched``).

The serving scenario issues many independent (problem, λ) requests whose
individual solves under-fill a launch.  This module stacks up to S of them
on a leading *slot* axis and drives the batched fused kernels
(``kernels/batched.py``), so one launch advances every live slot R rounds:

  * ``BatchMeta`` / ``normalize_problem`` — the admission contract: every
    request is zero-padded to ONE canonical stacked shape (dense: sample and
    block padding as ``ops.pad_problem``; BlockedCSC: block padding and
    tile-axis padding with (row 0, value 0) slots by
    ``BlockedCSC.on_canvas``, the slot's ``ScatterOrder`` and range-start
    table those the padded design caches, so a design served many times
    builds them once),
    so a whole request stream runs one compiled kernel, chosen by (A's
    dtype, loss, batched) and never re-selected on refill or backoff.
    Padded rows and columns are fixed points of the update, so a slot's
    trajectory equals the standalone solve of the same padded problem.
  * ``empty_slots`` / ``admit_slot`` — the service's empty stack and one
    admission; the service itself never branches on the layout.
  * ``batched_block_shotgun_solve`` — the fixed-budget stacked solve: slot
    i is bit-identical to ``ops.block_shotgun_solve(probs[i], spec=...,
    blk_idx=...)`` with ``fused=True`` on the same draws (dense and
    BlockedCSC).
  * ``launch_rounds`` — the serving step: ONE batched launch of R rounds,
    per-slot ``k_eff`` freezing empty and finished slots exactly, returning
    the in-kernel objective/nnz traces and health scalars the service reads
    at the launch boundary.
  * ``WarmStartCache`` — the (problem_id, λ, loss)-keyed x cache with
    nearest-λ fallback, and ``launch_converged``, the launch-boundary stop
    test, both host-side.

The reference computes a TPU tile height (``auto_tile_n``) per launch; the
Hopper kernels need none.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.core import health
from repro_torch.core import objectives as obj
from repro_torch.core.objectives import Problem
from repro_torch.core.shotgun import Result, Trace
from repro_torch.core.spec import SolverSpec
from repro_torch.data.sparse import BlockedCSC, ScatterOrder, bcsc_matvec
from repro_torch.kernels.batched import (batched_fused_shotgun_rounds,
                                         batched_fused_sparse_shotgun_rounds,
                                         stacked_range_starts,
                                         stacked_scatter_order)
from repro_torch.kernels.ops import block_stream
from repro_torch.kernels.shotgun_block import BLOCK, TILE_N


class BatchMeta(NamedTuple):
    """Canonical stacked shape every admitted request is normalized to.

    One ``BatchMeta`` ⇒ one kernel for the stream: the service builds it
    once (from its first request or an explicit template) and every later
    admission is padded to it, never the other way round.  ``layout`` is
    "dense" or "bcsc"; ``tile`` is 0 for dense, and ``n_pad``/``d_pad`` are
    the padded sample/feature counts (dense pads samples to a ``TILE_N``
    multiple like ``ops.pad_problem``; bcsc never pads samples)."""
    layout: str
    loss: str
    n: int            # true sample count (common to the stream)
    n_pad: int        # padded sample count (== n for bcsc)
    d_pad: int        # padded feature count (nblk · block)
    block: int
    tile: int         # bcsc nnz-tile depth (0 for dense)

    @property
    def nblk(self) -> int:
        return self.d_pad // self.block


def batch_meta_of(prob: Problem, block: int = BLOCK,
                  tile_n: int = TILE_N) -> BatchMeta:
    """The canonical shape a stream templated on ``prob`` normalizes to."""
    if isinstance(prob.A, BlockedCSC):
        return BatchMeta(layout="bcsc", loss=prob.loss, n=prob.n,
                         n_pad=prob.n, d_pad=prob.A.d_pad,
                         block=prob.A.block, tile=prob.A.tile)
    n, d = prob.A.shape
    n_pad = n + (-n) % tile_n
    d_pad = d + (-d) % block
    return BatchMeta(layout="dense", loss=prob.loss, n=n, n_pad=n_pad,
                     d_pad=d_pad, block=block, tile=0)


class SlotArrays(NamedTuple):
    """One admitted problem, normalized to a ``BatchMeta`` canvas (or S of
    them stacked on a leading axis).  Dense slots carry ``A``/``mask``;
    bcsc slots carry ``rows``/``vals``, their ``order`` and their
    range-start table ``rstart`` (over the canvas's n_pad rows).  The
    unused fields are None — a stream is single-layout by construction."""
    A: torch.Tensor | None          # (n_pad, d_pad) f32
    rows: torch.Tensor | None       # (nblk, tile, block) int32
    vals: torch.Tensor | None       # (nblk, tile, block) f32
    y: torch.Tensor                 # (n_pad,) f32
    mask: torch.Tensor | None       # (n_pad,) f32 (dense only)
    lam: torch.Tensor               # () f32
    beta: torch.Tensor              # () f32
    order: ScatterOrder | None = None   # bcsc: of the padded tiles
    rstart: torch.Tensor | None = None  # bcsc: (nblk, n_pad / 128 + 1) int32


def _scalar(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(v), dtype=torch.float32, device=device)


def normalize_problem(prob: Problem, meta: BatchMeta) -> SlotArrays:
    """Admission shape-normalization: zero-pad ``prob`` onto the stream's
    canonical canvas, on the problem's device.  Raises when the problem
    cannot fit (larger than the canvas, mismatched loss/layout/samples) —
    admission never grows the canvas.  A BlockedCSC's slot arrays are the
    design's own (or its cached canvas copy's) tiles and layouts, not
    copies: the layouts live as long as the container, which must not be
    changed in place after its first use."""
    return _normalize(prob, meta)[0]


def _normalize(prob: Problem, meta: BatchMeta):
    """``normalize_problem`` and the design it holds (A or the canvas)."""
    sparse = isinstance(prob.A, BlockedCSC)
    layout = "bcsc" if sparse else "dense"
    if layout != meta.layout:
        raise ValueError(f"layout {layout!r} != stream layout "
                         f"{meta.layout!r}")
    if prob.loss != meta.loss:
        raise ValueError(f"loss {prob.loss!r} != stream loss {meta.loss!r}")
    if prob.n != meta.n:
        raise ValueError(f"n={prob.n} != stream n={meta.n} — the sample "
                         "dimension is common to the whole stream")
    dev = prob.y.device
    lam, beta = _scalar(prob.lam, dev), _scalar(prob.beta, dev)
    y = prob.y.to(torch.float32)
    if sparse:
        S = prob.A
        if S.ovf is not None:
            raise ValueError("the batched kernels read the tiles only: a "
                             "design with an overflow store (columns deeper "
                             f"than tile {S.tile}) cannot be served")
        if S.block != meta.block:
            raise ValueError(f"block={S.block} != stream block={meta.block}")
        if S.tile > meta.tile:
            raise ValueError(f"tile={S.tile} > stream tile={meta.tile} — "
                             "denser than the stream canvas admits")
        if S.d_pad > meta.d_pad:
            raise ValueError(f"d_pad={S.d_pad} > stream d_pad={meta.d_pad}")
        # zero blocks and (row 0, value 0) slots are additive identities;
        # the padded copy and the layouts are cached on the design
        S = S.on_canvas(meta.nblk, meta.tile)
        return SlotArrays(A=None, rows=S.rows, vals=S.vals, y=y, mask=None,
                          lam=lam, beta=beta, order=S.scatter_order(),
                          rstart=S.range_starts()), S
    n, d = prob.A.shape
    if d > meta.d_pad:
        raise ValueError(f"d={d} > stream d_pad={meta.d_pad}")
    A = F.pad(prob.A.to(torch.float32), (0, meta.d_pad - d,
                                         0, meta.n_pad - n))
    mask = F.pad(torch.ones(n, dtype=torch.float32, device=dev),
                 (0, meta.n_pad - n))
    return SlotArrays(A=A, rows=None, vals=None, y=F.pad(y, (0, meta.n_pad
                                                             - n)),
                      mask=mask, lam=lam, beta=beta), A


def stack_problems(probs: Sequence[Problem], meta: BatchMeta | None = None
                   ) -> tuple[BatchMeta, SlotArrays]:
    """Normalize every problem to one canvas and stack on a leading slot
    axis.  With ``meta=None`` the canvas is the elementwise max over the
    stack (so any member could have been the template)."""
    if not probs:
        raise ValueError("stack_problems: empty problem list")
    if meta is None:
        metas = [batch_meta_of(p) for p in probs]
        m0 = metas[0]
        for m in metas[1:]:
            if (m.layout, m.loss, m.n, m.block) != (m0.layout, m0.loss,
                                                    m0.n, m0.block):
                raise ValueError(
                    f"heterogeneous stream: {m0.layout}/{m0.loss}/n={m0.n}"
                    f"/block={m0.block} vs {m.layout}/{m.loss}/n={m.n}"
                    f"/block={m.block}")
        meta = m0._replace(
            n_pad=max(m.n_pad for m in metas),
            d_pad=max(m.d_pad for m in metas),
            tile=max(m.tile for m in metas))
    slots = [normalize_problem(p, meta) for p in probs]
    return meta, map_slot_arrays(lambda *xs: torch.stack(xs), *slots)


def map_slot_arrays(fn, *arrays: SlotArrays) -> SlotArrays:
    """``fn`` over the matching tensors of ``arrays``, field by field (a
    ``ScatterOrder`` field by each of its tensors), as a ``SlotArrays``; a
    field that is None stays None."""
    def field(*xs):
        if xs[0] is None:
            return None
        if isinstance(xs[0], ScatterOrder):
            return ScatterOrder(*(fn(*f) for f in zip(*xs)))
        return fn(*xs)

    return SlotArrays(*(field(*xs) for xs in zip(*arrays)))


def empty_slots(meta: BatchMeta, S: int, device) -> SlotArrays:
    """S stacked empty slots of ``meta``'s canvas on ``device``: zero
    designs (all-padding tiles with their scatter order and range starts
    for bcsc), zero y and λ, β = 1."""
    def zero(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    ones = torch.ones(S, dtype=torch.float32, device=device)
    if meta.layout == "bcsc":
        rows = zero(S, meta.nblk, meta.tile, meta.block, dtype=torch.int32)
        vals = zero(S, meta.nblk, meta.tile, meta.block)
        order = stacked_scatter_order(rows, vals)
        return SlotArrays(A=None, rows=rows, vals=vals, y=zero(S, meta.n_pad),
                          mask=None, lam=zero(S), beta=ones, order=order,
                          rstart=stacked_range_starts(rows, order,
                                                      meta.n_pad))
    return SlotArrays(A=zero(S, meta.n_pad, meta.d_pad), rows=None,
                      vals=None, y=zero(S, meta.n_pad),
                      mask=zero(S, meta.n_pad), lam=zero(S), beta=ones)


class Admission(NamedTuple):
    """One served problem on its stream's canvas (``admit_slot``): the
    design its margin is taken on (the padded A, or the BlockedCSC canvas)
    and the mask its objective reads.  ``reused``: a BlockedCSC design
    brought its canvas and layouts cached (None for dense); ``copied``: its
    canvas is a padded or cast copy of its tiles."""
    slot: SlotArrays
    design: torch.Tensor | BlockedCSC
    mask: torch.Tensor
    reused: bool | None
    copied: bool

    def count(self, made) -> None:
        """``serve.layout_hits``/``builds`` of a BlockedCSC admission, and
        ``serve.admit_bytes``: the tensors ``made``, and what was built —
        a dense problem's every array; a BlockedCSC's y, λ, β and only
        where built its layouts and canvas copy."""
        if not obs.enabled():
            return
        sa = self.slot
        if self.reused is None:
            obs.count("serve.admit_bytes", obs.nbytes(*made, *sa))
            return
        obs.count("serve.layout_hits" if self.reused
                  else "serve.layout_builds", 1)
        built = obs.nbytes(*made, sa.y, sa.lam, sa.beta)
        if not self.reused:
            built += obs.nbytes(*sa.order, sa.rstart,
                                self.design.row_table())
            if self.copied:
                built += obs.nbytes(self.design.rows, self.design.vals)
        obs.count("serve.admit_bytes", built)


def admit_slot(prob: Problem, meta: BatchMeta) -> Admission:
    """``normalize_problem`` for a served slot, with what the service needs
    of the layout (a BlockedCSC's mask is ones: it never pads samples)."""
    reused = None
    if meta.layout == "bcsc":
        # checked before normalizing, which builds what is missing
        reused = (isinstance(prob.A, BlockedCSC)
                  and prob.A.has_layouts(meta.nblk, meta.tile))
    sa, design = _normalize(prob, meta)
    mask = (sa.mask if sa.mask is not None else
            torch.ones(meta.n_pad, dtype=torch.float32, device=sa.y.device))
    return Admission(slot=sa, design=design, mask=mask, reused=reused,
                     copied=design is not prob.A)


# ---------------------------------------------------------------------------
# One batched launch (the serving step) and the fixed-budget stacked solve
# ---------------------------------------------------------------------------

def launch_rounds(meta: BatchMeta, stacked: SlotArrays, z, x, idx, k_eff,
                  guard_f=None):
    """ONE batched launch: R fused rounds on every slot with ``k_eff[s]``
    live blocks (0 = frozen, an exact no-op).  ``guard_f`` is the per-slot
    in-kernel objective guard ((S,), None = +inf = unguarded): a slot whose
    objective passes it raises its health scalar and keeps updating to the
    launch's end; the service reads health at the boundary and rolls that
    slot back.  Returns (x (S, d_pad), z (S, n_pad), f (S, R), nnz (S, R),
    health (S,))."""
    S = z.shape[0]
    guard = (torch.full((S,), math.inf, dtype=torch.float32, device=z.device)
             if guard_f is None else
             torch.as_tensor(guard_f, dtype=torch.float32, device=z.device))
    k_eff = torch.as_tensor(k_eff, dtype=torch.float32, device=z.device)
    if meta.layout == "bcsc":
        return batched_fused_sparse_shotgun_rounds(
            stacked.rows, stacked.vals, z, x, idx, stacked.lam,
            stacked.beta, stacked.y, k_eff, guard, loss=meta.loss,
            order=stacked.order, rstart=stacked.rstart)
    return batched_fused_shotgun_rounds(
        stacked.A, z, x, idx, stacked.lam, stacked.beta, stacked.y,
        stacked.mask, k_eff, guard, loss=meta.loss)


def init_margin(meta: BatchMeta, stacked: SlotArrays, x):
    """Stacked warm-start margins z0 = A x0 in f32, slot by slot exactly as
    the standalone solves start (``objectives.start``)."""
    S = x.shape[0]
    if meta.layout == "bcsc":
        return torch.stack([bcsc_matvec(stacked.rows[s], stacked.vals[s],
                                        x[s], meta.n_pad) for s in range(S)])
    return torch.stack([obj.matvec(stacked.A[s], x[s]) for s in range(S)])


def x_on_canvas(x0, d_pad: int, device) -> torch.Tensor:
    """A true-d warm start (None for cold) as a padded f32 iterate."""
    if x0 is None:
        return torch.zeros(d_pad, dtype=torch.float32, device=device)
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=device)
    return F.pad(x0, (0, d_pad - x0.shape[0]))


def _stack_x0(x0s, S: int, d_pad: int, device):
    if x0s is None:
        return torch.zeros((S, d_pad), dtype=torch.float32, device=device)
    return torch.stack([x_on_canvas(x0, d_pad, device) for x0 in x0s])


def batched_block_shotgun_solve(probs: Sequence[Problem], generators=None,
                                *, spec: SolverSpec | None = None,
                                blk_idx=None, x0s=None,
                                rounds_per_launch: int = 8,
                                meta: BatchMeta | None = None) -> Result:
    """Fixed-budget stacked solve: every slot runs the full round budget in
    lock-step batched launches.  Slot i is bit-identical to
    ``ops.block_shotgun_solve(probs[i], spec=fused spec, blk_idx=...,
    rounds_per_launch=R)`` run standalone on the same padded canvas with
    the same draws — the batched kernels change the launch, not the math.

    K = ceil(spec.P / 128) and rounds = spec.rounds, with ``spec.loss``
    checked against every problem's loss (``spec=`` is required).  Draws:
    ``blk_idx`` (S, rounds, K), or one ``torch.Generator`` per slot in
    ``generators`` — each slot its own stream, so results do not depend on
    which slot a problem lands in.  Returns a stacked ``Result`` (leading S
    axis; x at the padded width, sliced to each problem's d by the caller).
    """
    if spec is None:
        raise TypeError("batched_block_shotgun_solve needs "
                        "spec=SolverSpec(...); the legacy (K, rounds) "
                        "kwargs are not ported")
    for p_i in probs:
        spec.check_loss(p_i.loss)
    K = max(1, -(-spec.P // BLOCK))
    rounds = spec.rounds
    R = rounds_per_launch
    if rounds % R:
        raise ValueError(f"rounds={rounds} not divisible by "
                         f"rounds_per_launch={R}")
    meta, stacked = stack_problems(probs, meta)
    S = len(probs)
    dev = stacked.y.device
    for name, given in (("generators", generators), ("blk_idx", blk_idx)):
        if given is not None and len(given) != S:
            raise ValueError(f"{len(given)} {name} for {S} problems")
    idx = torch.stack([block_stream(
        None if blk_idx is None else blk_idx[s],
        None if generators is None else generators[s], rounds, K,
        meta.nblk, dev) for s in range(S)])
    x = _stack_x0(x0s, S, meta.d_pad, dev)
    z = (torch.zeros((S, meta.n_pad), dtype=torch.float32, device=dev)
         if x0s is None else init_margin(meta, stacked, x))
    idx = idx.reshape(S, rounds // R, R, K)
    k_eff = torch.full((S,), float(K), dtype=torch.float32, device=dev)
    fs, nnzs = [], []
    for launch in range(rounds // R):
        x, z, f, nz, _ = launch_rounds(meta, stacked, z, x, idx[:, launch],
                                       k_eff)
        fs.append(f)
        nnzs.append(nz)
    fs = torch.cat(fs, dim=1)
    status = torch.stack([health.status_from_trace(f) for f in fs])
    return Result(x=x, z=z, trace=Trace(objective=fs,
                                        nnz=torch.cat(nnzs, dim=1)),
                  status=status)


# ---------------------------------------------------------------------------
# Warm-start cache: (problem_id, λ) → x, with nearest-λ fallback
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CacheStats:
    hits_exact: int = 0
    hits_near: int = 0
    misses: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits_exact + self.hits_near + self.misses
        return 0.0 if not total else (self.hits_exact + self.hits_near) \
            / total


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


class WarmStartCache:
    """Warm-start x cache keyed on (problem_id, λ).

    ``get`` returns the stored solution on an exact-λ hit (relative
    tolerance ``lam_rtol``) and falls back to the NEAREST cached λ for the
    same problem_id otherwise — λ-path neighbours are the classic warm
    start (Sec. 4.1.1).  Keys carry the problem's loss tag (default
    "lasso"), so a lasso warm start never seeds a logistic solve of the
    same problem_id.  Entries store the true-d (unpadded) x as a float32
    copy where it already lives: a tensor on a card stays on that card (a
    device-to-device copy, no host wait), anything else (a CPU tensor, a
    numpy or JAX array) is stored as host numpy.  Admission re-pads onto
    whatever canvas the consuming stream uses.  Card entries hold device
    memory for the cache's life (a news20-sized x is 5.4 MB) and nothing
    bounds their number.
    """

    def __init__(self, lam_rtol: float = 1e-6):
        self.lam_rtol = lam_rtol
        self._store: dict = {}     # (pid, loss) -> {float(lam): x}
        self.stats = CacheStats()

    def __len__(self) -> int:
        return sum(len(v) for v in self._store.values())

    def put(self, problem_id, lam, x, loss: str = "lasso") -> None:
        if isinstance(x, torch.Tensor) and x.device.type != "cpu":
            # a copy, so a caller writing into its x later leaves the entry
            obs.count("serve.cache_host_bytes", 0)
            x = x.detach().to(torch.float32, copy=True)
        else:
            if isinstance(x, torch.Tensor):
                obs.count("serve.cache_host_bytes", x.nbytes)
            x = _host(x)
        self._store.setdefault((problem_id, loss), {})[float(lam)] = x

    def get(self, problem_id, lam, loss: str = "lasso"):
        """(x0 | None, kind) with kind in "exact" / "near" / "miss"."""
        lam = float(lam)
        entries = self._store.get((problem_id, loss))
        if not entries:
            self.stats.misses += 1
            return None, "miss"
        nearest = min(entries, key=lambda l: abs(l - lam))
        if abs(nearest - lam) <= self.lam_rtol * max(1.0, abs(lam)):
            self.stats.hits_exact += 1
            return entries[nearest], "exact"
        self.stats.hits_near += 1
        return entries[nearest], "near"


# ---------------------------------------------------------------------------
# Launch-boundary convergence test (host-side)
# ---------------------------------------------------------------------------

def launch_converged(f_prev, f_launch, tol: float) -> bool:
    """Has a slot converged over one launch?  True when the objective's
    relative CHANGE from the pre-launch value to the launch's last round is
    below ``tol`` in magnitude (and stayed finite).  The launch boundary is
    the only place per-slot progress is observable without breaking the
    fused R-round dataflow, so a slot costs at most one extra launch past
    convergence.  The test is symmetric on purpose: an objective that moved
    UP more than tol is overshooting (early-round interference, Thm 3.2's
    P² term), not converged."""
    f_prev = float(f_prev)
    f_end = float(f_launch[-1])
    if not np.isfinite(f_end):
        return False
    return abs(f_prev - f_end) <= tol * max(1.0, abs(f_end))
