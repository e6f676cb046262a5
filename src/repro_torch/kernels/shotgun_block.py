"""Dense Block-Shotgun kernels for Hopper and their plain PyTorch versions.

Port of ``repro.kernels.shotgun_block``.  Four kernels, written in CUDA C++
in ``csrc/shotgun_block.cu`` and built by ``kernels/_build.py``:

  gather_block_matvec         g[k] = A[:, blk_k]ᵀ r              (K, 128)
  scatter_block_update        z + Σ_k A[:, blk_k] δ_k            (n,)
  fused_shotgun_rounds        R Block-Shotgun rounds in one launch
  fused_shotgun_delta_rounds  R rounds against a margin snapshot,
                              emitting Δz (the sharded driver's engine)

Each wrapper keeps the JAX signature and return tuple, minus the TPU-only
``interpret``/``tile_n`` knobs; ``fused_shotgun_rounds`` adds keyword-only
``stamps`` (a per-phase clock).  A wrapper given CPU tensors runs its plain
version (``*_plain``, same module, same dataflow); given CUDA tensors it
launches the kernel or raises — it never falls back.  ``LAUNCHES`` counts
kernel launches per wrapper.  The two-kernel pair (and the BlockedCSC
pair in ``shotgun_sparse``) launch through a lean path: the library kept
in a module global, the raw stream, integer pointers, no device switch
and no copy of an operand already in the kernel's type.

The block width stays BLOCK = 128 and padded shapes stay multiples of
TILE_N = 512 samples (``ops.pad_problem``), so block indices and padded
arrays carry over between the packages unchanged.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.device import exact_f32_matmul

BLOCK = 128        # coordinate block width
TILE_N = 512       # sample-dimension padding unit

LASSO = "lasso"
LOGISTIC = "logistic"

# Kernel launches per wrapper (``reset_launches`` zeroes them).
LAUNCHES = {"fused_shotgun_rounds": 0, "gather_block_matvec": 0,
            "scatter_block_update": 0, "fused_shotgun_delta_rounds": 0}

_GATHER_ROW_UNIT = 256    # fused gather row tiles are multiples of this
_GATHER_MAX_TILES = 256   # ... chosen so that T = ceil(n / rows) <= this
_SCATTER_ROWS = 32        # rows per scatter tile (one loss partial each)
_CHUNK_UNIT = 8           # gather_block_matvec: chunk rows are multiples


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _soft_threshold(v, t):
    return torch.copysign(torch.clamp_min(v.abs() - t, 0.0), v)


def _stable_logistic_tile(z, y):
    """The stable logistic tile, in f32: with m = −y·z,

      sig = σ(m)                 |residual| factor (r = −y·sig)
      ll  = max(m, 0) + log1p(exp(−|m|))   per-sample loss
      w   = sig·(1 − sig)        diagonal-Hessian weight (= σ(z)(1 − σ(z))
                                 for y ∈ {−1, +1})
    """
    m = -y * z
    sig = torch.sigmoid(m)
    ll = torch.clamp_min(m, 0.0) + torch.log1p(torch.exp(-torch.abs(m)))
    w = sig * (1.0 - sig)
    return sig, ll, w


class Loss(NamedTuple):
    """Static loss spec of the fused kernel (the loss seam, DESIGN §12).

      ``residual(z, y, m)``            dL/dz, masked to real samples
      ``curvature_weights(z, y, m)``   w_i with h_j = Σ_i a_ij² w_i
      ``data_loss(z, y, m)``           the masked data term
      ``beta``                         Assumption-2.1 curvature bound (1
                                       squared, 1/4 logistic per Eq. 6)
      ``newton``                       divide by max(h_B, 1e-8) instead of
                                       beta (Bian et al.)
    """

    name: str
    beta: float
    newton: bool = False

    def residual(self, z, y, m):
        if self.name == LASSO:
            return (z - y) * m
        sig, _, _ = _stable_logistic_tile(z, y)
        return (-y * sig) * m

    def curvature_weights(self, z, y, m):
        if self.name == LASSO:
            return m
        _, _, w = _stable_logistic_tile(z, y)
        return w * m

    def data_loss(self, z, y, m):
        if self.name == LASSO:
            e = z - y
            return 0.5 * torch.sum(e * (e * m))
        _, ll, _ = _stable_logistic_tile(z, y)
        return torch.sum(m * ll)

    def objective(self, z, y, m, x, lam):
        return self.data_loss(z, y, m) + lam * torch.sum(torch.abs(x))


SQUARED_LOSS = Loss(LASSO, beta=1.0)
LOGISTIC_LOSS = Loss(LOGISTIC, beta=0.25)                  # Eq. 6
LOGISTIC_NEWTON = Loss(LOGISTIC, beta=0.25, newton=True)   # Bian et al.

LOSSES = {"lasso": SQUARED_LOSS, "logistic": LOGISTIC_LOSS,
          "logistic_newton": LOGISTIC_NEWTON}


def _loss_code(ls: Loss) -> int:
    """Template selector in the CUDA source: bit 0 logistic, bit 1 Newton
    (bit 2, the delta kernels, is set by the C entry itself)."""
    return int(ls.name == LOGISTIC) + 2 * int(ls.newton)


def resolve_loss(loss) -> Loss:
    """Map a registry string (or a ``Loss``, returned unchanged) to the
    static ``Loss`` spec."""
    if isinstance(loss, Loss):
        return loss
    try:
        return LOSSES[loss]
    except KeyError:
        raise ValueError(
            f"unknown loss {loss!r}; choose from {sorted(LOSSES)} or pass a "
            f"Loss instance") from None


# ---------------------------------------------------------------------------
# Checks and plumbing shared by the wrappers
# ---------------------------------------------------------------------------

def _check_design(A: torch.Tensor) -> tuple[int, int]:
    """Raise (don't assert) when A does not tile: the kernels index A by
    whole 128-column blocks and 32/256-row tiles of a TILE_N-padded n."""
    if A.dim() != 2:
        raise ValueError(f"A must be 2-D, got shape {tuple(A.shape)}")
    n, d = A.shape
    if d % BLOCK:
        raise ValueError(f"d={d} not divisible by block={BLOCK}")
    if n % TILE_N:
        raise ValueError(f"n={n} not divisible by {TILE_N} "
                         "(pad with ops.pad_problem)")
    if A.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"A must be float32 or bfloat16, got {A.dtype}")
    return n, d


def _scalars(lam, beta, k_eff, guard_f, device) -> torch.Tensor:
    """The (4,) f32 device vector [lam, beta, k_eff, guard_f] — the
    counterpart of the TPU kernel's scalar-prefetch operand.  Tensor
    arguments stay on the device (no ``.item()``)."""
    parts = [v.to(device=device, dtype=torch.float32).reshape(())
             if isinstance(v, torch.Tensor) else
             # filled on the device: a host-to-device copy of a Python
             # number would wait for the stream, serialising the launches
             torch.full((), float(v), dtype=torch.float32, device=device)
             for v in (lam, beta, k_eff, guard_f)]
    return torch.stack(parts)


def _gather_rows(n: int) -> int:
    """Rows per gather tile of the fused kernels: a multiple of 256 with at
    most 256 tiles, so the fixed-order reduction over tiles stays short at
    any n."""
    return _GATHER_ROW_UNIT * max(1, math.ceil(n / (_GATHER_ROW_UNIT
                                                    * _GATHER_MAX_TILES)))


def _check_stamps(stamps, R: int, dev) -> None:
    need = 2 + 3 * R
    if stamps is not None and (stamps.dtype != torch.int64
                               or stamps.numel() < need
                               or stamps.device != dev):
        raise ValueError(f"stamps must be an int64 tensor of >= {need} "
                         f"elements on {dev}")


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for all-CUDA operands (launch the kernel), False for all-CPU
    ones (plain version); anything else raises."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    devs = {t.device for t in tensors}
    if types == {"cuda"} and len(devs) == 1:
        return True
    raise ValueError(f"operands must all be on one CUDA device or all on "
                     f"the CPU, got {sorted(str(d) for d in devs)}")


def _require_contiguous(A: torch.Tensor) -> None:
    if not A.is_contiguous():
        raise ValueError("the CUDA kernels take a row-major contiguous A")


def _gather_chunks(n: int, K: int, slots: int) -> int:
    """Row chunks C per drawn block of ``gather_block_matvec``'s launch of
    K·C CTAs: as many as fill the card's ``slots`` resident CTAs in one
    wave, at least one, and at most n / 8 (so no chunk is empty)."""
    return max(1, min(n // _CHUNK_UNIT, slots // K))


def _chunk_rows(n: int, C: int, c: int) -> tuple[int, int]:
    """Rows [start, stop) of chunk c of C (the kernel's rule): the n / 8
    units of 8 rows split as evenly as integers allow, so chunks differ
    by at most 8 rows."""
    units = n // _CHUNK_UNIT
    return (_CHUNK_UNIT * (units * c // C),
            _CHUNK_UNIT * (units * (c + 1) // C))


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({torch.cuda.get_device_name()})")


def _contig(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.to(dtype).contiguous()


# ---------------------------------------------------------------------------
# The two-kernel pairs' lean launch path: the library and the raw-stream
# getter kept in module globals, no device switch, no copy of an operand
# that is already contiguous and of the kernel's type, ints for pointers.
# ---------------------------------------------------------------------------

_LIB = None          # the loaded kernel library, after the first launch
# device index -> PyTorch's current stream (int)
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda dev: torch.cuda.current_stream(dev).cuda_stream)
_SLOTS: dict = {}    # (device, kernel, bf16) -> resident CTAs of the kernel
_WORK: dict = {}     # (device, stream) -> gather tickets and partials


def _lib():
    """The kernel library, built at first use and kept."""
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import _build
        _LIB = _build.load()
    return _LIB


def _launch_device(t: torch.Tensor, *others: torch.Tensor) -> int:
    """The CUDA device index to launch on when ``t`` and ``others`` lie on
    one CUDA device, which must be the current one (the launch goes there
    with no device switch); -1 when all lie on the CPU (the plain version);
    raises for anything else."""
    dev = t.get_device()
    for o in others:
        if o.get_device() != dev:
            dev = -1
            break
    if dev < 0:
        _on_cuda(t, *others)            # raises unless all are on the CPU
        return -1
    cur = torch.cuda.current_device()
    if dev != cur:
        raise ValueError(f"operands are on cuda:{dev} but the current device "
                         f"is cuda:{cur}; call torch.cuda.set_device({dev}) "
                         "first")
    return dev


def _as(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` itself when contiguous and of ``dtype``, else such a copy."""
    if t.dtype == dtype and t.is_contiguous():
        return t
    return t.to(dtype).contiguous()


def _pair_slots(lib, dev: int, which: int, bf16: bool) -> int:
    """Resident CTAs of the gather (``which`` 0) or the scatter (1) on
    device ``dev``, asked of ``lib`` once."""
    key = (dev, which, bf16)
    slots = _SLOTS.get(key)
    if slots is None:
        slots = lib.sb_pair_slots(which, bf16)
        if slots <= 0:
            raise RuntimeError(f"sb_pair_slots: CUDA error {-slots} "
                               f"({torch.cuda.get_device_name()})")
        _SLOTS[key] = slots
    return slots


def _gather_work(dev: int, stream: int, K: int, n_part: int, device):
    """The gather's tickets (>= K int32, zero between calls: the launch's
    last CTA per block resets its own) and partials (>= n_part f32) for
    this device and stream, made anew when too small.  One workspace a
    stream, so two calls in flight on two streams never share a ticket."""
    work = _WORK.get((dev, stream))
    if work is None or work[0].numel() < K or work[1].numel() < n_part:
        work = (torch.zeros(K, dtype=torch.int32, device=device),
                torch.empty(n_part, dtype=torch.float32, device=device))
        _WORK[(dev, stream)] = work
    return work


def _take_blocks(A: torch.Tensor, blk_idx: torch.Tensor) -> torch.Tensor:
    """(n, K, BLOCK) f32 copy of the selected column blocks."""
    n, d = A.shape
    return A.reshape(n, d // BLOCK, BLOCK)[:, blk_idx.long(), :].float()


# ---------------------------------------------------------------------------
# Kernel 1: g[k] = A[:, blk_k*B:(blk_k+1)*B]^T r
# ---------------------------------------------------------------------------

def gather_block_matvec_plain(A, r, blk_idx):
    """Plain version of ``gather_block_matvec`` (f32 accumulation)."""
    if A.is_cuda:
        exact_f32_matmul()
    return torch.einsum("nkb,n->kb", _take_blocks(A, blk_idx), r.float())


def gather_block_matvec(A, r, blk_idx):
    """g (K, 128) f32 = per-selected-block column gradients A_Bᵀ r.  On the
    card a call is one launch and, with f32 r and int32 blk_idx and once
    the stream's workspace exists, no other device operation."""
    n, d = _check_design(A)
    K = blk_idx.shape[0]
    dev = _launch_device(A, r, blk_idx)
    if dev < 0:
        return gather_block_matvec_plain(A, r, blk_idx)
    _require_contiguous(A)
    lib = _lib()
    bf16 = A.dtype == torch.bfloat16
    C = _gather_chunks(n, K, _pair_slots(lib, dev, 0, bf16))
    stream = _RAW_STREAM(dev)
    ticket, part = _gather_work(dev, stream, K, K * C * BLOCK, A.device)
    rv = _as(r, torch.float32)
    idx = _as(blk_idx, torch.int32)
    g = torch.empty((K, BLOCK), dtype=torch.float32, device=A.device)
    rc = lib.sb_gather_block_matvec(
        A.data_ptr(), bf16, rv.data_ptr(), idx.data_ptr(), part.data_ptr(),
        ticket.data_ptr(), g.data_ptr(), n, d, K, C, stream)
    _check_rc(rc, "gather_block_matvec")
    LAUNCHES["gather_block_matvec"] += 1
    return g


# ---------------------------------------------------------------------------
# Kernel 2: z + sum_k A[:, blk_k] @ delta_k   (the shared-Ax write)
# ---------------------------------------------------------------------------

def scatter_block_update_plain(A, z, blk_idx, delta):
    """Plain version of ``scatter_block_update``."""
    if A.is_cuda:
        exact_f32_matmul()
    dz = torch.einsum("nkb,kb->n", _take_blocks(A, blk_idx),
                      delta.to(A.dtype).float())
    return (z.float() + dz).to(z.dtype)


def scatter_block_update(A, z, blk_idx, delta):
    """z_new = z + Σ_k A[:, blk_k] δ_k — f32 accumulation, z.dtype out.
    δ is rounded to A's dtype first, as the TPU kernel feeds it (on the
    card, by the kernel).  On the card a call is one launch and, with f32
    z and δ and int32 blk_idx, no other device operation."""
    n, d = _check_design(A)
    K = blk_idx.shape[0]
    dev = _launch_device(A, z, blk_idx, delta)
    if dev < 0:
        return scatter_block_update_plain(A, z, blk_idx, delta)
    _require_contiguous(A)
    lib = _lib()
    bf16 = A.dtype == torch.bfloat16
    grid = min(_pair_slots(lib, dev, 1, bf16), n // _SCATTER_ROWS)
    z_in = _as(z, torch.float32)
    idx = _as(blk_idx, torch.int32)
    # a wider δ is rounded to A's type once here, as the plain version does
    dlt = _as(delta if delta.dtype == torch.float32 else delta.to(A.dtype),
              torch.float32)
    if dlt.data_ptr() % 16:                  # the kernel reads δ in float4s
        dlt = dlt.clone()
    z_out = torch.empty(n, dtype=torch.float32, device=A.device)
    rc = lib.sb_scatter_block_update(
        A.data_ptr(), bf16, z_in.data_ptr(), idx.data_ptr(), dlt.data_ptr(),
        z_out.data_ptr(), n, d, K, grid, _RAW_STREAM(dev))
    _check_rc(rc, "scatter_block_update")
    LAUNCHES["scatter_block_update"] += 1
    return z_out if z.dtype == torch.float32 else z_out.to(z.dtype)


# ---------------------------------------------------------------------------
# Kernel 3: fused multi-round Block-Shotgun — R rounds per launch
# ---------------------------------------------------------------------------

def _plain_round(ls: Loss, A, z, xb, idx, lam, beta, y, m, live):
    """One round of the fused plain versions: every δ from the residual
    (and Newton weights) of the round-start margin z and the pre-round x;
    x[blk] += δ in k order in place (duplicates accumulate).  Returns the
    round's margin contribution Σ_k A_B δ_k."""
    Ak = _take_blocks(A, idx)                              # (n, K, B)
    g = torch.einsum("nkb,n->kb", Ak, ls.residual(z, y, m))
    if ls.newton:
        w = ls.curvature_weights(z, y, m)
        h = torch.clamp_min(torch.einsum("nkb,n->kb", Ak * Ak, w), 1e-8)
    else:
        h = beta
    x_sel = xb[idx]
    dlt = (_soft_threshold(x_sel - g / h, lam / h) - x_sel) * live
    for k in range(idx.shape[0]):
        xb.index_add_(0, idx[k:k + 1], dlt[k:k + 1])
    return torch.einsum("nkb,kb->n", Ak, dlt)


def fused_shotgun_rounds_plain(A, z, x, blk_idx, lam, beta, y, mask,
                               loss: str | Loss = LASSO, k_eff=None,
                               guard_f=None):
    """Plain version of ``fused_shotgun_rounds``, with the kernel's
    dataflow: each round takes the residual (and Newton weights) of the
    round-start margin, computes every delta from the pre-round x, updates
    z, applies x[blk] += δ in k order at round end (duplicates accumulate),
    then computes F and nnz from the updated (x, z)."""
    ls = resolve_loss(loss)
    n, d = _check_design(A)
    R, K = blk_idx.shape
    if A.is_cuda:
        exact_f32_matmul()
    lam, beta, k_eff, guard = _scalars(
        lam, beta, K if k_eff is None else k_eff,
        math.inf if guard_f is None else guard_f, A.device).unbind()
    y = y.float()
    m = mask.float()
    z = z.float().clone()
    xb = x.float().reshape(d // BLOCK, BLOCK).clone()
    live = (torch.arange(K, device=A.device) < k_eff.int()).float()[:, None]
    health = torch.zeros((), dtype=torch.float32, device=A.device)
    fs, nnzs = [], []
    for t in range(R):
        z = z + _plain_round(ls, A, z, xb, blk_idx[t].long(), lam, beta, y,
                             m, live)
        f = ls.objective(z, y, m, xb, lam)
        bad = ~torch.isfinite(f) | (f > guard)
        health = torch.maximum(health, bad.float())
        fs.append(f)
        nnzs.append(torch.sum(xb != 0))
    return (xb.reshape(d), z, torch.stack(fs),
            torch.stack(nnzs).to(torch.int32), health)


def fused_shotgun_rounds(A, z, x, blk_idx, lam, beta, y, mask,
                         loss: str | Loss = LASSO, k_eff=None, guard_f=None,
                         *, stamps: torch.Tensor | None = None):
    """R Block-Shotgun rounds in ONE kernel launch.

    A        (n, d) design, f32 or bf16 (accumulation is f32 regardless).
    z        (n,) margin A x;  x (d,) iterate;  y (n,);  mask (n,) sample
             mask from ``ops.pad_problem``.
    blk_idx  (R, K) int — round t updates aligned coordinate blocks
             blk_idx[t, 0..K-1] (duplicates allowed, multiset semantics).
    loss     ``"lasso"`` / ``"logistic"`` / ``"logistic_newton"`` or a
             ``Loss``; ``beta`` is ignored by Newton specs.
    k_eff    effective block count: blocks k >= k_eff are drawn but masked
             out (the adaptive-P backoff knob).  None = all K live.
    guard_f  objective guard level: health trips when a round's F exceeds
             it or goes non-finite.  None = +inf = finite-only.

    ``lam``, ``beta``, ``k_eff`` and ``guard_f`` may be numbers or 0-dim
    device tensors; tensors are never read back to the host.

    stamps   optional (2 + 3·R,) int64 CUDA tensor: the SM clock of the
             grid's last block at launch start, after the launch's first
             barrier and, each round, after its gather, reduce and scatter
             (ignored on the CPU).

    Returns (x_new (d,) f32, z_new (n,) f32, f (R,) f32, nnz (R,) int32,
    health () f32).
    """
    ls = resolve_loss(loss)
    n, d = _check_design(A)
    R, K = blk_idx.shape
    if not _on_cuda(A, z, x, blk_idx, y, mask):
        return fused_shotgun_rounds_plain(A, z, x, blk_idx, lam, beta, y,
                                          mask, ls, k_eff, guard_f)
    _require_contiguous(A)
    from repro_torch.kernels import _build
    lib = _build.load()
    dev = A.device
    rows = _gather_rows(n)
    T = math.ceil(n / rows)
    scal = _scalars(lam, beta, K if k_eff is None else k_eff,
                    math.inf if guard_f is None else guard_f, dev)
    idx = _contig(blk_idx, torch.int32)
    yv = _contig(y, torch.float32)
    mv = _contig(mask, torch.float32)
    z_out = z.to(torch.float32, copy=True).contiguous()
    x_out = x.to(torch.float32, copy=True).contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    r = torch.empty(n, **f32)
    w = torch.empty(n if ls.newton else 1, **f32)
    gpart = torch.empty((K, T, BLOCK), **f32)
    hpart = torch.empty((K, T, BLOCK) if ls.newton else (1,), **f32)
    dlt = torch.empty((K, BLOCK), **f32)
    lpart = torch.empty(n // _SCATTER_ROWS, **f32)
    f = torch.empty(R, **f32)
    nnz = torch.empty(R, dtype=torch.int32, device=dev)
    health = torch.zeros((), **f32)
    _check_stamps(stamps, R, dev)
    with torch.cuda.device(dev):
        rc = lib.sb_fused_shotgun_rounds(
            _ptr(A), int(A.dtype == torch.bfloat16), _loss_code(ls),
            _ptr(yv), _ptr(mv), _ptr(idx), _ptr(scal), _ptr(z_out),
            _ptr(x_out), _ptr(r), _ptr(w), _ptr(gpart), _ptr(hpart),
            _ptr(dlt), _ptr(lpart), _ptr(f), _ptr(nnz), _ptr(health), n, d,
            R, K, rows, T, None if stamps is None else _ptr(stamps),
            _stream(dev))
    _check_rc(rc, "fused_shotgun_rounds")
    LAUNCHES["fused_shotgun_rounds"] += 1
    return x_out, z_out, f, nnz, health


# ---------------------------------------------------------------------------
# Kernel 4: R fused rounds against a margin snapshot, emitting Δz
# ---------------------------------------------------------------------------

def fused_shotgun_delta_rounds_plain(A, z, x, blk_idx, lam, beta, y, mask,
                                     loss: str | Loss = LASSO, k_eff=None):
    """Plain version of ``fused_shotgun_delta_rounds``, with the kernel's
    dataflow: a live view z0 + own contributions and a Δz accumulator, each
    round's contribution Σ_k A_B δ_k added to both; the residual (and Newton
    weights) of the round-start view; every δ from the pre-round x; x[blk]
    += δ in k order at round end; health 1 once the view holds a non-finite
    value after a round."""
    ls = resolve_loss(loss)
    n, d = _check_design(A)
    R, K = blk_idx.shape
    if A.is_cuda:
        exact_f32_matmul()
    lam, beta, k_eff, _ = _scalars(lam, beta, K if k_eff is None else k_eff,
                                   math.inf, A.device).unbind()
    y = y.float()
    m = mask.float()
    view = z.float().clone()
    dz = torch.zeros_like(view)
    xb = x.float().reshape(d // BLOCK, BLOCK).clone()
    live = (torch.arange(K, device=A.device) < k_eff.int()).float()[:, None]
    health = torch.zeros((), dtype=torch.float32, device=A.device)
    for t in range(R):
        c = _plain_round(ls, A, view, xb, blk_idx[t].long(), lam, beta, y, m,
                         live)
        view = view + c
        dz = dz + c
        health = torch.maximum(
            health, (~torch.all(torch.isfinite(view))).float())
    return xb.reshape(d), dz, health


def fused_shotgun_delta_rounds(A, z, x, blk_idx, lam, beta, y, mask,
                               loss: str | Loss = LASSO, k_eff=None):
    """The sharded driver's fused engine: R rounds in ONE launch against a
    read-only margin snapshot ``z`` (the last merged global margin).

    The kernel keeps a live view z + its own contributions (the shard sees
    its own rounds at once, other shards' only at the next merge) and
    accumulates those contributions into Δz = A_shard δx for the caller to
    all-reduce.  No objective or nnz: ``health`` trips when the view holds
    a non-finite value after a round.  Arguments as ``fused_shotgun_rounds``
    (no ``guard_f`` or ``stamps``); ``k_eff`` may be a 0-dim device
    tensor.

    Returns (x_new (d,) f32, dz (n,) f32, health () f32).
    """
    ls = resolve_loss(loss)
    n, d = _check_design(A)
    R, K = blk_idx.shape
    if not _on_cuda(A, z, x, blk_idx, y, mask):
        return fused_shotgun_delta_rounds_plain(A, z, x, blk_idx, lam, beta,
                                                y, mask, ls, k_eff)
    _require_contiguous(A)
    from repro_torch.kernels import _build
    lib = _build.load()
    dev = A.device
    rows = _gather_rows(n)
    T = math.ceil(n / rows)
    scal = _scalars(lam, beta, K if k_eff is None else k_eff, math.inf, dev)
    idx = _contig(blk_idx, torch.int32)
    yv = _contig(y, torch.float32)
    mv = _contig(mask, torch.float32)
    z0 = _contig(z, torch.float32)
    x_out = x.to(torch.float32, copy=True).contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    view = torch.empty(n, **f32)             # filled from z0 by the kernel
    dz = torch.empty(n, **f32)               # zeroed by the kernel
    r = torch.empty(n, **f32)
    w = torch.empty(n if ls.newton else 1, **f32)
    gpart = torch.empty((K, T, BLOCK), **f32)
    hpart = torch.empty((K, T, BLOCK) if ls.newton else (1,), **f32)
    dlt = torch.empty((K, BLOCK), **f32)
    health = torch.zeros((), **f32)
    with torch.cuda.device(dev):
        rc = lib.sb_fused_shotgun_delta_rounds(
            _ptr(A), int(A.dtype == torch.bfloat16), _loss_code(ls),
            _ptr(yv), _ptr(mv), _ptr(idx), _ptr(scal), _ptr(z0), _ptr(view),
            _ptr(dz), _ptr(x_out), _ptr(r), _ptr(w), _ptr(gpart),
            _ptr(hpart), _ptr(dlt), _ptr(health), n, d, R, K, rows, T,
            _stream(dev))
    _check_rc(rc, "fused_shotgun_delta_rounds")
    LAUNCHES["fused_shotgun_delta_rounds"] += 1
    return x_out, dz, health
