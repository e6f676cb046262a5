"""The plain reference: Block-Shotgun (Bradley et al. 2011, Alg. 2 over
aligned blocks of 128 coordinates) for the Lasso and sparse logistic
regression, written from the paper and the port's documented contract,
in plain PyTorch.  It imports nothing of the port and takes nothing the
port made: the column norms, λ_max, margins and warm starts are worked
out here from the raw inputs of ``bench.data``.

The arithmetic is float64 by default.  ``precision="bf16"`` is the
control: the normalised design values rounded to bfloat16, the rest in
float32.

Definitions (the port's, ``src/repro_torch/core/objectives.py`` and
``kernels/shotgun_block.py``): columns scaled to unit norm (a zero column
keeps scale 1); F(x) = L(Ax) + λ‖x‖₁ with L the squared loss ½‖z − y‖²
or Σ log(1 + exp(−y z)); a round draws K blocks, takes every update from
the round-start margin and iterate, δ_B = S(x_B − g_B/h_B, λ/h_B) − x_B
with h_B = β (1, or ¼ logistic) or, with Newton, max(Σ a² w, 1e-8),
w = σ(−yz)(1 − σ(−yz)); repeated blocks add their updates; F is taken
after each round.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

BLOCK = 128
BETA = {"lasso": 1.0, "logistic": 0.25}
STATUS_OK, STATUS_RECOVERED, STATUS_DIVERGED = 0, 1, 2


def _dtypes(precision: str):
    """(dtype of the arithmetic, dtype the design values are rounded to)."""
    if precision == "f64":
        return torch.float64, torch.float64
    if precision == "bf16":
        return torch.float32, torch.bfloat16
    raise ValueError(f"unknown precision {precision!r}")


class Design:
    """A column-normalised design, dense or in blocked column tiles, with
    the four products a round needs."""

    def __init__(self, A, y: torch.Tensor, loss: str, precision: str = "f64"):
        self.dt, store = _dtypes(precision)
        self.loss = loss
        self.y = y.to(self.dt)
        if isinstance(A, torch.Tensor):
            self.sparse = False
            self.n, self.d = A.shape
            self.nblk = -(-self.d // BLOCK)
            a = A.to(self.dt)
            scale = torch.sqrt(torch.sum(a * a, dim=0))
            scale = torch.where(scale < 1e-12, 1.0, scale)
            a = torch.nn.functional.pad(a / scale, (0, self.nblk * BLOCK
                                                    - self.d))
            self.A = a.to(store).to(self.dt).reshape(self.n, self.nblk,
                                                     BLOCK)
        else:
            self.sparse = True
            self.n, self.d = A.n, A.d
            self.nblk = A.rows.shape[0]
            v = A.vals.to(self.dt)
            scale = torch.sqrt(torch.sum(v * v, dim=1, keepdim=True))
            scale = torch.where(scale < 1e-12, 1.0, scale)
            self.rows = A.rows.long()
            self.vals = (v / scale).to(store).to(self.dt)

    @property
    def d_pad(self) -> int:
        return self.nblk * BLOCK

    def _take(self, idx):
        if self.sparse:
            return self.rows[idx], self.vals[idx]          # (K, tile, B)
        return self.A[:, idx]                              # (n, K, B)

    def gather(self, cols, v) -> torch.Tensor:
        """(K, B): Σ_i a_ij v_i for each column j of the drawn blocks."""
        if self.sparse:
            rows, vals = cols
            return torch.sum(vals * v[rows], dim=1)
        return torch.einsum("nkb,n->kb", cols, v)

    def gather_sq(self, cols, v) -> torch.Tensor:
        """(K, B): Σ_i a_ij² v_i."""
        if self.sparse:
            rows, vals = cols
            return torch.sum(vals * vals * v[rows], dim=1)
        return torch.einsum("nkb,n->kb", cols * cols, v)

    def add(self, cols, delta, z) -> torch.Tensor:
        """z + Σ_k A_{B_k} δ_k."""
        if self.sparse:
            rows, vals = cols
            return z.index_add(0, rows.reshape(-1),
                               (vals * delta[:, None, :]).reshape(-1))
        return z + torch.einsum("nkb,kb->n", cols, delta)

    def matvec(self, x) -> torch.Tensor:
        """A x for x of length d_pad."""
        if self.sparse:
            contrib = self.vals * x.reshape(self.nblk, 1, BLOCK)
            return torch.zeros(self.n, dtype=self.dt,
                               device=x.device).index_add(
                0, self.rows.reshape(-1), contrib.reshape(-1))
        return self.A.reshape(self.n, -1) @ x

    def rmatvec(self, v) -> torch.Tensor:
        """Aᵀ v, length d_pad."""
        if self.sparse:
            return torch.sum(self.vals * v[self.rows], dim=1).reshape(-1)
        return self.A.reshape(self.n, -1).T @ v

    # -- the loss -----------------------------------------------------------
    def residual(self, z):
        if self.loss == "lasso":
            return z - self.y
        return -self.y * torch.sigmoid(-self.y * z)

    def weights(self, z):
        s = torch.sigmoid(-self.y * z)
        return s * (1.0 - s)

    def data_loss(self, z):
        if self.loss == "lasso":
            e = z - self.y
            return 0.5 * torch.dot(e, e)
        m = -self.y * z
        return torch.sum(torch.logaddexp(torch.zeros_like(m), m))

    def objective(self, z, x, lam):
        return self.data_loss(z) + lam * torch.sum(torch.abs(x))

    def lambda_max(self) -> float:
        """The smallest λ at which x = 0 is optimal: ‖Aᵀ ∂L(0)‖_∞."""
        z0 = torch.zeros(self.n, dtype=self.dt, device=self.y.device)
        return float(torch.max(torch.abs(self.rmatvec(self.residual(z0)))))


def soft_threshold(v, t):
    return torch.copysign(torch.clamp_min(v.abs() - t, 0.0), v)


def rounds(D: Design, x, z, idx, lam: float, *, newton: bool, k_eff: int):
    """Rounds over ``idx`` (R, K) from (x, z) with the first ``k_eff``
    drawn blocks live.  Returns (x, z, F after each round (R,))."""
    beta = BETA[D.loss]
    xb = x.reshape(D.nblk, BLOCK).clone()
    live = (torch.arange(idx.shape[1], device=x.device) < k_eff).to(
        D.dt)[:, None]
    fs = []
    for t in range(idx.shape[0]):
        blk = idx[t].long()
        cols = D._take(blk)
        g = D.gather(cols, D.residual(z))
        if newton:
            h = torch.clamp_min(D.gather_sq(cols, D.weights(z)), 1e-8)
        else:
            h = beta
        xs = xb[blk]
        delta = (soft_threshold(xs - g / h, lam / h) - xs) * live
        xb.index_add_(0, blk, delta)
        z = D.add(cols, delta, z)
        fs.append(D.objective(z, xb, lam))
    return xb.reshape(-1), z, torch.stack(fs)


class Solve(NamedTuple):
    x: torch.Tensor       # (d,)
    z: torch.Tensor       # (n,)
    trace: torch.Tensor   # (rounds,) F after each round
    status: int


def status_of(trace, backoffs: int) -> int:
    """The port's status rule: diverged if any F is not finite or the last
    exceeds 1e3·|F₀| + 1e3; else recovered if the guard ever tripped."""
    t = trace
    if not bool(torch.all(torch.isfinite(t))) or \
            float(t[-1]) > 1e3 * abs(float(t[0])) + 1e3:
        return STATUS_DIVERGED
    return STATUS_RECOVERED if backoffs else STATUS_OK


def solve(D: Design, lam: float, idx, *, R: int, newton: bool,
          guard: dict | None) -> Solve:
    """A cold-start solve over ``idx`` (rounds, K) in launches of R rounds.

    With ``guard`` ({"factor", "p_min"}) a launch whose F passes
    factor·|F_good| + factor or stops being finite in any round is thrown
    away: x and z go back to the last good snapshot, the live blocks
    halve (not below p_min), and the launch reports F_good in each of its
    rounds; the snapshot moves on whenever a launch ends at or below
    F_good."""
    K = idx.shape[1]
    dev = D.y.device
    x = torch.zeros(D.d_pad, dtype=D.dt, device=dev)
    z = torch.zeros(D.n, dtype=D.dt, device=dev)
    idx = idx.reshape(-1, R, K)
    k_eff, backoffs = K, 0
    x_good, z_good = x, z
    f_good = float(D.objective(z, x, lam))
    trace = []
    for launch in idx:
        xn, zn, f = rounds(D, x, z, launch, lam, newton=newton, k_eff=k_eff)
        if guard is None:
            x, z = xn, zn
            trace.append(f)
            continue
        thr = guard["factor"] * abs(f_good) + guard["factor"]
        bad = not bool(torch.all(torch.isfinite(f))) or float(f.max()) > thr
        if bad:
            x, z = x_good, z_good
            trace.append(torch.full_like(f, f_good))
            k_eff = max(max(1, min(guard["p_min"], K)), k_eff // 2)
            backoffs += 1
            continue
        x, z = xn, zn
        trace.append(f)
        if float(f[-1]) <= f_good:
            x_good, z_good, f_good = x, z, float(f[-1])
    trace = torch.cat(trace)
    return Solve(x[: D.d], z, trace, status_of(trace, backoffs))


def rel_gap(got, want) -> float:
    """max |got − want| over max |want|: one number for a vector."""
    got = torch.as_tensor(got, dtype=torch.float64, device=want.device)
    want = want.to(torch.float64)
    scale = float(torch.max(torch.abs(want)))
    gap = float(torch.max(torch.abs(got - want)))
    if math.isnan(gap):
        return math.inf
    return gap / scale if scale > 0 else gap


def trace_gap(got, want) -> float:
    """The widest relative gap of two objective traces, round by round."""
    got = torch.as_tensor(got, dtype=torch.float64, device=want.device)
    want = want.to(torch.float64)
    gap = torch.abs(got - want) / torch.clamp_min(torch.abs(want), 1e-30)
    gap = float(torch.max(gap))
    return math.inf if math.isnan(gap) else gap
