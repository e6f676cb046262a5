"""L1-regularized objectives from the paper (Eq. 1-4).

  * Lasso (Eq. 2):             F(x) = 1/2 ||Ax - y||^2 + lam ||x||_1
  * Sparse logistic (Eq. 3):   F(x) = sum_i log(1 + exp(-y_i a_i^T x)) + lam ||x||_1

Conventions follow ``repro.core.objectives``: ``A`` is (n, d) with columns
normalized so diag(AᵀA) = 1 (``normalize_columns``; the original column
norms ride on ``Problem.scales``), and beta is the per-coordinate curvature
bound of Assumption 2.1 (1 squared, 1/4 logistic — Eq. 6).  ``A`` may be a
dense tensor or a ``data.sparse.BlockedCSC``: every consumer of A goes
through the ``matvec``/``rmatvec`` seam, so both layouts run the same code.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data.sparse import BlockedCSC
from repro_torch.device import exact_f32_matmul, resolve_device

LASSO = "lasso"
LOGISTIC = "logistic"

BETA = {LASSO: 1.0, LOGISTIC: 0.25}


@dataclasses.dataclass(frozen=True)
class Problem:
    """An instance of Eq. (1) with its tensors on one device."""

    A: torch.Tensor | BlockedCSC   # (n, d) design, col-normalized
    y: torch.Tensor           # (n,) observations (reals for lasso, +-1 for logistic)
    lam: torch.Tensor         # 0-dim f32 regularization
    loss: str                 # LASSO | LOGISTIC
    scales: torch.Tensor | None = None   # (d,) original column norms, or None

    def _replace(self, **kw) -> "Problem":
        return dataclasses.replace(self, **kw)

    @property
    def n(self) -> int:
        return self.A.shape[0]

    @property
    def d(self) -> int:
        return self.A.shape[1]

    @property
    def beta(self) -> float:
        return BETA[self.loss]


def normalize_columns(A, eps: float = 1e-12):
    """Scale columns of A (dense or BlockedCSC) to unit l2 norm; returns
    (A_normalized, scales)."""
    if isinstance(A, BlockedCSC):
        scales = A.col_norms()
        scales = torch.where(scales < eps, torch.ones_like(scales), scales)
        return A.scale_cols(scales), scales
    scales = torch.sqrt(torch.sum(A * A, dim=0))
    scales = torch.where(scales < eps, torch.ones_like(scales), scales)
    return A / scales[None, :], scales


def check_logistic_labels(y) -> None:
    """Eq. 3 needs y ∈ {−1, +1}: the stable log1p margin form silently
    computes nonsense for anything else, so fail at construction."""
    labels = (y.detach().cpu().numpy() if isinstance(y, torch.Tensor)
              else np.asarray(y))
    bad = labels[(labels != 1.0) & (labels != -1.0)]
    if bad.size:
        raise ValueError(
            f"logistic labels must be in {{-1.0, +1.0}}; got "
            f"{np.unique(bad)[:8].tolist()} "
            f"({bad.size}/{labels.size} offending values)")


def make_problem(A, y, lam, loss=LASSO, normalize=True, *,
                 device="cuda") -> Problem:
    """Build a ``Problem`` on ``device`` from arrays, tensors (f32) or a
    ``BlockedCSC`` (moved to ``device``)."""
    dev = resolve_device(device)
    if isinstance(A, BlockedCSC):
        A = A.to(dev)
    else:
        A = torch.as_tensor(A, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, dtype=torch.float32, device=dev)
    if loss == LOGISTIC:
        check_logistic_labels(y)
    scales = None
    if normalize:
        A, scales = normalize_columns(A)
    lam = torch.as_tensor(lam, dtype=torch.float32, device=dev)
    return Problem(A=A, y=y, lam=lam, loss=loss, scales=scales)


def unscale_x(x: torch.Tensor, scales: torch.Tensor | None) -> torch.Tensor:
    """Map a solution of the column-normalized problem back to the raw
    feature space: A_raw (x / scales) == A_norm x."""
    return x if scales is None else x / scales


# ---------------------------------------------------------------------------
# Representation seam: dense tensors and BlockedCSC containers
# ---------------------------------------------------------------------------

def matvec(A, x) -> torch.Tensor:
    """A @ x for dense or BlockedCSC A."""
    if isinstance(A, BlockedCSC):
        return A.matvec(x)
    if A.is_cuda:
        exact_f32_matmul()
    return A @ x


def rmatvec(A, r) -> torch.Tensor:
    """Aᵀ r for dense or BlockedCSC A."""
    if isinstance(A, BlockedCSC):
        return A.rmatvec(r)
    if A.is_cuda:
        exact_f32_matmul()
    return A.T @ r


def residual_like(z: torch.Tensor, y: torch.Tensor, loss: str) -> torch.Tensor:
    """dL/dz — the vector r such that grad of data loss = Aᵀ r.

    Lasso: r = z - y.  Logistic: r = -y * sigmoid(-y z).
    """
    if loss == LASSO:
        return z - y
    return -y * torch.sigmoid(-y * z)


def soft_threshold(v: torch.Tensor, t) -> torch.Tensor:
    """sign(v)·max(|v| − t, 0), NaN-propagating like ``jnp.sign`` (torch's
    ``sign`` maps NaN to 0, which would hide a diverged coordinate)."""
    return torch.copysign(torch.clamp_min(v.abs() - t, 0.0), v)


def shooting_delta(x_j, g_j, lam, beta):
    """Signed-form coordinate update (equivalent to Eq. 5 on the duplicated
    problem): minimize the Assumption-2.1 quadratic model plus λ|x_j + δ|.

        x_j_new = S(x_j − g_j / β, λ / β),   δ = x_j_new − x_j
    """
    return soft_threshold(x_j - g_j / beta, lam / beta) - x_j


def masked_data_loss(z: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                     loss: str) -> torch.Tensor:
    """Data loss restricted to real samples (``mask`` zeros out the rows
    ``kernels.ops.pad_problem`` added)."""
    if loss == LASSO:
        e = z - y
        return 0.5 * torch.sum(e * (e * mask))
    return torch.sum(mask * torch.logaddexp(torch.zeros_like(z), -y * z))


def lambda_max(A, y: torch.Tensor, loss: str) -> torch.Tensor:
    """Smallest lam for which x = 0 is optimal: ||Aᵀ dL/dz(0)||_inf."""
    dtype = torch.float32 if isinstance(A, BlockedCSC) else A.dtype
    z0 = torch.zeros(A.shape[0], dtype=dtype, device=A.device)
    r0 = residual_like(z0, y, loss)
    return torch.max(torch.abs(rmatvec(A, r0)))
