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

from repro_torch.data.sparse import BlockedCSC, SparseCols
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

def require_dense(A, what: str):
    """Clear error for the solver families with no sparse path (the CDN
    inner-Newton variants and the duplicated-feature form index raw
    columns); returns A unchanged when dense."""
    if isinstance(A, BlockedCSC):
        raise TypeError(
            f"{what} supports dense designs only, got BlockedCSC — use the "
            "shotgun / block solver families for sparse A")
    return A


def _dense_product(M, v) -> torch.Tensor:
    """M @ v in the promoted dtype of the two, as ``jnp`` promotes (a bf16
    design times an f32 vector is an f32 product)."""
    dt = torch.promote_types(M.dtype, v.dtype)
    if M.is_cuda:
        exact_f32_matmul()
    return M.to(dt) @ v.to(dt)


def matvec(A, x) -> torch.Tensor:
    """A @ x for dense or BlockedCSC A."""
    if isinstance(A, BlockedCSC):
        return A.matvec(x)
    return _dense_product(A, x)


def rmatvec(A, r) -> torch.Tensor:
    """Aᵀ r for dense or BlockedCSC A."""
    if isinstance(A, BlockedCSC):
        return A.rmatvec(r)
    return _dense_product(A.T, r)


def gather_cols(A, idx):
    """The P columns ``idx``: a dense (n, P) tensor, or their nnz tiles
    (``SparseCols``) for a BlockedCSC — O(n·P) against O(tile·P) bytes."""
    if isinstance(A, BlockedCSC):
        return A.gather_cols(idx)
    return A[:, idx.long()]


def cols_rmatvec(cols, r) -> torch.Tensor:
    """(P,) coordinate gradients A_Pᵀ r from a ``gather_cols`` pack."""
    if isinstance(cols, SparseCols):
        rv = r.float()[cols.rows.long()]                     # (P, tile)
        return torch.sum(cols.vals.float() * rv, dim=1)
    return _dense_product(cols.T, r)


def cols_matvec_add(cols, delta, z) -> torch.Tensor:
    """z + A_P δ (the maintained-margin update) from a column pack.  The
    sparse pack adds its (row, value·δ) pairs in a fixed order
    (``index_add_fixed``), so a repeat gives the same bits on every
    device."""
    if isinstance(cols, SparseCols):
        return index_add_fixed(
            z, cols.rows.reshape(-1),
            (cols.vals.float() * delta[:, None]).reshape(-1))
    return z + _dense_product(cols, delta)


def index_add_fixed(base, index, values) -> torch.Tensor:
    """``base`` with ``values[k]`` added at ``index[k]`` (1-D; duplicate
    indices accumulate, as ``jnp``'s ``.at[index].add``), in an order fixed
    by the data alone: the pairs are sorted stably by index, each slot's
    run is summed by ``torch.segment_reduce`` (segment j is the run of
    index j, found by ``searchsorted``; an empty run sums to +0) and the
    sums are added to ``base``.  O(n + m log m) for m pairs into n slots.
    ``index_add_`` on a CUDA tensor adds with float atomics, in an order
    that changes from run to run.  No value is read back to the host."""
    n = base.shape[0]
    s, perm = torch.sort(index.to(torch.int32), stable=True)
    bounds = torch.arange(n + 1, dtype=torch.int32, device=s.device)
    sums = torch.segment_reduce(values[perm], "sum",
                                offsets=torch.searchsorted(s, bounds),
                                unsafe=True)
    return base + sums.to(base.dtype)


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


# ---------------------------------------------------------------------------
# Objective values and gradients: every solver maintains the margin
# z = A x (Sec. 4.1.1), so none of these recompute A x in a round
# ---------------------------------------------------------------------------

def data_loss_from_margin(z: torch.Tensor, y: torch.Tensor,
                          loss: str) -> torch.Tensor:
    if loss == LASSO:
        r = z - y
        return 0.5 * torch.dot(r, r)
    # logistic: Σ log(1 + exp(−y z)), numerically stable
    m = -y * z
    return torch.sum(torch.logaddexp(torch.zeros_like(m), m))


def objective_from_margin(z, x, prob: Problem) -> torch.Tensor:
    return (data_loss_from_margin(z, prob.y, prob.loss)
            + prob.lam * torch.sum(torch.abs(x)))


def objective(x: torch.Tensor, prob: Problem) -> torch.Tensor:
    return objective_from_margin(matvec(prob.A, x), x, prob)


def coordinate_grad(A, r: torch.Tensor, j) -> torch.Tensor:
    """(∇ of data loss)_j = A[:, j]ᵀ r."""
    return torch.dot(A[:, j].to(r.dtype), r)


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


# ---------------------------------------------------------------------------
# Duplicated-feature positive-orthant form (Eq. 4), used by the
# theory-faithful Alg. 2 solver and the theory tests
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DupProblem:
    A: torch.Tensor   # original (n, d); Â = [A, −A] is never materialized
    y: torch.Tensor
    lam: torch.Tensor
    loss: str

    @property
    def d2(self) -> int:
        return 2 * self.A.shape[1]

    @property
    def beta(self) -> float:
        return BETA[self.loss]


def dup_from(prob: Problem) -> DupProblem:
    require_dense(prob.A, "the duplicated-feature form (Eq. 4)")
    return DupProblem(prob.A, prob.y, prob.lam, prob.loss)


def dup_column(dp: DupProblem, j):
    """Column j of Â = [A, −A] without materializing it; (column, sign)."""
    d = dp.A.shape[1]
    j = torch.as_tensor(j, device=dp.A.device)
    sign = torch.where(j < d, 1.0, -1.0)
    return sign * dp.A[:, j % d], sign


def dup_objective(xhat: torch.Tensor, dp: DupProblem) -> torch.Tensor:
    d = dp.A.shape[1]
    z = matvec(dp.A, xhat[:d] - xhat[d:])
    return data_loss_from_margin(z, dp.y, dp.loss) + dp.lam * torch.sum(xhat)


def dup_to_signed(xhat: torch.Tensor) -> torch.Tensor:
    d = xhat.shape[0] // 2
    return xhat[:d] - xhat[d:]
