"""Synthetic dataset generators: the dense categories of the paper's Lasso
study (Sec. 4.1.3) and its logistic-regression regimes (Sec. 4.2.3).

``sparco``, ``singlepixcam`` and ``logistic_data`` are numpy copies of
``repro.data.synthetic``: the same seed gives bit-identical arrays, so the
two packages can be fed the same problem.  Each returns (A, y, x_true) with
columns NOT pre-normalized; use ``objectives.make_problem``.

``sparco_on_device`` / ``logistic_data_on_device`` draw from the same
distributions with a ``torch.Generator`` on the target device, for sizes
where drawing 10⁹ normals in numpy on the host would dominate the run.
They do not reproduce numpy's stream.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import exact_f32_matmul, resolve_device


def _sparse_signal(rng, d, nnz_frac):
    x = np.zeros(d, np.float32)
    k = max(1, int(d * nnz_frac))
    idx = rng.choice(d, k, replace=False)
    x[idx] = rng.standard_normal(k).astype(np.float32) * 2.0
    return x


def sparco(seed=0, n=1024, d=2048, nnz_frac=0.05, noise=0.01, corr=0.0):
    """Random dense design with optional AR(1)-style column correlation.

    ``corr`` interpolates between iid columns (rho ~ d/n+1) and strongly
    correlated ones (rho -> d) — the two regimes of Fig. 2.
    """
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, d)).astype(np.float32)
    if corr > 0:
        common = rng.standard_normal((n, 1)).astype(np.float32)
        base = (1 - corr) * base + corr * common
    x = _sparse_signal(rng, d, nnz_frac)
    y = base @ x + noise * rng.standard_normal(n).astype(np.float32)
    return base, y, x


def singlepixcam(seed=0, n=410, d=1024, nnz_frac=0.05, noise=0.005):
    """Dense +-1 Bernoulli measurement matrix (Duarte et al. 2008 style)."""
    rng = np.random.default_rng(seed)
    A = rng.choice([-1.0, 1.0], size=(n, d)).astype(np.float32) / np.sqrt(n)
    x = _sparse_signal(rng, d, nnz_frac)
    y = A @ x + noise * rng.standard_normal(n).astype(np.float32)
    return A, y, x


def logistic_data(seed=0, n=4096, d=512, nnz_frac=0.05, flip=0.02,
                  density=1.0, layout="dense"):
    """Labels in {-1,+1} from a sparse linear teacher (zeta/rcv1 regimes).

    ``density < 1`` sparsifies the design (rcv1-like bag-of-words rows).
    Only the dense layout exists in the port so far.
    """
    if layout == "bcsc":
        raise NotImplementedError(
            "layout='bcsc' needs the BlockedCSC container, which the port "
            "does not have yet (ROADMAP Queue 1 #5)")
    if layout != "dense":
        raise ValueError(f"unknown layout {layout!r}; choose 'dense' or 'bcsc'")
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, d)).astype(np.float32)
    if density < 1.0:
        A = A * (rng.random((n, d)) < density)
    x = _sparse_signal(rng, d, nnz_frac)
    p = 1.0 / (1.0 + np.exp(-(A @ x)))
    y = np.where(rng.random(n) < p, 1.0, -1.0).astype(np.float32)
    flips = rng.random(n) < flip
    y = np.where(flips, -y, y)
    return A, y, x


# ---------------------------------------------------------------------------
# On-device twins for paper-size instances
# ---------------------------------------------------------------------------

def _sparse_signal_on_device(g, d, nnz_frac, device):
    x = torch.zeros(d, dtype=torch.float32, device=device)
    k = max(1, int(d * nnz_frac))
    idx = torch.randperm(d, generator=g, device=device)[:k]
    x[idx] = torch.randn(k, generator=g, device=device) * 2.0
    return x


def sparco_on_device(seed=0, n=1024, d=2048, nnz_frac=0.05, noise=0.01,
                     device="cuda"):
    """``sparco`` (iid columns) drawn on ``device``: (A, y, x_true) tensors."""
    dev = resolve_device(device)
    exact_f32_matmul()
    g = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn(n, d, generator=g, device=dev)
    x = _sparse_signal_on_device(g, d, nnz_frac, dev)
    y = A @ x + noise * torch.randn(n, generator=g, device=dev)
    return A, y, x


def logistic_data_on_device(seed=0, n=4096, d=512, nnz_frac=0.05, flip=0.02,
                            device="cuda"):
    """Dense ``logistic_data`` drawn on ``device``: (A, y, x_true) tensors."""
    dev = resolve_device(device)
    exact_f32_matmul()
    g = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn(n, d, generator=g, device=dev)
    x = _sparse_signal_on_device(g, d, nnz_frac, dev)
    p = torch.sigmoid(A @ x)
    y = torch.where(torch.rand(n, generator=g, device=dev) < p, 1.0, -1.0)
    flips = torch.rand(n, generator=g, device=dev) < flip
    return A, torch.where(flips, -y, y), x
