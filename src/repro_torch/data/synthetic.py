"""Synthetic dataset generators: the paper's Lasso categories
(Sec. 4.1.3) and its logistic-regression regimes (Sec. 4.2.3).

``sparco``, ``singlepixcam``, ``sparse_imaging``, ``large_sparse``,
``logistic_data`` and the LM token stream ``lm_token_batches`` are numpy
copies of ``repro.data.synthetic``: the same
seed gives bit-identical arrays, so the two packages can be fed the same
problem.  Each but the token stream returns (A, y, x_true) with columns
NOT pre-normalized; use
``objectives.make_problem``.  The sparse categories and ``logistic_data``
take ``layout="bcsc"`` and then pack the same matrix as a host (CPU)
``BlockedCSC`` — host data like the dense layout's numpy arrays;
``make_problem`` moves it to its device.

``sparco_on_device`` / ``logistic_data_on_device`` draw from the same
distributions with a ``torch.Generator`` on the target device, for sizes
where drawing 10⁹ normals in numpy on the host would dominate the run.
``large_sparse_bcsc_on_device`` / ``logistic_bcsc_on_device`` emit a
``BlockedCSC`` directly on the device, never forming the dense matrix.
None of them reproduces numpy's stream.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.sparse import BLOCK, TILE_PAD, BlockedCSC
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


def _maybe_bcsc(A, layout: str):
    if layout == "dense":
        return A
    if layout == "bcsc":
        return BlockedCSC.from_dense(A, device="cpu")
    raise ValueError(f"unknown layout {layout!r}; choose 'dense' or 'bcsc'")


def sparse_imaging(seed=0, n=954, d=4096, density=0.01, nnz_frac=0.02,
                   noise=0.005, layout="dense"):
    """Very sparse random -1/+1 measurement matrix."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n, d)) < density
    signs = rng.choice([-1.0, 1.0], size=(n, d))
    A = (mask * signs).astype(np.float32)
    x = _sparse_signal(rng, d, nnz_frac)
    y = A @ x + noise * rng.standard_normal(n).astype(np.float32)
    return _maybe_bcsc(A, layout), y, x


def large_sparse(seed=0, n=2048, d=16384, density=0.002, nnz_frac=0.005,
                 noise=0.01, layout="dense"):
    """Bag-of-bigrams flavor: sparse nonnegative counts, heavy-tailed."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n, d)) < density
    vals = rng.exponential(1.0, size=(n, d))
    A = (mask * vals).astype(np.float32)
    x = _sparse_signal(rng, d, nnz_frac)
    y = A @ x + noise * rng.standard_normal(n).astype(np.float32)
    return _maybe_bcsc(A, layout), y, x


def logistic_data(seed=0, n=4096, d=512, nnz_frac=0.05, flip=0.02,
                  density=1.0, layout="dense"):
    """Labels in {-1,+1} from a sparse linear teacher (zeta/rcv1 regimes).

    ``density < 1`` sparsifies the design (rcv1-like bag-of-words rows);
    ``layout='bcsc'`` packs it as a BlockedCSC, same draws as the dense
    layout for the same seed.
    """
    if layout not in ("dense", "bcsc"):
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
    return _maybe_bcsc(A, layout), y, x


def lm_token_batches(seed, vocab_size, batch, seq_len, num_batches):
    """Deterministic synthetic token stream (numpy (inputs, targets)
    int32 pairs, bit-identical to the reference's for the same seed): a
    Zipfian unigram model with a short induction pattern, so a small LM
    measurably learns something."""
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, vocab_size + 1)
    probs /= probs.sum()
    for _ in range(num_batches):
        toks = rng.choice(vocab_size, size=(batch, seq_len + 1), p=probs)
        # induction: token t repeats 8 steps later with probability 1/2
        rep = rng.random((batch, seq_len + 1)) < 0.5
        toks[:, 8:] = np.where(rep[:, 8:], toks[:, :-8], toks[:, 8:])
        yield toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


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


def _bcsc_on_device(g, n, d, density, draw_vals, dev) -> BlockedCSC:
    """A random BlockedCSC drawn on ``dev``: column j keeps c_j ~
    Binomial(n, density) draws of a row, uniform over [0, n) and drawn with
    replacement; a row drawn twice in one column is kept once (the first
    draw's value), so a column's nnz is c_j minus its rare repeats
    (c_j²/2n expected).  Rows ascend within a column, as ``from_dense``
    stores them.  Values come from ``draw_vals(shape)``."""
    block = BLOCK
    nblk = -(-d // block)
    shape = (nblk, 1, block)
    counts = torch.binomial(
        torch.full(shape, float(n), device=dev),
        torch.full(shape, float(density), device=dev), generator=g)
    counts = counts * (torch.arange(nblk * block, device=dev)
                       < d).reshape(shape)          # padded tail columns
    tile = max(TILE_PAD, -(-int(counts.max()) // TILE_PAD) * TILE_PAD)
    rows = torch.randint(0, n, (nblk, tile, block), generator=g, device=dev,
                         dtype=torch.int32)
    vals = draw_vals((nblk, tile, block))
    live = torch.arange(tile, device=dev).reshape(1, tile, 1) < counts
    sentinel = torch.iinfo(torch.int32).max
    key, perm = torch.sort(torch.where(live, rows, sentinel), dim=1,
                           stable=True)
    vals = torch.gather(vals, 1, perm)
    repeat = torch.zeros_like(live)
    repeat[:, 1:] = key[:, 1:] == key[:, :-1]
    key = torch.where(repeat, sentinel, key)
    key, perm = torch.sort(key, dim=1, stable=True)
    vals = torch.gather(vals, 1, perm)
    live = key != sentinel
    tile = max(TILE_PAD, -(-int(live.sum(dim=1).max()) // TILE_PAD)
               * TILE_PAD)
    live = live[:, :tile]
    return BlockedCSC(rows=torch.where(live, key[:, :tile], 0).contiguous(),
                      vals=torch.where(live, vals[:, :tile], 0.0).contiguous(),
                      n=n, d=d, block=block)


def large_sparse_bcsc_on_device(seed=0, n=2048, d=16384, density=0.002,
                                nnz_frac=0.005, noise=0.01, device="cuda"):
    """``large_sparse`` drawn on ``device`` as a BlockedCSC (values
    Exponential(1), nonnegative): (A, y, x_true).  The dense matrix is
    never formed; see ``_bcsc_on_device`` for how rows are drawn."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    S = _bcsc_on_device(
        g, n, d, density,
        lambda shape: torch.empty(shape, device=dev).exponential_(
            1.0, generator=g), dev)
    x = _sparse_signal_on_device(g, d, nnz_frac, dev)
    y = S.matvec(x) + noise * torch.randn(n, generator=g, device=dev)
    return S, y, x


def logistic_bcsc_on_device(seed=0, n=4096, d=512, nnz_frac=0.05, flip=0.02,
                            density=0.01, device="cuda"):
    """Sparse ``logistic_data`` (standard-normal values at ``density``)
    drawn on ``device`` as a BlockedCSC: (A, y, x_true).  The dense matrix
    is never formed; see ``_bcsc_on_device`` for how rows are drawn."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    S = _bcsc_on_device(
        g, n, d, density,
        lambda shape: torch.randn(shape, generator=g, device=dev), dev)
    x = _sparse_signal_on_device(g, d, nnz_frac, dev)
    p = torch.sigmoid(S.matvec(x))
    y = torch.where(torch.rand(n, generator=g, device=dev) < p, 1.0, -1.0)
    flips = torch.rand(n, generator=g, device=dev) < flip
    return S, torch.where(flips, -y, y), x
