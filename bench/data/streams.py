"""The block draws and the request stream, all from ``--seed``.

``draws`` is the rule of ``draw_blocks`` in ``src/repro_torch/kernels/
ops.py`` at commit 58376ee (K distinct blocks a round, the K smallest of
one uniform key per block), taken as ``topk`` rather than a full sort.
``job`` is the request-stream rule of a λ-grid job: ``stream_over`` in
``src/repro_torch/launch/solver_serve.py`` at the same commit fixes the
problem-id / λ / repeat / per-request-draws shape of a stream; this rule
asks for every (design, λ) pair a fixed number of times and lets the seed
pick the order instead of walking the pairs in order.  Every seed asks for
the same work; only the order and the blocks each request draws move with
the seed.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Namespaces of the sub-seeds, so no two uses of one seed share a stream.
WINDOW, WARMUP, SAMPLE, DESIGN, JOB = range(5)


def subseed(seed: int, *parts: int) -> int:
    """A 63-bit seed for the stream named by ``parts`` under ``seed``
    (any whole number, negative too)."""
    entropy = [seed % (1 << 64), *(p % (1 << 64) for p in parts)]
    return int(np.random.SeedSequence(entropy).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def draws(seed: int, rounds: int, K: int, nblk: int, device) -> torch.Tensor:
    """(rounds, K) int32: K distinct blocks of ``nblk`` a round, drawn on
    ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(rounds, nblk, generator=g, device=device)
    return torch.topk(u, K, dim=1, largest=False).indices.to(torch.int32)


def lam_grid(hi: float, lo: float, count: int) -> list[float]:
    """``count`` λ/λ_max ratios from ``hi`` down to ``lo``, geometric."""
    return [hi * (lo / hi) ** (j / (count - 1)) for j in range(count)]


class Request(NamedTuple):
    """One request of a job: its design and its λ's index in the grid."""
    pid: int
    lam_idx: int


def job(seed: int, index: int, *, designs: int, grid: int,
        copies: int) -> list[Request]:
    """Job ``index``: every (design, λ) pair of the grid ``copies`` times,
    in an order drawn from the seed, so every job of every seed asks for
    the same work and only its order (and with it the cache's verdicts)
    moves."""
    rng = np.random.default_rng(subseed(seed, JOB, index))
    pairs = [Request(p, j) for p in range(designs) for j in range(grid)]
    return [pairs[k % len(pairs)]
            for k in rng.permutation(len(pairs) * copies)]


def job_draws(seed: int, index: int, *, requests: int, rounds: int, K: int,
              nblk: int, device) -> torch.Tensor:
    """(requests, rounds, K) int32: each request's own block schedule."""
    return draws(subseed(seed, JOB, index, 1), requests * rounds, K, nblk,
                 device).reshape(requests, rounds, K)
