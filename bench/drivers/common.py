"""What the two drivers share: the device clock, the port's problem built
from the benchmark's raw inputs, and the seeded sample of a window."""
from __future__ import annotations

import time

import numpy as np
import torch

from bench.data import generators, streams


def sync(device) -> None:
    """Wait for the device (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


now = time.perf_counter


def port_problem(cfg: dict, data: generators.Data, device):
    """The port's ``Problem`` of ``data`` through its public constructors
    (``BlockedCSC``, ``make_problem``) at λ = lam_ratio·λ_max, where the
    port computes λ_max."""
    from repro_torch.core import objectives as obj
    from repro_torch.data.sparse import BlockedCSC
    A = data.A
    if isinstance(A, generators.SparseRaw):
        A = BlockedCSC(rows=A.rows, vals=A.vals, n=A.n, d=A.d,
                       block=generators.BLOCK)
    prob = obj.make_problem(A, data.y, 1.0, loss=cfg["loss"], device=device)
    lam_max = obj.lambda_max(prob.A, prob.y, cfg["loss"])
    return prob, lam_max


def to_bf16(prob):
    """The port's own lower-precision path: the design values in bfloat16
    (the kernels accumulate in float32)."""
    A = prob.A
    A = A.astype(torch.bfloat16) if hasattr(A, "astype") else A.to(
        torch.bfloat16)
    return prob._replace(A=A)


class Reservoir:
    """A uniform sample of ``k`` of a stream of unknown length, drawn from
    the seed (Vitter's algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng(streams.subseed(seed,
                                                         streams.SAMPLE))
        self.seen = 0
        self.items: list = []

    def offer(self, make):
        """Offer the next item; ``make()`` builds it only when it is kept."""
        m = self.seen
        self.seen += 1
        if m < self.k:
            self.items.append(make())
        else:
            j = int(self.rng.integers(m + 1))
            if j < self.k:
                self.items[j] = make()
