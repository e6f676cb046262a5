"""Sharded, deterministic, resumable batch loader (port of
``repro.data.loader``; DESIGN §7).  The port keeps its own copy of the
numpy stream, bit-identical to the reference's for the same (seed, step,
host).

Stateless by construction: ``batch_at(step)`` derives the batch purely from
(seed, step, host), so

  * a restart at step k reproduces batch k bitwise (auto-resume),
  * every host computes only its slice — no coordinator, no queues,
  * every host's work is equal-sized, which keeps bulk-synchronous steps
    straggler-free by design.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LoaderConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    induction_period: int = 8     # synthetic learnable structure
    induction_prob: float = 0.5


class TokenLoader:
    """Deterministic synthetic LM token stream, shardable by (host, step):
    Zipf-distributed tokens where, with probability ``induction_prob``, a
    token repeats the one ``induction_period`` places before it.  Batches
    land on ``device`` (the card unless the caller asks for the CPU) as
    int64 tensors."""

    def __init__(self, cfg: LoaderConfig, *, host_id: int = 0,
                 num_hosts: int = 1, device="cuda"):
        if cfg.global_batch % num_hosts:
            raise ValueError(
                f"global_batch={cfg.global_batch} not divisible by "
                f"num_hosts={num_hosts}")
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = cfg.global_batch // num_hosts
        self.device = resolve_device(device)
        ranks = np.arange(1, cfg.vocab_size + 1)
        p = 1.0 / ranks
        self._probs = p / p.sum()

    def batch_at(self, step: int) -> dict:
        """{"tokens", "labels"}, each (local_batch, seq_len), the labels the
        tokens shifted by one — the reference's draws, pure in (seed, step,
        host_id).  On the card the copy goes from pinned memory without a
        host wait."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.host_id]))
        toks = rng.choice(cfg.vocab_size,
                          size=(self.local_batch, cfg.seq_len + 1),
                          p=self._probs)
        rep = rng.random((self.local_batch, cfg.seq_len + 1)) < \
            cfg.induction_prob
        k = cfg.induction_period
        toks[:, k:] = np.where(rep[:, k:], toks[:, :-k], toks[:, k:])
        toks = torch.from_numpy(toks.astype(np.int64))
        if self.device.type == "cuda":
            toks = toks.pin_memory()
        toks = toks.to(self.device, non_blocking=True)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
