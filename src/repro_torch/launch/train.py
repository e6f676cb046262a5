"""Fault-tolerant LM trainer (port of ``repro.launch.train``;
DESIGN §7).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --steps 60 --ckpt-dir /tmp/ckpt --save-every 20

(``--device cpu`` runs on the host; without it the model trains on the
card.  ``--full`` trains the published configuration instead of its smoke
config.)

Fault tolerance:
  * auto-resume — on start ``train`` scans ``--ckpt-dir`` and restores
    the newest complete checkpoint (atomic tmp + rename writes mean a
    crash never leaves a half-written "latest");
  * ``--simulate-failure-at N`` raises after step N; re-running the same
    command continues from the last checkpoint and gives the
    bitwise-identical trajectory: the loader is stateless in the step,
    and the step is deterministic — on the card ``train`` turns on
    ``torch.use_deterministic_algorithms`` (the embedding's and the MoE
    gather's backward otherwise accumulate with atomics) with cuBLAS's
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, which it sets unless the
    environment already does (it must hold before the process's first
    cuBLAS call; a caller that ran cuBLAS earlier sets it at start);
  * straggler mitigation is structural: equal-sized deterministic shards
    per host and bulk-synchronous steps (``data/loader.py``).

Whisper's stub encoder frames come from a ``torch.Generator`` seeded by
(seed, step) on the training device (the reference draws them with
``jax.random``, which torch cannot reproduce): ``enc_frames``.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import ARCHS
from repro_torch.data.loader import LoaderConfig, TokenLoader
from repro_torch.device import resolve_device
from repro_torch.models import steps as S
from repro_torch.optim import schedule as sched

CUBLAS_CONFIG = ":4096:8"


class SimulatedFailure(RuntimeError):
    pass


def enc_frames(cfg, batch: int, seed: int, step: int, device):
    """(batch, encoder_seq, d_model) stub frames of ``step``, standard
    normal in float32 from a generator seeded by (seed, step), in the
    compute dtype."""
    g = torch.Generator(device).manual_seed(int(
        np.random.SeedSequence([seed, step]).generate_state(1)[0]))
    return torch.randn(batch, cfg.encoder_seq, cfg.d_model, generator=g,
                       device=device).to(cfg.compute_dtype)


def train(arch: str, *, smoke: bool = True, steps: int = 50,
          batch: int = 8, seq: int = 128, lr: float = 3e-3,
          grad_accum: int = 1, ckpt_dir=None, save_every: int = 0,
          simulate_failure_at: int = -1, seed: int = 0,
          log_every: int = 10, keep: int = 3, device="cuda", stats=None):
    """Train ``arch`` for ``steps`` steps from the newest checkpoint under
    ``ckpt_dir`` (else from ``models.model.init`` drawn from
    ``torch.Generator(device).manual_seed(seed)``).  Returns (state, the
    losses of the steps run).  ``stats``, a dict, receives each step's
    wall seconds (``step_s``: the batch, the step and the loss read)."""
    dev = resolve_device(device)
    cfg = ARCHS[arch].smoke_config() if smoke else ARCHS[arch].CONFIG
    loader = TokenLoader(LoaderConfig(vocab_size=cfg.vocab_size,
                                      global_batch=batch, seq_len=seq,
                                      seed=seed), device=dev)
    lr_fn = sched.warmup_cosine(lr, warmup_steps=max(steps // 10, 1),
                                total_steps=steps)
    with deterministic(dev):
        return _run(arch, cfg, loader, lr_fn, dev, steps=steps, batch=batch,
                    grad_accum=grad_accum, ckpt_dir=ckpt_dir,
                    save_every=save_every,
                    simulate_failure_at=simulate_failure_at, seed=seed,
                    log_every=log_every, keep=keep, stats=stats)


@contextlib.contextmanager
def deterministic(device):
    """On the card: ``torch.use_deterministic_algorithms(True)`` with
    cuBLAS's ``CUBLAS_WORKSPACE_CONFIG`` (set unless the environment has
    it), restored on exit.  Deterministic mode also fills every new
    allocation with NaN, a guard against reads of uninitialized memory
    that costs a pass over each temporary; the port reads none (its
    resume is bit for bit), so that fill is off.  Nothing changes on the
    CPU."""
    if torch.device(device).type != "cuda":
        yield
        return
    determinism = torch.are_deterministic_algorithms_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_CONFIG)
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(determinism)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def _run(arch, cfg, loader, lr_fn, dev, *, steps, batch, grad_accum,
         ckpt_dir, save_every, simulate_failure_at, seed, log_every, keep,
         stats):
    state = None
    start_step = 0
    if ckpt_dir is not None:
        try:
            template = S.init_train_state(cfg, device="meta")
            start_step, state = ckpt.restore(ckpt_dir, template, device=dev)
            print(f"[train] resumed from step {start_step}", flush=True)
        except FileNotFoundError:
            pass
    if state is None:
        state = S.init_train_state(cfg,
                                   torch.Generator(dev).manual_seed(seed))
    train_step = S.make_train_step(cfg, lr=lr_fn, grad_accum=grad_accum)
    if stats is not None:
        stats.setdefault("step_s", [])

    losses = []
    for step in range(start_step, steps):
        t0 = time.perf_counter()
        b = loader.batch_at(step)
        if cfg.is_encdec:
            b["enc_frames"] = enc_frames(cfg, batch, seed, step, dev)
        state, metrics = train_step(state, b)
        loss = float(metrics["loss"])
        wall = time.perf_counter() - t0
        if stats is not None:
            stats["step_s"].append(wall)
        losses.append(loss)
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] {arch} step {step} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} ({wall:.2f}s)",
                  flush=True)
        done = step + 1
        if ckpt_dir is not None and save_every and (done % save_every == 0
                                                    or done == steps):
            ckpt.save(ckpt_dir, done, state, keep=keep)
        if simulate_failure_at >= 0 and done >= simulate_failure_at:
            raise SimulatedFailure(f"injected failure after step {done}")
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-4b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=0)
    ap.add_argument("--simulate-failure-at", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    train(a.arch, smoke=a.smoke, steps=a.steps, batch=a.batch, seq=a.seq,
          lr=a.lr, grad_accum=a.grad_accum, ckpt_dir=a.ckpt_dir,
          save_every=a.save_every, simulate_failure_at=a.simulate_failure_at,
          seed=a.seed, log_every=a.log_every, device=a.device)


if __name__ == "__main__":
    main()
