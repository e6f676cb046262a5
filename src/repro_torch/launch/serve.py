"""Batched LM serving driver: prefill + decode with continuous batching
(port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --requests 12 --batch 4 --max-new 24

(``--device cpu`` runs on the host; without it the model runs on the card.)

Design (vLLM-style):
  * fixed decode batch of B slots over a shared fixed-length KV cache,
  * each slot holds one request; when a request finishes (EOS / max-new),
    the slot is immediately refilled from the queue by prefilling the new
    prompt *into that slot only* — one slow request never blocks the batch,
  * prefill runs the (1, L) context with a fresh cache of ``max_len`` rows
    and replaces the slot's row of every leaf of every layer's cache with
    it — KV (zeros beyond L), MLA latent, SSM state and conv windows;
    decode steps all slots in lock-step with per-slot positions, free and
    finished slots riding along (token 0, position held).

The engine holds every matmul weight as its compute-dtype copy (the bits
the reference casts to at each use), so a decode step reads the weights
once.  A step's tokens and positions go to the card in one non-blocking
copy from pinned memory, and its next tokens come back with one
``.tolist()``: the one host sync of a step.  Inside ``DECODE_RANGE`` (the
model's decode and the argmax) nothing waits on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.device import resolve_device
from repro_torch.launch.slots import SlotBoard
from repro_torch.models import model as M

DECODE_RANGE = "repro_torch.lm_decode"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (L,) int32
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    evictions: int = 0          # round-deadline evictions survived


class Engine:
    """``params``: the port's parameters (``models.model.init`` or
    ``convert.lm_params_from_numpy``); without them they are drawn from
    ``torch.Generator(device).manual_seed(seed)``, matmul weights cast to
    the compute dtype leaf by leaf."""

    def __init__(self, cfg, *, batch: int, max_len: int, eos_id: int = 0,
                 seed: int = 0, params=None, device="cuda"):
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.device = dev = resolve_device(device)
        t0 = time.perf_counter()
        if params is None:
            params = M.init(cfg, torch.Generator(dev).manual_seed(seed),
                            weight_dtype=cfg.compute_dtype)
        self.params = M.cast_weights(params, cfg.compute_dtype)
        self.cache = M.init_cache(cfg, batch, max_len, device=dev)
        self.pos = np.zeros(batch, np.int64)        # next position per slot
        # the step's (tokens, positions), staged for one host-to-card copy
        self._stage = torch.zeros(2, batch, dtype=torch.int64,
                                  pin_memory=dev.type == "cuda")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.stats = dict(build_s=time.perf_counter() - t0, prefills=0,
                          prefill_s=0.0, prefill_tokens=0, steps=0,
                          step_s=0.0)
        # slot/queue bookkeeping lives on the shared state machine
        # (launch/slots.py) — the engine only does prefill/decode
        self.board = SlotBoard(batch)

    @property
    def slots(self):
        return self.board.slots

    @property
    def age(self):
        return self.board.age

    def admit(self, req: Request, slot: int):
        # context = prompt + everything generated so far: a fresh request
        # prefills its prompt, a deadline-evicted one re-prefills its whole
        # partial generation into the new slot and continues where it left
        # off (the KV it lost at eviction is rebuilt here)
        t0 = time.perf_counter()
        ctx = (np.concatenate([req.prompt, np.asarray(req.out, np.int32)])
               if req.out else req.prompt)
        toks = torch.as_tensor(ctx, dtype=torch.int64).to(self.device)[None]
        logits, fresh = M.forward(self.cfg, self.params, {"tokens": toks},
                                  make_cache_len=self.max_len)
        M.splice(self.cache, fresh, slot)
        nxt = int(torch.argmax(logits[0, -1]))
        req.out.append(nxt)
        self.board.place(req, slot)
        self.pos[slot] = len(ctx)
        if nxt == self.eos_id or len(req.out) >= req.max_new \
                or len(ctx) + 1 >= self.max_len:
            req.done = True
        self.stats["prefills"] += 1
        self.stats["prefill_tokens"] += len(ctx)
        self.stats["prefill_s"] += time.perf_counter() - t0

    def step(self):
        t0 = time.perf_counter()
        stage = self._stage.numpy()
        stage[0] = [r.out[-1] if r else 0 for r in self.slots]
        stage[1] = self.pos
        both = self._stage.to(self.device, non_blocking=True)
        with torch.profiler.record_function(DECODE_RANGE):
            logits, self.cache = M.decode_step(
                self.cfg, self.params, both[0][:, None], self.cache,
                both[1][:, None])
            nxt = torch.argmax(logits[:, -1], -1)
        self.pos += [1 if r and not r.done else 0 for r in self.slots]
        self.board.tick()
        toks = nxt.tolist()
        for i, r in enumerate(self.slots):
            if r is None or r.done:
                continue
            r.out.append(toks[i])
            if toks[i] == self.eos_id or len(r.out) >= r.max_new:
                r.done = True
        self.stats["steps"] += 1
        self.stats["step_s"] += time.perf_counter() - t0

    def free_slots(self):
        return self.board.free_slots()


def serve(arch: str, *, requests: int = 12, batch: int = 4, max_new: int = 24,
          prompt_len: int = 16, max_len: int = 128, seed: int = 0,
          smoke: bool = True, quiet: bool = False,
          max_rounds: int | None = None, max_evictions: int = 2,
          params=None, device="cuda", stats: dict | None = None):
    """Run the continuous-batching loop.

    ``max_rounds`` is the per-slot round deadline (decode steps since the
    slot was admitted): a slot that hasn't finished within the deadline is
    evicted and its request re-queued at the tail.  A request evicted more
    than ``max_evictions`` times is given up on (marked done with whatever
    it generated).  ``max_rounds=None`` disables the deadline.  Prompts are
    drawn from ``np.random.default_rng(seed)`` as in the reference; the
    weights are ``params`` or drawn from ``seed`` (``Engine``).  A
    ``stats`` dict, if given, gets the engine's counters and times plus
    ``wall_s``, ``tokens`` and ``decode_steps``.
    """
    mod = ARCHS[arch]
    cfg = mod.smoke_config() if smoke else mod.CONFIG
    if cfg.is_encdec:
        raise SystemExit("serve: use LM archs (whisper needs audio frontend)")
    eng = Engine(cfg, batch=batch, max_len=max_len, seed=seed, params=params,
                 device=device)
    board = eng.board
    board.max_rounds = max_rounds
    board.max_evictions = max_evictions
    rng = np.random.default_rng(seed)
    board.queue.extend(
        Request(i, rng.integers(1, cfg.vocab_size, prompt_len,
                                dtype=np.int32), max_new)
        for i in range(requests))
    t0 = time.perf_counter()
    steps = 0
    while board.pending():
        board.refill(eng.admit)              # continuous batching refill
        if board.live():
            eng.step()
            steps += 1
        board.evict_stale()
    finished = board.drain()
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in finished)
    if stats is not None:
        stats.update(eng.stats, wall_s=dt, tokens=toks, decode_steps=steps)
    if not quiet:
        for r in sorted(finished, key=lambda r: r.rid):
            print(f"[serve] req {r.rid}: {len(r.out)} tokens "
                  f"{'(eos)' if r.out and r.out[-1] == eng.eos_id else ''}")
        print(f"[serve] {len(finished)} requests, {toks} tokens, "
              f"{steps} decode steps, {dt:.2f}s ({toks/max(dt,1e-9):.1f} "
              f"tok/s) on {eng.device}")
    return finished


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=sorted(ARCHS))
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-rounds", type=int, default=None,
                    help="per-slot round deadline (decode steps) before "
                         "eviction + re-queue")
    ap.add_argument("--max-evictions", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    serve(a.arch, requests=a.requests, batch=a.batch, max_new=a.max_new,
          prompt_len=a.prompt_len, max_len=a.max_len,
          max_rounds=a.max_rounds, max_evictions=a.max_evictions,
          device=a.device)


if __name__ == "__main__":
    main()
