"""Step functions (port of ``repro.models.steps``): the train step with
microbatched gradient accumulation, and thin prefill and decode steps.

    state = init_train_state(cfg, generator)      # or on device="meta"
    step = make_train_step(cfg, lr=3e-4)
    state, metrics = step(state, batch)           # {"loss", "grad_norm"}

A train step runs autograd through ``models.model.forward`` (with the
config's per-group remat), then the config's optimizer.  It updates the
state's tensors in place — full-width parameters, grads and AdamW moments
fill most of a card — and returns the same state with its step advanced;
the metrics stay on the device, and nothing inside ``STEP_RANGE`` reads
the card.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree as T
from repro_torch.models import model as M
from repro_torch.models import sharding as SH
from repro_torch.optim import adafactor, adamw

STEP_RANGE = "repro_torch.lm_train_step"


def cross_entropy(logits, labels):
    """Mean cross entropy over the tokens whose label is not -1, from a
    float32 logsumexp (its max detached).  The gold logit is a gather:
    the value of the reference's one-hot contraction, without a (B, S, V)
    one-hot."""
    logits = logits.float()
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    labels = labels.long()
    gold = SH.vocab_gather(logits, labels.clamp(min=0))
    mask = (labels >= 0).float()
    nll = (lse - gold) * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)


def loss_fn(cfg, params, batch):
    logits, _ = M.forward(cfg, params, batch)
    return cross_entropy(logits, batch["labels"])


class TrainState(NamedTuple):
    params: Any
    opt: Any
    step: torch.Tensor


def init_train_state(cfg, generator=None, *, device=None) -> TrainState:
    """Parameters from ``models.model.init`` (float32) and the config's
    optimizer state (Adafactor in the reference's stacked layout).  With
    ``device="meta"`` it allocates nothing: the template a checkpoint is
    restored into."""
    params = M.init(cfg, generator, device=device)
    dev = T.leaves(params)[0].device
    opt = (adafactor.init(params, M.ref_layout(cfg))
           if cfg.optimizer == "adafactor" else adamw.init(params))
    return TrainState(params=params, opt=opt,
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def loss_and_grads(cfg, params, batch):
    """(loss, grads): the loss of ``batch`` and its float32 grads as a list
    in ``tree.leaves(params)`` order (a leaf the loss does not reach gets
    zeros, as ``jax.grad`` gives)."""
    leaves = T.leaves(params)
    ws = [p.detach().requires_grad_() for p in leaves]
    loss = loss_fn(cfg, T.unflatten(params, ws), batch)
    grads = torch.autograd.grad(loss, ws, allow_unused=True)
    return loss.detach(), [torch.zeros_like(w) if g is None else g.float()
                           for w, g in zip(ws, grads)]


def accumulated_grads(cfg, params, batch, grad_accum: int = 1):
    """``loss_and_grads`` over ``grad_accum`` microbatches (the batch's rows
    split in order), the float32 grads summed in place and divided by
    ``grad_accum``, the loss the mean of the microbatches' — the
    reference's ``scan``."""
    if grad_accum == 1:
        return loss_and_grads(cfg, params, batch)
    rows = next(iter(batch.values())).shape[0]
    if rows % grad_accum:
        raise ValueError(f"batch of {rows} rows does not split into "
                         f"grad_accum={grad_accum} microbatches")
    losses, acc = [], None
    for k in range(grad_accum):
        micro = {name: SH.microbatch(x, k, grad_accum)
                 for name, x in batch.items()}
        loss, grads = loss_and_grads(cfg, params, micro)
        losses.append(loss)
        if acc is None:
            acc = grads
        else:
            for a, g in zip(acc, grads):
                a.add_(g)
            del grads
    for a in acc:
        a.div_(grad_accum)
    return torch.stack(losses).mean(), acc


def make_train_step(cfg, lr=3e-4, grad_accum: int = 1):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``lr`` may be a float or a schedule ``step -> lr`` of the device step
    counter.  ``grad_accum > 1`` runs the batch's microbatches one after
    another, bounding activation memory to one microbatch (DESIGN §5)."""
    opt_mod = adafactor if cfg.optimizer == "adafactor" else adamw
    lr_fn = lr if callable(lr) else (lambda step: lr)
    stacks = M.ref_layout(cfg) if opt_mod is adafactor else None

    def train_step(state: TrainState, batch):
        with torch.profiler.record_function(STEP_RANGE):
            params = T.leaves(state.params)
            loss, grads = accumulated_grads(cfg, state.params, batch,
                                            grad_accum)
            kw = ({"groups": adafactor.layout(state.params, stacks)}
                  if stacks else {})
            opt, gnorm = opt_mod.apply(grads, state.opt, params,
                                       lr_fn(state.step), **kw)
            metrics = {"loss": loss, "grad_norm": gnorm}
            return TrainState(state.params, opt, state.step + 1), metrics

    return train_step


def make_prefill_step(cfg, cache_len: int):
    def prefill_step(params, batch):
        with torch.no_grad():
            logits, cache = M.forward(cfg, params, batch,
                                      make_cache_len=cache_len)
        # only the last position's logits (the serving API)
        return logits[:, -1:], cache
    return prefill_step


def make_decode_step(cfg):
    def decode_step(params, tokens, cache, pos, enc_out=None,
                    positions3=None):
        with torch.no_grad():
            logits, cache = M.decode_step(cfg, params, tokens, cache, pos,
                                          enc_out=enc_out,
                                          positions3=positions3)
        # the argmax takes the vocabulary whole
        last = SH.shard_as(logits[:, -1], "batch", None)
        next_tok = torch.argmax(last, dim=-1).to(torch.int32)
        return next_tok[:, None], logits, cache
    return decode_step
