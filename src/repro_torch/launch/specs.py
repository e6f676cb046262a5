"""Input stand-ins for every (arch x shape) cell (port of
``repro.launch.specs``): tensors with the reference's shapes and dtypes
on the meta device (nothing allocated), or on ``device`` — under the
dry-run's ``FakeTensorMode``, fake tensors there.

Modality frontends are stubs, as in the reference: Whisper gets
precomputed (B, 1500, d_model) bf16 frame embeddings; Qwen2-VL gets 3-D
M-RoPE position ids (B, 3, S).
"""
from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.models import steps as S


def _empty(shape, dtype, device):
    return torch.empty(shape, dtype=dtype, device=device)


def _frontends(cfg, seq, batch, device, specs):
    if cfg.is_encdec:
        specs["enc_frames"] = _empty((batch, cfg.encoder_seq, cfg.d_model),
                                     torch.bfloat16, device)
    if cfg.mrope:
        specs["positions3"] = _empty((batch, 3, seq), torch.int32, device)
    return specs


def train_batch_specs(cfg, seq, batch, *, device="meta"):
    return _frontends(cfg, seq, batch, device, {
        "tokens": _empty((batch, seq), torch.int32, device),
        "labels": _empty((batch, seq), torch.int32, device)})


def prefill_batch_specs(cfg, seq, batch, *, device="meta"):
    return _frontends(cfg, seq, batch, device, {
        "tokens": _empty((batch, seq), torch.int32, device)})


def decode_arg_specs(cfg, seq, batch, *, device="meta"):
    """(tokens, cache, pos [, enc_out, positions3]) for ``decode_step``;
    the cache is ``init_cache`` on ``device`` (its KV leaves the
    head-major buffers' views)."""
    args = {
        "tokens": _empty((batch, 1), torch.int32, device),
        "cache": M.init_cache(cfg, batch, seq, device=device),
        "pos": _empty((), torch.int32, device),
    }
    if cfg.is_encdec:
        args["enc_out"] = _empty((batch, cfg.encoder_seq, cfg.d_model),
                                 torch.bfloat16, device)
    if cfg.mrope:
        args["positions3"] = _empty((batch, 3, 1), torch.int32, device)
    return args


def state_specs(cfg, *, device="meta"):
    """The full TrainState (params + optimizer), on ``device``."""
    return S.init_train_state(cfg, device=device)


def param_specs_shapes(cfg, *, device="meta"):
    return M.init(cfg, device=device)
