"""The model over a ``ModelConfig`` (port of ``repro.models.model``): every
layer kind of the ten configurations — GQA or MLA attention, the Mamba-2
mixer, the MLP or MoE FFN, and the encoder with cross attention (Whisper).

    init(cfg, generator)                          -> params
    forward(cfg, params, batch)                   -> logits   (train/prefill)
    decode_step(cfg, params, tok, cache, pos)     -> logits, cache (serving)
    ref_layout(cfg)                               -> reference path -> leaves

Parameters are a dict like the reference's tree, with the decoder blocks as
a list of per-layer dicts (layer ``g·len(pattern) + i`` is the reference's
``blocks/l{i}`` at group g; ``convert.lm_params_from_numpy`` maps one to
the other), the encoder's likewise (``encoder/blocks``), and the layers run
one after another in Python.  The cache is ``{"blocks": [per layer
{"kv": {...}} (attention) or {"ssm": {"ssm", "conv_x", "conv_bc"}}
(mamba)], "enc_out": encoder output or None}``, updated in place.
On DTensor parameters and inputs (``models.sharding``) the same code runs
sharded: ``sharding``'s ``shard_btd``/``shard_btv`` constraints pin the
residual stream and the logits where the reference pins them, the
prefill's cache is placed by ``sharding.cache_specs``, and each
constraint is a no-op on plain tensors or outside
``sharding.activation_axes``.

Remat: with ``cfg.remat`` and autograd recording, ``forward`` runs each
group of ``len(cfg.pattern)`` decoder layers (and each encoder layer)
under ``torch.utils.checkpoint`` — the reference's ``jax.checkpoint`` of
its scanned group body — so a backward keeps only each group's input and
recomputes the rest; the values are the same bits either way.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.device import exact_lm_matmul
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_lib
from repro_torch.models import sharding as SH


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"        # attn | mamba
    ffn: str = "mlp"           # mlp | moe | none


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # block flavor
    pattern: tuple = (LayerSpec(),)
    activation: str = "silu"
    gated: bool = True
    qkv_bias: bool = False
    qk_norm: bool = False
    norm: str = "rmsnorm"
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # attention kind
    attn_kind: str = "gqa"     # gqa | mla
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # MoE
    num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    # Mamba
    mamba_expand: int = 2
    mamba_head_dim: int = 64
    ssm_state: int = 128
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500
    frontend: str = "none"     # none | audio_stub | vision_stub
    # multimodal rope (qwen2-vl)
    mrope: bool = False
    mrope_sections: tuple = (16, 24, 24)
    # numerics / training
    compute_dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    optimizer: str = "adamw"   # adamw | adafactor
    remat: bool = True
    unroll_scan: bool = False  # measurement mode of the reference's scans
    # serving
    cache_dtype: Any = torch.bfloat16

    @property
    def num_groups(self) -> int:
        if self.num_layers % len(self.pattern):
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} is not a "
                f"multiple of the layer pattern length {len(self.pattern)}")
        return self.num_layers // len(self.pattern)

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab_size + 127) // 128) * 128

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def param_count(self) -> int:
        """Exact parameter count from shapes: ``init`` on the meta device,
        which allocates nothing."""
        return sum(t.numel() for t in leaves(init(self, device="meta")))


def uniform_pattern(mixer="attn", ffn="mlp"):
    return (LayerSpec(mixer=mixer, ffn=ffn),)


def jamba_pattern():
    """Jamba: attention at layer i%8==4 (1:7), MoE every 2nd layer."""
    return tuple(
        LayerSpec(mixer="attn" if i % 8 == 4 else "mamba",
                  ffn="moe" if i % 2 == 1 else "mlp")
        for i in range(8))


leaves = T.leaves     # the tensors of a parameter or cache tree, in order


def ref_layout(cfg: ModelConfig) -> dict:
    """{reference path: (stacked, port paths)} of every parameter of
    ``cfg``: the reference's ``/``-joined leaf path (``embed``,
    ``blocks/l0/attn/wq``, ``encoder/blocks/mlp/wi``, …), whether the
    reference stacks it over a leading axis, and the paths (``tree``
    paths) of the port leaves it holds, in the order of that axis.  A
    ``blocks/l{i}/…`` leaf stacks layers i, i + P, i + 2P, … of the port's
    ``blocks`` list (P = pattern length) over the reference's group axis;
    an ``encoder/blocks/…`` leaf stacks the encoder's layers."""
    meta = init(cfg, device="meta")
    out = {"/".join(path): (False, [path]) for path, _ in T.items(meta)
           if not any(isinstance(k, int) for k in path)}
    P = len(cfg.pattern)
    stacks = [(f"blocks/l{i}/", ("blocks",), range(i, cfg.num_layers, P))
              for i in range(P)]
    if cfg.is_encdec:
        stacks.append(("encoder/blocks/", ("encoder", "blocks"),
                       range(cfg.encoder_layers)))
    for prefix, seq, layers in stacks:
        for sub, _ in T.items(T.get(meta, seq)[layers[0]]):
            out[prefix + "/".join(sub)] = (
                True, [seq + (layer,) + sub for layer in layers])
    return out


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _layer_init(cfg, spec, kw, device):
    d = cfg.d_model
    p = {"pre_norm": L.norm_init(cfg.norm, d, device=device)}
    if spec.mixer == "attn":
        p["attn"] = (attn.mla_init(cfg, **kw) if cfg.attn_kind == "mla"
                     else attn.gqa_init(cfg, **kw))
    else:
        p["mamba"] = m2.mamba_init(cfg, **kw)
    if spec.ffn != "none":
        p["post_norm"] = L.norm_init(cfg.norm, d, device=device)
        if spec.ffn == "moe":
            p["moe"] = moe_lib.moe_init(cfg, **kw)
        else:
            p["mlp"] = L.mlp_init(d, cfg.d_ff, cfg.gated, **kw)
    if cfg.is_encdec and spec.mixer == "attn":
        p["cross_norm"] = L.norm_init(cfg.norm, d, device=device)
        p["cross"] = attn.gqa_init(cfg, **kw)
    return p


def _enc_layer_init(cfg, kw, device):
    d = cfg.d_model
    return {"pre_norm": L.norm_init(cfg.norm, d, device=device),
            "attn": attn.gqa_init(cfg, **kw),
            "post_norm": L.norm_init(cfg.norm, d, device=device),
            "mlp": L.mlp_init(d, cfg.d_ff, cfg.gated, **kw)}


def init(cfg: ModelConfig, generator=None, *, device=None,
         weight_dtype=torch.float32):
    """Parameters drawn from ``generator`` (on ``device``, by default the
    generator's).  Every matmul weight (and the embedding) is drawn in
    float32 and cast to ``weight_dtype`` at once, leaf by leaf, so a bf16
    model never holds more than one float32 leaf; the ``F32_LEAVES`` stay
    float32.  ``device="meta"`` gives the shapes only."""
    if device is None:
        device = generator.device if generator is not None else "cpu"
    kw = dict(generator=generator, device=device, dtype=weight_dtype)
    V, d = cfg.padded_vocab, cfg.d_model
    params: dict = {
        "embed": L.dense_init((V, d), scale=0.02, **kw),
        "final_norm": L.norm_init(cfg.norm, d, device=device),
    }
    if not cfg.tie_embeddings:
        params["head"] = L.dense_init((d, V), **kw)
    params["blocks"] = [_layer_init(cfg, _spec(cfg, layer), kw, device)
                        for layer in range(cfg.num_layers)]
    if cfg.is_encdec:
        params["encoder"] = {
            "blocks": [_enc_layer_init(cfg, kw, device)
                       for _ in range(cfg.encoder_layers)],
            "norm": L.norm_init(cfg.norm, d, device=device)}
    return params


# Leaves that stay float32 in a model held in the compute dtype: norm
# scales and biases, the QKV biases (added in the compute dtype), and the
# leaves the reference reads in float32 — the MoE router and Mamba-2's
# A_log, D and dt_bias.
F32_LEAVES = ("scale", "bias", "bq", "bk", "bv", "router", "A_log", "D",
              "dt_bias")


def _map(tree, fn, name=""):
    if isinstance(tree, dict):
        return {k: _map(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn, name) for v in tree]
    return fn(name, tree)


def cast_weights(params, dtype):
    """The same tree with every matmul weight and the embedding as its
    ``dtype`` copy (the ``F32_LEAVES`` unchanged): the copy the reference
    casts to at every use."""
    return _map(params, lambda name, t: t if name in F32_LEAVES
                else t.to(dtype))


def to_device(tree, device):
    """The parameter tree with every tensor on ``device``."""
    return _map(tree, lambda _, t: t.to(device))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _apply_layer(cfg, spec: LayerSpec, p, h, positions, dtype, *,
                 causal=True, cache=None, pos=None, enc_out=None,
                 positions3=None, decode=False, rope=None):
    """One decoder layer.  Returns (h, new_cache).  ``rope``: the (cos,
    sin) pair of the config's attention (``_rope``).  A mamba layer with
    ``decode`` steps the recurrent state in ``cache["ssm"]`` in place;
    without it, a ``cache`` asks for the prefill's final state."""
    new_cache = {}
    x = SH.shard_btd(L.norm_apply(cfg.norm, p["pre_norm"], h))
    if spec.mixer == "attn":
        kv = None if cache is None else cache.get("kv")
        if cfg.attn_kind == "mla":
            out, kv = attn.mla_apply(p["attn"], x, cfg, positions, dtype,
                                     causal=causal, cache=kv, pos=pos,
                                     rope=rope)
        else:
            out, kv = attn.gqa_apply(p["attn"], x, cfg, positions, dtype,
                                     causal=causal, cache=kv, pos=pos,
                                     positions3=positions3, rope=rope)
        if kv is not None:
            new_cache["kv"] = kv
        h = h + out
        if cfg.is_encdec:
            xc = L.norm_apply(cfg.norm, p["cross_norm"], h)
            out, _ = attn.gqa_apply(p["cross"], xc, cfg, positions, dtype,
                                    causal=False, xc=enc_out, use_rope=False)
            h = h + out
    elif decode:
        out, st = m2.mamba_decode_step(p["mamba"], x, cache["ssm"], cfg,
                                       dtype)
        for name, buf in cache["ssm"].items():
            buf.copy_(st[name])
        new_cache["ssm"] = cache["ssm"]
        h = h + out
    else:
        out, (final_state, (conv_x, conv_bc)) = m2.mamba_apply(
            p["mamba"], x, cfg, dtype)
        if cache is not None:        # prefill: capture the recurrent state
            new_cache["ssm"] = {"ssm": final_state.float(),
                                "conv_x": conv_x.float(),
                                "conv_bc": conv_bc.float()}
        h = h + out
    if spec.ffn != "none":
        x = SH.shard_btd(L.norm_apply(cfg.norm, p["post_norm"], h))
        if spec.ffn == "moe":
            h = h + moe_lib.moe_apply(p["moe"], x, cfg, dtype)
        else:
            h = h + L.mlp_apply(p["mlp"], x, cfg.activation, dtype)
    return h, new_cache


def _encode(cfg, params, enc_frames):
    """Whisper-style encoder over precomputed (stub) frame embeddings
    (B, S_enc, D): sinusoidal positions, non-causal self attention without
    RoPE, the MLP, then the encoder's final norm."""
    dtype = cfg.compute_dtype
    h = enc_frames.to(dtype)
    b, s = h.shape[:2]
    h = h + L.sinusoidal_positions(s, cfg.d_model,
                                   device=h.device).to(dtype)[None]
    positions = torch.arange(s, device=h.device).expand(b, s)

    def body(h, p):
        x = L.norm_apply(cfg.norm, p["pre_norm"], h)
        out, _ = attn.gqa_apply(p["attn"], x, cfg, positions, dtype,
                                causal=False, use_rope=False)
        h = h + out
        x = L.norm_apply(cfg.norm, p["post_norm"], h)
        return h + L.mlp_apply(p["mlp"], x, cfg.activation, dtype)

    for p in params["encoder"]["blocks"]:
        h = _remat(cfg, body, h, p)
    return L.norm_apply(cfg.norm, params["encoder"]["norm"], h)


def _remat(cfg, fn, h, *args):
    """``fn(h, *args)``, under ``torch.utils.checkpoint`` when ``cfg.remat``
    and autograd is recording (a backward then recomputes ``fn`` from
    ``h``), as the reference's ``jax.checkpoint``."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, h, *args, use_reentrant=False)
    return fn(h, *args)


def _head(cfg, params, h, dtype):
    h = L.norm_apply(cfg.norm, params["final_norm"], h)
    head = params.get("head")
    if head is None:
        head = params["embed"].T
    return SH.shard_btv(L.matmul(h, head, dtype)), h


def _spec(cfg, layer):
    return cfg.pattern[layer % len(cfg.pattern)]


def _rope(cfg, positions, positions3=None):
    """The (cos, sin) pair every attention layer of ``cfg`` rotates by,
    computed once per call."""
    if cfg.attn_kind == "mla":
        return attn.mla_rope(cfg, positions)
    return attn.gqa_rope(cfg, positions, positions3)


def _kv_cache_init(cfg, batch, s_max, device):
    fn = attn.mla_cache_init if cfg.attn_kind == "mla" else \
        attn.gqa_cache_init
    return fn(cfg, batch, s_max, cfg.cache_dtype, device=device)


def forward(cfg: ModelConfig, params, batch, *, make_cache_len: int = 0,
            return_hidden: bool = False):
    """Full-sequence forward.  batch keys: tokens (B,S) [, enc_frames
    (B, S_enc, D) for an encoder-decoder config, positions3 (B,3,S)].  If
    make_cache_len > 0, also build and return the KV/SSM cache sized to
    that length (prefill), with the encoder output.  Returns (logits,
    cache|None); with return_hidden=True returns (logits, hidden) where
    hidden is the final-norm output (B, S, D)."""
    dtype = cfg.compute_dtype
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    if dev.type == "cuda":
        exact_lm_matmul()
    h = SH.shard_btd(SH.take_rows(params["embed"], tokens).to(dtype))
    positions = torch.arange(s, device=dev).expand(b, s)
    positions3 = batch.get("positions3")
    rope = _rope(cfg, positions, positions3)
    enc_out = (_encode(cfg, params, batch["enc_frames"]) if cfg.is_encdec
               else None)
    prefill = make_cache_len > 0
    caches = []
    if prefill:
        for layer, p in enumerate(params["blocks"]):
            spec = _spec(cfg, layer)
            cache_in = ({"kv": SH.place_cache(
                _kv_cache_init(cfg, b, make_cache_len, dev),
                ("blocks", layer, "kv"), h)}
                if spec.mixer == "attn" else {"ssm": None})
            h, c = _apply_layer(cfg, spec, p, h, positions, dtype,
                                cache=cache_in, pos=0, enc_out=enc_out,
                                positions3=positions3, rope=rope)
            h = SH.shard_btd(h)
            caches.append(c)
    else:
        P = len(cfg.pattern)

        def group(h, first):
            for layer in range(first, first + P):
                h, _ = _apply_layer(cfg, _spec(cfg, layer),
                                    params["blocks"][layer], h, positions,
                                    dtype, enc_out=enc_out,
                                    positions3=positions3, rope=rope)
                h = SH.shard_btd(h)
            return h

        for first in range(0, cfg.num_layers, P):
            h = _remat(cfg, group, h, first)
    logits, h = _head(cfg, params, h, dtype)
    if return_hidden:
        return logits, h
    if prefill:
        return logits, {"blocks": caches, "enc_out": enc_out}
    return logits, None


def init_cache(cfg: ModelConfig, batch: int, s_max: int, *, device=None):
    """Zero cache for ``batch`` slots: KV of ``s_max`` positions for an
    attention layer, the float32 SSM state and conv windows for a mamba
    layer."""
    return {"blocks": [
        {"kv": _kv_cache_init(cfg, batch, s_max, device)}
        if _spec(cfg, layer).mixer == "attn"
        else {"ssm": m2.mamba_state_init(cfg, batch, device=device)}
        for layer in range(cfg.num_layers)], "enc_out": None}


def splice(cache, fresh, slot: int) -> None:
    """Copy a one-row cache ``fresh`` (a prefill's) into row ``slot`` of
    every leaf of ``cache`` (KV, latent, SSM state and conv windows);
    raises ``ValueError`` on leaves of other shapes."""
    for full, one in zip(leaves(cache["blocks"]), leaves(fresh["blocks"])):
        if full.shape[1:] != one.shape[1:]:
            raise ValueError(f"cache leaf {tuple(one.shape[1:])} does not "
                             f"fit a slot of {tuple(full.shape[1:])}")
        full[slot].copy_(one[0])


def decode_step(cfg: ModelConfig, params, tokens, cache, pos, *,
                enc_out=None, positions3=None):
    """One decode step.  tokens: (B, 1) integer; pos: an int (or 0-d
    tensor) for every row, or a (B,) / (B, 1) tensor of per-slot
    positions.  The cache is updated in place; ``enc_out`` defaults to the
    cache's.

    Returns (logits (B, 1, V), cache).
    """
    dtype = cfg.compute_dtype
    b = tokens.shape[0]
    dev = tokens.device
    if dev.type == "cuda":
        exact_lm_matmul()
    h = SH.shard_btd(SH.take_rows(params["embed"], tokens).to(dtype))
    if torch.is_tensor(pos) and pos.dim() > 0:
        positions = pos.reshape(b, 1)
    else:
        pos = int(pos)
        positions = torch.full((b, 1), pos, device=dev)
    if enc_out is None:
        enc_out = cache.get("enc_out")
    rope = _rope(cfg, positions, positions3)
    for layer, p in enumerate(params["blocks"]):
        spec = _spec(cfg, layer)
        h, _ = _apply_layer(cfg, spec, p, h, positions, dtype,
                            cache=cache["blocks"][layer], pos=pos,
                            enc_out=enc_out, positions3=positions3,
                            decode=spec.mixer == "mamba", rope=rope)
        if (layer + 1) % len(cfg.pattern) == 0:
            # the residual's layout pinned at each group boundary, as the
            # reference's scan carry is: every group then costs the same
            h = SH.shard_btd(h)
    logits, _ = _head(cfg, params, h, dtype)
    return logits, {"blocks": cache["blocks"], "enc_out": enc_out}
