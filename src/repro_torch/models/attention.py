"""Attention blocks (port of ``repro.models.attention``): GQA (QKV bias,
qk-norm, M-RoPE, cross attention) and MLA (multi-head latent attention,
MiniCPM3 / DeepSeek-V2 style).

KV-cache layout: k/v of shape (B, S_max, Hkv, Dh), as in the reference, held
as views of head-major (B, Hkv, S_max, Dh) buffers so that attention reads
each (slot, kv head) as one contiguous (S_max, Dh) block.  MLA caches the
compressed latent ``ckv`` (B, S_max, kv_rank) and the shared rope key
``k_rope`` (B, S_max, 1, rope_dim), and expands the whole S_max latent
through ``wukv`` at every call, as the reference does.  Caches are
written in place: prefill (scalar ``pos``) writes rows ``pos : pos + S``,
per-slot decode (vector ``pos``) writes one row per slot, with the values
the reference's functional updates give.

``sdpa`` groups the query heads of each KV head instead of repeating k and
v (``repeat_kv`` stays for callers that want the repeated layout); logits
are float32, masked with ``NEG_INF`` (not -inf), the float32 softmax is
rounded to the compute dtype before the PV product, which accumulates in
float32 — so no fused attention kernel stands in for it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L
from repro_torch.models import sharding as SH

NEG_INF = -1e9


def repeat_kv(x, n_rep):
    """(B, S, Hkv, Dh) -> (B, S, Hkv * n_rep, Dh)"""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def sdpa(q, k, v, causal, q_offset=0, kv_len=None):
    """``_sdpa``; on DTensors, on each rank's rows and heads: rows on the
    batch axes, heads on the tensor axis where it divides the KV heads
    (else every rank takes all heads), the key sequence whole — but for a
    decode step on a cache whose sequence the policy splits
    (``cache_seq_on_tensor``), which ``_sdpa_seq_split`` runs on each
    rank's keys."""
    if not (SH.is_sharded(q) or SH.is_sharded(k)):
        return _sdpa(q, k, v, causal, q_offset, kv_len)
    rows = SH.axis("batch", q.shape[0])
    seq = SH.kv_seq_axis(k.shape[1]) if q.shape[1] == 1 else None
    if seq is not None:
        return _sdpa_seq_split(q, k, v, causal, q_offset, kv_len, rows, seq)
    lay = (rows, None, SH.axis("tensor", k.shape[2]), None)
    return SH.local_call(
        lambda q, k, v, kv_len: _sdpa(q, k, v, causal, q_offset, kv_len),
        (q, k, v, kv_len),
        (lay, lay, lay, None if kv_len is None else (rows,)), lay)


def _sdpa_seq_split(q, k, v, causal, q_offset, kv_len, rows, seq):
    """A decode step's attention with the key sequence split over the mesh
    axes ``seq``, as the reference partitions it: each rank's logits for
    its keys, pinned so (``sharding.decode_attn_logits_constraint``); the
    softmax's max and sum reduced across the shards (two small
    all-reduces; neither the logits nor the cache gathered); each rank's
    probabilities against its values in float32, partial sums that one
    all-reduce completes, rounded to q's dtype."""
    sk = k.shape[1]
    kv = (rows, seq, None, None)
    lens = None if kv_len is None else (rows,)
    logits = SH.local_call(
        lambda q, k, kv_len: _logits(q, k, causal, q_offset, kv_len,
                                     SH.first_index(seq, sk)),
        (q, k, kv_len), ((rows, None, None, None), kv, lens),
        (rows, None, None, seq))
    logits = SH.decode_attn_logits_constraint(logits)
    e = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    probs = (e / e.sum(dim=-1, keepdim=True)).to(q.dtype)
    out = SH.local_call(lambda p, v: _attend(p.float(), v.float()),
                        (probs, v), ((rows, None, None, seq), kv),
                        (rows, None, None, None), partial=seq)
    return SH.reduce_partials(out).to(q.dtype)


def _sdpa(q, k, v, causal, q_offset=0, kv_len=None):
    """q/k: (B, Sq/Sk, H/Hk, Dh), v: (B, Sk, Hk, Dv) with Hk dividing H
    (query head j·H/Hk + r reads kv head j, as after ``repeat_kv``); the
    logits are scaled by 1/√Dh (q's head dim; MLA's Dv differs).  fp32
    softmax.  Returns (B, Sq, H, Dv).

    ``q_offset``: absolute position of q[0] (decode: pos).  ``kv_len``:
    (B,) number of valid kv entries (masks the cache tail).
    """
    logits = _logits(q, k, causal, q_offset, kv_len)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return _attend(probs, v)


def _logits(q, k, causal, q_offset=0, kv_len=None, k0=0):
    """The masked, scaled float32 logits (B, H, Sq, Sk) of ``_sdpa``, the
    keys at positions k0 : k0 + Sk."""
    b, sq, h, dh = q.shape
    sk, hk = k.shape[1], k.shape[2]
    rep = h // hk
    scale = 1.0 / math.sqrt(dh)
    # (B, Hk, rep·Sq, Dh) queries against (B, Hk, Sk, Dh) keys
    qg = q.reshape(b, sq, hk, rep, dh).permute(0, 2, 3, 1, 4).reshape(
        b * hk, rep * sq, dh)
    kt = k.transpose(1, 2).reshape(b * hk, sk, dh)
    logits = L.matmul_f32(qg, kt.transpose(1, 2)).mul_(scale).view(
        b, h, sq, sk)
    if not (causal or kv_len is not None):
        return logits
    kpos = torch.arange(sk, device=q.device)
    if k0:
        kpos = kpos + k0
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        logits.masked_fill_(kpos[None, :] > qpos[:, None], NEG_INF)
    if kv_len is not None:
        valid = kpos[None, :] < kv_len[:, None]
        logits.masked_fill_(~valid[:, None, None, :], NEG_INF)
    return logits


def _attend(probs, v):
    """probs (B, H, Sq, Sk) against v (B, Sk, Hk, Dv): (B, Sq, H, Dv)."""
    b, h, sq, sk = probs.shape
    hk, dv = v.shape[2], v.shape[-1]
    rep = h // hk
    vt = v.transpose(1, 2).reshape(b * hk, sk, dv)
    out = torch.bmm(probs.reshape(b * hk, rep * sq, sk), vt)
    return out.view(b, hk, rep, sq, dv).permute(0, 3, 1, 2, 4).reshape(
        b, sq, h, dv)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def gqa_init(cfg, *, generator=None, device=None, dtype=torch.float32):
    """``dtype``: the dtype the matmul weights are held in (drawn in
    float32, then cast); biases and qk-norm scales stay float32."""
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(generator=generator, device=device, dtype=dtype)
    p = {
        "wq": L.dense_init((d, h * dh), **kw),
        "wk": L.dense_init((d, hkv * dh), **kw),
        "wv": L.dense_init((d, hkv * dh), **kw),
        "wo": L.dense_init((h * dh, d), **kw),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", h * dh), ("bk", hkv * dh), ("bv", hkv * dh)):
            p[name] = torch.zeros(n, dtype=torch.float32, device=device)
    if cfg.qk_norm:
        p["q_norm"] = L.rmsnorm_init(dh, device=device)
        p["k_norm"] = L.rmsnorm_init(dh, device=device)
    return p


def _project_qkv(p, x, xc, cfg, dtype):
    """xc = key/value source (cross-attention uses encoder output)."""
    b, s, _ = x.shape
    sk = xc.shape[1]
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = L.matmul(x, p["wq"], dtype)
    k = L.matmul(xc, p["wk"], dtype)
    v = L.matmul(xc, p["wv"], dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dtype)
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    q = SH.split_last(q, (h, dh))
    k = SH.split_last(k, (hkv, dh))
    v = SH.split_last(v, (hkv, dh))
    if cfg.qk_norm:
        q = L.rmsnorm(p["q_norm"], q)
        k = L.rmsnorm(p["k_norm"], k)
    return q, k, v


def _write_slots(buf, new, pvec):
    """Per-slot decode write: row ``pvec[i]`` of slot i gets ``new[i, 0]``;
    a position outside [0, S_max) writes nothing (the reference's
    ``where(arange(S_max) == pos, new, cache)``)."""
    smax = buf.shape[1]
    if SH.is_sharded(buf):
        # DTensor has no in-place index_put on a sharded batch: the
        # reference's masked form, a pass over the buffer
        hit = torch.arange(smax, device=buf.device)[None, :] == pvec[:, None]
        hit = hit.view(hit.shape + (1,) * (buf.dim() - 2))
        buf.copy_(torch.where(hit, new.to(buf.dtype), buf))
        return
    rows = torch.arange(buf.shape[0], device=buf.device)
    inside = (pvec >= 0) & (pvec < smax)
    at = pvec.clamp(0, smax - 1)
    vals = torch.where(inside.view((-1,) + (1,) * (buf.dim() - 2)),
                       new[:, 0].to(buf.dtype), buf[rows, at])
    buf[rows, at] = vals


def gqa_rope(cfg, positions, positions3=None):
    """The (cos, sin) pair ``gqa_apply`` rotates q and k by: M-RoPE when
    the config has it and ``positions3`` is given, else RoPE."""
    if cfg.mrope and positions3 is not None:
        return L.mrope_cos_sin(positions3, cfg.head_dim, cfg.mrope_sections,
                               cfg.rope_theta)
    return L.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)


def gqa_apply(p, x, cfg, positions, dtype, *, causal=True, cache=None,
              pos=None, xc=None, positions3=None, use_rope=True, rope=None):
    """Returns (out, cache).  cache = dict(k, v) of (B, S_max, Hkv, Dh),
    updated in place and returned.

    Modes: full-sequence (cache=None); prefill / scalar decode (cache + int
    ``pos``: rows pos : pos + S written, causal mask offset by pos over all
    of S_max); per-slot decode (cache + (B,) or (B, 1) tensor ``pos``, one
    query token per slot, mask kv_len = pos + 1 instead of the causal
    one); cross-attn (xc = encoder states, use_rope=False, causal=False).
    ``rope``: ``gqa_rope(cfg, positions, positions3)`` if the caller has it
    (a model computes it once for all its layers).
    """
    b, s, _ = x.shape
    h, dh = cfg.num_heads, cfg.head_dim
    q, k, v = _project_qkv(p, x, x if xc is None else xc, cfg, dtype)
    if use_rope:
        cos, sin = gqa_rope(cfg, positions, positions3) if rope is None \
            else rope
        q = L.rotate(q, cos, sin)
        k = L.rotate(k, cos, sin)

    kv_len = None
    q_offset = 0 if pos is None else pos
    if cache is not None and xc is None:
        if torch.is_tensor(pos) and pos.dim() > 0:
            pvec = pos.reshape(b)
            _write_slots(cache["k"], k, pvec)
            _write_slots(cache["v"], v, pvec)
            kv_len = pvec + 1
            causal = False
            q_offset = 0
        else:
            _write_rows(cache["k"], k, pos)
            _write_rows(cache["v"], v, pos)
            q_offset = int(pos)
        # scalar path: causal mask with q_offset=pos hides both the future
        # inside this chunk and the unwritten cache tail (kpos > pos + s - 1)
        k, v = cache["k"], cache["v"]
    out = sdpa(q, k.to(dtype), v.to(dtype), causal=causal, q_offset=q_offset,
               kv_len=kv_len)
    out = L.matmul(out.reshape(b, s, h * dh), p["wo"], dtype)
    return out, (cache if xc is None else None)


def gqa_cache_init(cfg, batch, s_max, dtype=torch.bfloat16, *, device=None):
    """Zero k and v, (B, S_max, Hkv, Dh) views of head-major buffers."""
    hkv, dh = cfg.num_kv_heads, cfg.head_dim
    return {name: torch.zeros(batch, hkv, s_max, dh, dtype=dtype,
                              device=device).transpose(1, 2)
            for name in ("k", "v")}


def _write_rows(buf, new, pos):
    """Prefill / scalar-pos write of ``new`` (B, S, ...) at rows
    pos : pos + S; the start is clamped so the rows fit, as
    ``dynamic_update_slice`` clamps it."""
    s, smax = new.shape[1], buf.shape[1]
    at = min(max(int(pos), 0), smax - s)
    if SH.split_count(buf, 1) > 1:
        SH.write_split_rows(buf, new, at)
        return
    buf[:, at:at + s] = new.to(buf.dtype)


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention) — MiniCPM3 / DeepSeek-V2 family
# ---------------------------------------------------------------------------

def mla_init(cfg, *, generator=None, device=None, dtype=torch.float32):
    d, h = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {
        "wdq": L.dense_init((d, qr), **kw),
        "q_norm": L.rmsnorm_init(qr, device=device),
        "wuq": L.dense_init((qr, h * (dn + dr)), **kw),
        "wdkv": L.dense_init((d, kvr), **kw),
        "kv_norm": L.rmsnorm_init(kvr, device=device),
        "wukv": L.dense_init((kvr, h * (dn + dv)), **kw),
        "wkr": L.dense_init((d, dr), **kw),
        "wo": L.dense_init((h * dv, d), **kw),
    }


def mla_rope(cfg, positions):
    """The (cos, sin) pair MLA rotates its ``qk_rope_dim`` query and key
    dims by (its own angles, not GQA's over ``head_dim``)."""
    return L.rope_cos_sin(positions, cfg.qk_rope_dim, cfg.rope_theta)


def mla_apply(p, x, cfg, positions, dtype, *, causal=True, cache=None,
              pos=None, rope=None):
    """Returns (out, cache).  cache = dict(ckv (B, S_max, kv_rank), k_rope
    (B, S_max, 1, rope_dim)), updated in place and returned.  Modes as
    ``gqa_apply``'s: full (cache=None), prefill / scalar decode (int
    ``pos``), per-slot decode (tensor ``pos``: the rows at pos written,
    kv_len = pos + 1, no causal mask).  Every call expands the whole
    cached latent through ``wukv`` (not the "absorbed" form).  ``rope``:
    ``mla_rope(cfg, positions)`` if the caller has it."""
    b, s, _ = x.shape
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    cos, sin = mla_rope(cfg, positions) if rope is None else rope
    # queries through the low-rank bottleneck
    cq = L.rmsnorm(p["q_norm"], L.matmul(x, p["wdq"], dtype))
    q = SH.split_last(L.matmul(cq, p["wuq"], dtype), (h, dn + dr))
    q_nope, q_rope = q[..., :dn], L.rotate(q[..., dn:], cos, sin)
    # compressed KV latent + shared rope key (this is what gets cached)
    ckv = L.rmsnorm(p["kv_norm"], L.matmul(x, p["wdkv"], dtype))
    k_rope = L.rotate(L.matmul(x, p["wkr"], dtype)[:, :, None, :], cos, sin)

    kv_len = None
    q_offset = 0 if pos is None else pos
    if cache is not None:
        if torch.is_tensor(pos) and pos.dim() > 0:
            pvec = pos.reshape(b)
            _write_slots(cache["ckv"], ckv, pvec)
            _write_slots(cache["k_rope"], k_rope, pvec)
            kv_len = pvec + 1
            causal = False
            q_offset = 0
        else:
            _write_rows(cache["ckv"], ckv, pos)
            _write_rows(cache["k_rope"], k_rope, pos)
            q_offset = int(pos)
        ckv, k_rope = cache["ckv"], cache["k_rope"]
        # sharded, the latent's sequence is gathered before the expansion
        # (attention takes it whole; folding an S-sharded cache into the
        # product's rows is a layout DTensor cannot gather)
        ckv = SH.shard_as(ckv, "batch", None, None)
        k_rope = SH.shard_as(k_rope, "batch", None, None, None)
    sk = ckv.shape[1]
    kv = SH.split_last(L.matmul(ckv.to(dtype), p["wukv"], dtype),
                       (h, dn + dv))
    k = torch.cat([kv[..., :dn],
                   k_rope.to(dtype).expand(b, sk, h, dr)], dim=-1)
    out = sdpa(torch.cat([q_nope, q_rope], dim=-1), k, kv[..., dn:],
               causal=causal, q_offset=q_offset, kv_len=kv_len)
    out = L.matmul(out.reshape(b, s, h * dv), p["wo"], dtype)
    return out, cache


def mla_cache_init(cfg, batch, s_max, dtype=torch.bfloat16, *, device=None):
    return {"ckv": torch.zeros(batch, s_max, cfg.kv_lora_rank, dtype=dtype,
                               device=device),
            "k_rope": torch.zeros(batch, s_max, 1, cfg.qk_rope_dim,
                                  dtype=dtype, device=device)}
