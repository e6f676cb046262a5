"""The port's LM substrate (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package's on the CPU: the same numpy inputs, and the
reference's own weights (``repro.models.model.init`` at ``PRNGKey(0)``)
carried across by ``convert.lm_params_from_numpy``.  QKV biases and norm
scales, which the reference draws as zeros and ones, are perturbed on both
sides so that they take part.

Tolerances, of the largest magnitude of the reference's output: float32
rel 1e-5; bf16 rel 2e-2 (the reference's own decode tolerance), since both
sides round each product to bf16 but may sum it in another order."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import common as jcommon  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs import common as tcommon  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

F32, BF16 = "f32", "bf16"
TOL = {F32: 1e-5, BF16: 2e-2}
GQA_ARCHS = ["qwen3-4b", "qwen1.5-110b", "nemotron-4-340b", "qwen2-vl-7b"]


@pytest.fixture(autouse=True)
def _few_threads():
    """Tiny ops: more threads than cores only thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def close(got, want, rel):
    got = np.asarray(torch.as_tensor(got).float() if torch.is_tensor(got)
                     else np.asarray(got, np.float32), np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (err, rel)


def pair(x, dt):
    """The same values as a JAX and a torch array in dtype ``dt``."""
    x = np.asarray(x, np.float32)
    if dt == BF16:
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(
            torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def dtypes(dt):
    return (jnp.bfloat16, torch.bfloat16) if dt == BF16 else (
        jnp.float32, torch.float32)


def flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in p): np.asarray(v) for p, v in leaves}


def perturbed(tree, seed=7):
    """QKV biases and norm scales/biases drawn away from zeros and ones."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        name = str(path[-1].key)
        if name in ("bq", "bk", "bv", "bias"):
            return x + jnp.asarray(rng.normal(0, 0.1, x.shape), x.dtype)
        if name == "scale":
            return x + jnp.asarray(rng.normal(0, 0.1, x.shape), x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(f, tree)


def torch_tree(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x, np.float32)),
                        tree)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", [F32, BF16])
def test_rmsnorm(dt):
    rng = np.random.default_rng(0)
    xj, xt = pair(rng.normal(0, 3, (2, 5, 64)), dt)
    scale = rng.normal(1, 0.2, 64).astype(np.float32)
    want = JL.rmsnorm({"scale": jnp.asarray(scale)}, xj)
    got = TL.rmsnorm({"scale": torch.from_numpy(scale)}, xt)
    assert got.dtype == xt.dtype
    close(got, want, TOL[dt])


@pytest.mark.parametrize("dt", [F32, BF16])
def test_layernorm(dt):
    rng = np.random.default_rng(1)
    xj, xt = pair(rng.normal(2, 3, (2, 5, 64)), dt)
    p = {"scale": rng.normal(1, 0.2, 64).astype(np.float32),
         "bias": rng.normal(0, 0.2, 64).astype(np.float32)}
    want = JL.layernorm({k: jnp.asarray(v) for k, v in p.items()}, xj)
    got = TL.layernorm({k: torch.from_numpy(v) for k, v in p.items()}, xt)
    assert got.dtype == xt.dtype
    close(got, want, TOL[dt])


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("act", ["silu", "gelu", "relu2"])
def test_activation(act, dt):
    xj, xt = pair(np.random.default_rng(2).normal(0, 3, (4, 300)), dt)
    close(TL.activation(act, xt), JL.activation(act, xj), TOL[dt])


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(theta, dt):
    rng = np.random.default_rng(3)
    xj, xt = pair(rng.normal(0, 1, (2, 9, 4, 32)), dt)
    pos = rng.integers(0, 2048, (2, 9)).astype(np.int32)
    pos[0, 0] = 2047
    want = JL.apply_rope(xj, jnp.asarray(pos), theta)
    got = TL.apply_rope(xt, torch.from_numpy(pos), theta)
    assert got.dtype == xt.dtype
    close(got, want, TOL[dt])


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("dh", [32, 128])
def test_apply_mrope(dh, dt):
    """dh = 128: sections (16, 24, 24) cover the 64 frequencies; dh = 32
    (the smoke size): they are cut at 16, as ``total_repeat_length``
    cuts them."""
    rng = np.random.default_rng(4)
    xj, xt = pair(rng.normal(0, 1, (2, 7, 3, dh)), dt)
    pos3 = rng.integers(0, 512, (2, 3, 7)).astype(np.int32)
    want = JL.apply_mrope(xj, jnp.asarray(pos3), (16, 24, 24), 1e6)
    got = TL.apply_mrope(xt, torch.from_numpy(pos3), (16, 24, 24), 1e6)
    close(got, want, TOL[dt])


@pytest.mark.parametrize("seq,d", [(16, 128), (64, 64)])
def test_sinusoidal_positions(seq, d):
    close(TL.sinusoidal_positions(seq, d), JL.sinusoidal_positions(seq, d),
          TOL[F32])


@pytest.mark.parametrize("dt", [F32, BF16])
def test_matmul(dt):
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 6, 96)).astype(np.float32)
    w = rng.normal(0, 0.1, (96, 80)).astype(np.float32)
    jd, td = dtypes(dt)
    want = JL.matmul(jnp.asarray(x), jnp.asarray(w), jd)
    got = TL.matmul(torch.from_numpy(x), torch.from_numpy(w), td)
    assert got.dtype == td
    close(got, want, TOL[dt])


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("act,gated", [("silu", True), ("relu2", False),
                                       ("gelu", False)])
def test_mlp_apply(act, gated, dt):
    jp = JL.mlp_init(jax.random.PRNGKey(1), 64, 160, gated)
    x = np.random.default_rng(6).normal(0, 1, (2, 5, 64))
    jd, td = dtypes(dt)
    xj, xt = pair(x, dt)
    want = JL.mlp_apply(jp, xj, act, jd)
    got = TL.mlp_apply(torch_tree(jp), xt, act, td)
    close(got, want, TOL[dt])


def test_dense_init_draws_float32_then_casts():
    g = torch.Generator().manual_seed(3)
    w32 = TL.dense_init((64, 8), generator=g)
    g.manual_seed(3)
    w16 = TL.dense_init((64, 8), generator=g, dtype=torch.bfloat16)
    assert w32.dtype == torch.float32 and w16.dtype == torch.bfloat16
    assert torch.equal(w32.to(torch.bfloat16), w16)
    assert abs(float(w32.std()) - 1 / 8) < 0.03


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def test_repeat_kv():
    x = np.random.default_rng(7).normal(0, 1, (2, 5, 2, 8)).astype(np.float32)
    want = jattn.repeat_kv(jnp.asarray(x), 3)
    got = tattn.repeat_kv(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("mask", ["causal", "q_offset", "kv_len", "none"])
def test_sdpa(mask, dt):
    """k and v with 2 heads against 4 query heads, grouped in the port and
    repeated in the reference."""
    rng = np.random.default_rng(8)
    b, sq, sk, h, hk, dh = 3, 4, 12, 4, 2, 16
    qj, qt = pair(rng.normal(0, 1, (b, sq, h, dh)), dt)
    kj, kt = pair(rng.normal(0, 1, (b, sk, hk, dh)), dt)
    vj, vt = pair(rng.normal(0, 1, (b, sk, hk, dh)), dt)
    kw = dict(causal=mask in ("causal", "q_offset"))
    if mask == "q_offset":
        kw["q_offset"] = 6
    kv_len = np.array([3, 12, 7], np.int32)
    jkw, tkw = dict(kw), dict(kw)
    if mask == "kv_len":
        jkw["kv_len"], tkw["kv_len"] = (jnp.asarray(kv_len),
                                        torch.from_numpy(kv_len))
    want = jattn.sdpa(qj, jattn.repeat_kv(kj, h // hk),
                      jattn.repeat_kv(vj, h // hk), **jkw)
    got = tattn.sdpa(qt, kt, vt, **tkw)
    assert got.dtype == qt.dtype
    close(got, want, TOL[dt])
    # the repeated layout gives the same values
    close(tattn.sdpa(qt, tattn.repeat_kv(kt, 2), tattn.repeat_kv(vt, 2),
                     **tkw), want, TOL[dt])


def _gqa_case(flavor):
    arch = {"qk_norm": "qwen3-4b", "qkv_bias": "qwen1.5-110b",
            "mrope": "qwen2-vl-7b"}[flavor]
    jc, tc = JARCHS[arch].smoke_config(), ARCHS[arch].smoke_config()
    if flavor == "mrope":      # dh 128 so that all three sections rotate
        jc = dataclasses.replace(jc, head_dim=128)
        tc = dataclasses.replace(tc, head_dim=128)
    jp = perturbed({"attn": jattn.gqa_init(jax.random.PRNGKey(2), jc)})
    return jc, tc, jp["attn"], torch_tree(jp["attn"])


@pytest.mark.parametrize("mode", ["full", "prefill", "vector_pos"])
@pytest.mark.parametrize("flavor", ["qk_norm", "qkv_bias", "mrope"])
def test_gqa_apply(flavor, mode):
    jc, tc, jp, tp = _gqa_case(flavor)
    rng = np.random.default_rng(9)
    b, s, smax = 3, (1 if mode == "vector_pos" else 6), 10
    x = rng.normal(0, 1, (b, s, jc.d_model)).astype(np.float32)
    positions = np.broadcast_to(np.arange(s), (b, s)).astype(np.int32)
    pvec = np.array([4, 9, smax], np.int32)     # the last writes nothing
    if mode == "vector_pos":
        positions = pvec[:, None].copy()
    pos3 = np.stack([positions, positions * 2, positions + 3], 1).astype(
        np.int32) if flavor == "mrope" else None
    jkw, tkw = {}, {}
    if pos3 is not None:
        jkw["positions3"] = jnp.asarray(pos3)
        tkw["positions3"] = torch.from_numpy(pos3)
    cache = None
    if mode != "full":
        cache = rng.normal(0, 1, (2, b, smax, jc.num_kv_heads,
                                  jc.head_dim)).astype(np.float32)
        if mode == "prefill":
            cache[:] = 0
        tcache = tattn.gqa_cache_init(tc, b, smax, torch.float32)
        tcache["k"].copy_(torch.from_numpy(cache[0]))
        tcache["v"].copy_(torch.from_numpy(cache[1]))
        jkw["cache"] = {"k": jnp.asarray(cache[0]), "v": jnp.asarray(cache[1])}
        tkw["cache"] = tcache
        jkw["pos"], tkw["pos"] = ((0, 0) if mode == "prefill" else (
            jnp.asarray(pvec[:, None]), torch.from_numpy(pvec[:, None])))
    want, wcache = jattn.gqa_apply(jp, jnp.asarray(x), jc,
                                   jnp.asarray(positions), jnp.float32, **jkw)
    got, gcache = tattn.gqa_apply(tp, torch.from_numpy(x), tc,
                                  torch.from_numpy(positions), torch.float32,
                                  **tkw)
    close(got, want, TOL[F32])
    if mode == "full":
        assert gcache is None and wcache is None
    else:
        for name in ("k", "v"):
            close(gcache[name], wcache[name], TOL[F32])


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _pos3(b, s, offset=0):
    pos = np.broadcast_to(np.arange(offset, offset + s), (b, s))
    return np.ascontiguousarray(np.broadcast_to(pos[:, None, :], (b, 3, s)))


_jforward = jax.jit(JM.forward, static_argnums=0,
                    static_argnames=("make_cache_len", "return_hidden"))
_jdecode = jax.jit(JM.decode_step, static_argnums=0)


@functools.lru_cache(maxsize=None)
def carried(arch):
    """(JAX config, port config, JAX params, port params) on the same
    weights: the reference's ``init`` at PRNGKey(0), biases and scales
    perturbed."""
    jc, tc = JARCHS[arch].smoke_config(), ARCHS[arch].smoke_config()
    jp = perturbed(JM.init(jc, jax.random.PRNGKey(0)))
    return jc, tc, jp, convert.lm_params_from_numpy(tc, flat(jp),
                                                    device="cpu")


@functools.lru_cache(maxsize=None)
def reference_runs(arch):
    """The reference's forward logits, prefill logits and caches, and
    scalar- and vector-pos decode logits and caches, on (2, 16) tokens:
    prefill 12, then decode tokens 12..15 with positions 12..15 (scalar) or
    [12 + t, 5 + t] (vector)."""
    jc, _, jp, _ = carried(arch)
    b, s, half, smax = 2, 16, 12, 24
    toks = _tokens(jc, b, s, seed=1)
    mrope = jc.mrope
    batch = {"tokens": jnp.asarray(toks)}
    if mrope:
        batch["positions3"] = jnp.asarray(_pos3(b, s))
    full, _ = _jforward(jc, jp, batch)
    pre = {"tokens": batch["tokens"][:, :half]}
    if mrope:
        pre["positions3"] = jnp.asarray(_pos3(b, half))
    plog, cache = _jforward(jc, jp, pre, make_cache_len=smax)
    out = dict(tokens=toks, full=np.asarray(full), prefill=np.asarray(plog),
               cache=jax.tree.map(np.asarray, cache))
    for kind in ("scalar", "vector"):
        c, logs = cache, []
        for t in range(half, s):
            if kind == "scalar":
                pos = jnp.int32(t)
                p3 = _pos3(b, 1, t) if mrope else None
            else:
                pv = np.array([[t], [t - 7]], np.int32)
                pos = jnp.asarray(pv)
                p3 = (np.ascontiguousarray(np.broadcast_to(
                    pv[:, None, :], (b, 3, 1))) if mrope else None)
            lg, c = _jdecode(jc, jp, batch["tokens"][:, t:t + 1], c,
                                   pos, positions3=None if p3 is None
                                   else jnp.asarray(p3))
            logs.append(np.asarray(lg))
        out[kind] = (np.concatenate(logs, 1), jax.tree.map(np.asarray, c))
    return out


def _port_kv(cache, layer, name):
    return cache["blocks"][layer]["kv"][name]


def _ref_kv(cache, cfg, layer, name):
    P = len(cfg.pattern)
    return cache["blocks"][f"l{layer % P}"]["kv"][name][layer // P]


@pytest.mark.parametrize("arch", GQA_ARCHS)
def test_forward_matches_reference(arch):
    _, tc, _, tp = carried(arch)
    ref = reference_runs(arch)
    toks = torch.from_numpy(ref["tokens"])
    batch = {"tokens": toks}
    if tc.mrope:
        batch["positions3"] = torch.from_numpy(_pos3(2, 16))
    logits, none = TM.forward(tc, tp, batch)
    assert none is None and logits.shape == (2, 16, tc.padded_vocab)
    close(logits, ref["full"], TOL[F32])
    _, hidden = TM.forward(tc, tp, batch, return_hidden=True)
    assert hidden.shape == (2, 16, tc.d_model)


@pytest.mark.parametrize("arch", GQA_ARCHS)
def test_prefill_cache_matches_reference(arch):
    jc, tc, _, tp = carried(arch)
    ref = reference_runs(arch)
    batch = {"tokens": torch.from_numpy(ref["tokens"][:, :12])}
    if tc.mrope:
        batch["positions3"] = torch.from_numpy(_pos3(2, 12))
    logits, cache = TM.forward(tc, tp, batch, make_cache_len=24)
    close(logits, ref["prefill"], TOL[F32])
    assert cache["enc_out"] is None and len(cache["blocks"]) == tc.num_layers
    for layer in range(tc.num_layers):
        for name in ("k", "v"):
            got = _port_kv(cache, layer, name)
            assert got.shape == (2, 24, tc.num_kv_heads, tc.head_dim)
            close(got, _ref_kv(ref["cache"], jc, layer, name), TOL[F32])


@pytest.mark.parametrize("kind", ["scalar", "vector"])
@pytest.mark.parametrize("arch", GQA_ARCHS)
def test_decode_step_matches_reference(arch, kind):
    jc, tc, _, tp = carried(arch)
    ref = reference_runs(arch)
    toks = torch.from_numpy(ref["tokens"])
    batch = {"tokens": toks[:, :12]}
    if tc.mrope:
        batch["positions3"] = torch.from_numpy(_pos3(2, 12))
    _, cache = TM.forward(tc, tp, batch, make_cache_len=24)
    logs = []
    for t in range(12, 16):
        if kind == "scalar":
            pos, p3 = t, (_pos3(2, 1, t) if tc.mrope else None)
        else:
            pv = np.array([[t], [t - 7]], np.int32)
            pos = torch.from_numpy(pv)
            p3 = (np.ascontiguousarray(np.broadcast_to(pv[:, None, :],
                                                       (2, 3, 1)))
                  if tc.mrope else None)
        lg, cache = TM.decode_step(
            tc, tp, toks[:, t:t + 1], cache, pos,
            positions3=None if p3 is None else torch.from_numpy(p3))
        logs.append(lg)
    want_logits, want_cache = ref[kind]
    close(torch.cat(logs, 1), want_logits, TOL[F32])
    for layer in range(tc.num_layers):
        for name in ("k", "v"):
            close(_port_kv(cache, layer, name),
                  _ref_kv(want_cache, jc, layer, name), TOL[F32])


def test_decode_bf16_matches_reference():
    """The serving dtype: bf16 compute and cache, weights as their bf16
    copies on the port's side (``cast_weights``), cast at use on the
    reference's."""
    jc, tc, jp, tp = carried("qwen3-4b")
    jc = dataclasses.replace(jc, compute_dtype=jnp.bfloat16,
                             cache_dtype=jnp.bfloat16)
    tc = dataclasses.replace(tc, compute_dtype=torch.bfloat16,
                             cache_dtype=torch.bfloat16)
    tp = TM.cast_weights(tp, torch.bfloat16)
    toks = _tokens(jc, 2, 10, seed=3)
    wl, wc = JM.forward(jc, jp, {"tokens": jnp.asarray(toks[:, :8])},
                        make_cache_len=16)
    gl, gc = TM.forward(tc, tp, {"tokens": torch.from_numpy(toks[:, :8])},
                        make_cache_len=16)
    close(gl, wl.astype(jnp.float32), TOL[BF16])
    pv = np.array([[8], [3]], np.int32)
    wd, _ = JM.decode_step(jc, jp, jnp.asarray(toks[:, 8:9]), wc,
                           jnp.asarray(pv))
    gd, _ = TM.decode_step(tc, tp, torch.from_numpy(toks[:, 8:9]), gc,
                           torch.from_numpy(pv))
    assert gd.dtype == torch.bfloat16
    close(gd, wd.astype(jnp.float32), TOL[BF16])


def test_prefill_decode_matches_forward():
    """Port mirror of the reference's test: teacher-forced decode through
    the cache reproduces the full forward logits."""
    cfg = ARCHS["qwen3-4b"].smoke_config()
    params = TM.init(cfg, torch.Generator().manual_seed(0))
    b, s = 2, 16
    toks = torch.from_numpy(_tokens(cfg, b, s, seed=1))
    full, _ = TM.forward(cfg, params, {"tokens": toks})
    half = s // 2
    _, cache = TM.forward(cfg, params, {"tokens": toks[:, :half]},
                          make_cache_len=s)
    outs = []
    for t in range(half, s):
        lg, cache = TM.decode_step(cfg, params, toks[:, t:t + 1], cache, t)
        outs.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), full[:, half:],
                               rtol=2e-2, atol=2e-2)


def test_vector_pos_decode_matches_scalar():
    """Port mirror: per-slot decode with equal positions equals the
    scalar-pos decode."""
    cfg = ARCHS["qwen3-4b"].smoke_config()
    params = TM.init(cfg, torch.Generator().manual_seed(0))
    b, s = 3, 8
    toks = torch.from_numpy(_tokens(cfg, b, s, seed=1))
    _, cache = TM.forward(cfg, params, {"tokens": toks}, make_cache_len=32)
    nxt = torch.from_numpy(_tokens(cfg, b, 1, seed=2))
    twin = TM.init_cache(cfg, b, 32)
    for a, c in zip(TM.leaves(twin), TM.leaves(cache)):
        a.copy_(c)
    l_scalar, _ = TM.decode_step(cfg, params, nxt, cache, s)
    l_vec, _ = TM.decode_step(cfg, params, nxt, twin,
                              torch.full((b, 1), s, dtype=torch.int32))
    torch.testing.assert_close(l_vec, l_scalar, rtol=2e-3, atol=2e-3)
    for a, c in zip(TM.leaves(twin), TM.leaves(cache)):
        assert torch.equal(a, c)


# ---------------------------------------------------------------------------
# configs, parameter counts, the converter
# ---------------------------------------------------------------------------

def _field(v):
    """A config field in a form both packages share (dtypes by name)."""
    if isinstance(v, torch.dtype):
        return str(v).removeprefix("torch.")
    if isinstance(v, type) or isinstance(v, np.dtype):
        return np.dtype(v).name
    if isinstance(v, tuple):
        return tuple(_field(x) for x in v)
    if dataclasses.is_dataclass(v):
        return tuple((f.name, _field(getattr(v, f.name)))
                     for f in dataclasses.fields(v))
    return v


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_config_fields_match_reference(arch):
    jm, tm = JARCHS[arch], ARCHS[arch]
    for jc, tc in ((jm.CONFIG, tm.CONFIG),
                   (jm.smoke_config(), tm.smoke_config())):
        jf = [(f.name, _field(getattr(jc, f.name)))
              for f in dataclasses.fields(jc)]
        tf = [(f.name, _field(getattr(tc, f.name)))
              for f in dataclasses.fields(tc)]
        assert tf == jf
        assert (tc.num_groups, tc.padded_vocab, tc.is_encdec) == (
            jc.num_groups, jc.padded_vocab, jc.is_encdec)
    assert tm.SUPPORTS == jm.SUPPORTS
    assert sorted(ARCHS) == sorted(JARCHS)


def test_common_helpers_match_reference():
    assert tcommon.SHAPES == jcommon.SHAPES
    assert tcommon.SKIP_LONG == jcommon.SKIP_LONG
    assert tcommon.all_shapes() == jcommon.all_shapes()
    assert tcommon.lm_shapes_no_long("x") == jcommon.lm_shapes_no_long("x")
    assert _field(TM.jamba_pattern()) == _field(JM.jamba_pattern())
    assert _field(TM.uniform_pattern("mamba", "none")) == _field(
        JM.uniform_pattern("mamba", "none"))
    small = tcommon.shrink(ARCHS["qwen3-4b"].CONFIG, d_model=64)
    assert _field(small) == _field(jcommon.shrink(
        JARCHS["qwen3-4b"].CONFIG, d_model=64))


def test_full_configs_match_published_numbers():
    """Port mirror of the reference's test, on the port's configs."""
    c = ARCHS["qwen1.5-110b"].CONFIG
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads,
            c.d_ff, c.vocab_size) == (80, 8192, 64, 8, 49152, 152064)
    assert c.qkv_bias
    c = ARCHS["nemotron-4-340b"].CONFIG
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads,
            c.d_ff, c.vocab_size) == (96, 18432, 96, 8, 73728, 256000)
    assert c.activation == "relu2" and not c.gated
    c = ARCHS["phi3.5-moe-42b-a6.6b"].CONFIG
    assert (c.num_experts, c.moe_top_k) == (16, 2)
    c = ARCHS["granite-moe-1b-a400m"].CONFIG
    assert (c.num_experts, c.moe_top_k, c.d_model) == (32, 8, 1024)
    c = ARCHS["jamba-1.5-large-398b"].CONFIG
    assert len(c.pattern) == 8
    assert sum(1 for sp in c.pattern if sp.mixer == "attn") == 1
    assert sum(1 for sp in c.pattern if sp.ffn == "moe") == 4
    c = ARCHS["mamba2-2.7b"].CONFIG
    assert c.ssm_state == 128 and c.num_layers == 64
    c = ARCHS["minicpm3-4b"].CONFIG
    assert c.attn_kind == "mla" and c.num_layers == 62
    c = ARCHS["qwen2-vl-7b"].CONFIG
    assert c.mrope and c.num_kv_heads == 4
    c = ARCHS["whisper-large-v3"].CONFIG
    assert c.encoder_layers == 32 and c.vocab_size == 51866
    c = ARCHS["qwen3-4b"].CONFIG
    assert c.qk_norm and (c.num_layers, c.d_ff) == (36, 9728)


class _Devices(torch.utils._python_dispatch.TorchDispatchMode):
    """Records the device of every tensor an op makes."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in TM.leaves(out if isinstance(out, (list, tuple)) else [out]):
            if isinstance(t, torch.Tensor):
                self.seen.add(t.device.type)
        return out


@pytest.mark.parametrize("arch", GQA_ARCHS)
def test_param_count_matches_reference(arch):
    with _Devices() as mode:
        n = ARCHS[arch].CONFIG.param_count()
    assert mode.seen == {"meta"}
    # the reference's own shapes, summed in Python integers: its
    # param_count() multiplies each leaf's dims in int32, which wraps for a
    # stacked leaf of more than 2**31 elements (qwen1.5-110b, nemotron)
    jcfg = JARCHS[arch].CONFIG
    shapes = jax.eval_shape(lambda k: JM.init(jcfg, k),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    assert n == sum(int(np.prod(x.shape, dtype=object))
                    for x in jax.tree.leaves(shapes))
    if arch in ("qwen3-4b", "qwen2-vl-7b"):
        assert n == jcfg.param_count()
    if arch == "qwen3-4b":
        assert n == 4_411_424_256


def test_converter_round_trip_and_errors():
    jc, tc, jp, tp = carried("qwen3-4b")
    fl = flat(jp)
    back = convert.lm_params_to_numpy(tc, tp)
    assert sorted(back) == sorted(fl)
    for k in fl:
        np.testing.assert_array_equal(back[k], fl[k])
    again = convert.lm_params_from_numpy(tc, back, device="cpu")
    for a, b in zip(TM.leaves(again), TM.leaves(tp)):
        assert torch.equal(a, b)
    missing = {k: v for k, v in fl.items() if k != "blocks/l0/attn/wq"}
    with pytest.raises(ValueError, match="missing.*blocks/l0/attn/wq"):
        convert.lm_params_from_numpy(tc, missing, device="cpu")
    with pytest.raises(ValueError, match="unknown.*blocks/l0/attn/bq"):
        convert.lm_params_from_numpy(
            tc, {**fl, "blocks/l0/attn/bq": np.zeros((2, 128), np.float32)},
            device="cpu")
    wrong = {**fl, "head": fl["head"][:, :-128]}
    with pytest.raises(ValueError, match="head has shape"):
        convert.lm_params_from_numpy(tc, wrong, device="cpu")

