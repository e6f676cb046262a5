"""The port's remaining LM families against the JAX package on the CPU:
MLA (MiniCPM3), MoE (Granite, Phi-3.5), Mamba-2 and the Jamba hybrid, and
the Whisper encoder — each module on the same numpy inputs, then whole
models at the smoke size on the reference's own weights
(``repro.models.model.init`` at ``PRNGKey(0)``, biases, scales and
Mamba-2's D, dt_bias and conv biases perturbed so that they take part)
carried across by ``convert.lm_params_from_numpy``, then the server's
token streams against the JAX server's.

Tolerances, of the largest magnitude of the reference's output: float32
rel 1e-5; bf16 rel 2e-2 (both sides round each product to bf16 but may
sum it in another order).

The references are compiled with XLA's excess precision off (``exact``),
so that each op is rounded to its dtype where the reference's source
writes it, as an op-by-op run (``jax.disable_jit()``) rounds it, bit for
bit — which is what the port computes.  With it on (XLA's default) a bf16
result that the next op widens to float32 stays float32 (Mamba-2's
y·silu(z) before the gated norm, for one): on the bf16 Jamba smoke model
that moves the reference's own prefill logits by 0.62 of the largest
against its op-by-op run (its MoE routing flips), while the port stays
within 4e-3 of the op-by-op run.

This JAX's CPU runtime has no batched bf16 × bf16 → float32 dot, which the
reference's MoE einsums need; the bf16 MoE tests run those einsums on
float32 copies of their bf16 operands (``bf16_dots``): the products of
bf16 values are exact in float32 and the sums are float32 either way, so
the reference computes the same values."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import mamba2 as jm2  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import mamba2 as tm2  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from test_torch_models import (BF16, F32, TOL, close, dtypes,  # noqa: E402
                               flat, pair, torch_tree, _tokens)

FAMILIES = ["minicpm3-4b", "granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b",
            "mamba2-2.7b", "jamba-1.5-large-398b", "whisper-large-v3"]
SERVED = [a for a in FAMILIES if a != "whisper-large-v3"]
PERTURBED = ("bq", "bk", "bv", "bias", "scale", "D", "dt_bias", "conv_b_x",
             "conv_b_bc")


@pytest.fixture(autouse=True)
def _few_threads():
    """Tiny ops: more threads than cores only thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


_EXACT = {}


def exact(fn, *args, **kw):
    """``fn(*args, **kw)``, a reference function, jitted and compiled with
    XLA's excess precision off (see the module docstring), once per static
    arguments and array shapes.  Arguments that are not arrays or trees of
    arrays (configs, dtypes, ints, None) are static."""
    def dynamic(v):
        return isinstance(v, (dict, list, jax.Array, np.ndarray))
    sa = tuple(i for i, a in enumerate(args) if not dynamic(a))
    sk = tuple(k for k, v in kw.items() if not dynamic(v))
    dargs = [a for i, a in enumerate(args) if i not in sa]
    dkw = {k: v for k, v in kw.items() if k not in sk}
    key = (fn, tuple((i, args[i]) for i in sa), tuple((k, kw[k]) for k in sk),
           jax.tree.structure((dargs, dkw)),
           tuple((x.shape, str(x.dtype)) for x in jax.tree.leaves((dargs,
                                                                  dkw))))
    if key not in _EXACT:
        _EXACT[key] = jax.jit(fn, static_argnums=sa, static_argnames=sk).lower(
            *args, **kw).compile(
                compiler_options={"xla_allow_excess_precision": False})
    return _EXACT[key](*dargs, **dkw)


@pytest.fixture
def bf16_dots(monkeypatch):
    """``jnp.einsum`` with ``preferred_element_type=float32`` on float32
    copies of its bf16 operands (see the module docstring)."""
    real = jnp.einsum

    def einsum(spec, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) if o.dtype == jnp.bfloat16 else o
                   for o in ops]
        return real(spec, *ops, preferred_element_type=preferred_element_type,
                    **kw)
    monkeypatch.setattr(jnp, "einsum", einsum)


def perturbed(tree, seed=7):
    """The ``PERTURBED`` leaves drawn away from their zeros and ones."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        if str(path[-1].key) in PERTURBED:
            return x + jnp.asarray(rng.normal(0, 0.1, x.shape), x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(f, tree)


def smoke(arch):
    return JARCHS[arch].smoke_config(), ARCHS[arch].smoke_config()


def in_dtype(jc, tc, dt):
    """The configs with compute and cache dtype ``dt``."""
    jd, td = dtypes(dt)
    return (dataclasses.replace(jc, compute_dtype=jd, cache_dtype=jd),
            dataclasses.replace(tc, compute_dtype=td, cache_dtype=td))


def port_params(tp, dt):
    """The port's weights as the server holds them in ``dt``."""
    return TM.cast_weights(tp, torch.bfloat16) if dt == BF16 else tp


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("mode", ["full", "prefill", "vector_pos"])
def test_mla_apply(mode, dt):
    jc, tc = in_dtype(*smoke("minicpm3-4b"), dt)
    jd, td = dtypes(dt)
    jp = perturbed({"attn": jattn.mla_init(jax.random.PRNGKey(2), jc)})
    tp = port_params(torch_tree(jp["attn"]), dt)
    rng = np.random.default_rng(9)
    b, s, smax = 3, (1 if mode == "vector_pos" else 6), 10
    xj, xt = pair(rng.normal(0, 1, (b, s, jc.d_model)), dt)
    positions = np.broadcast_to(np.arange(s), (b, s)).astype(np.int32)
    pvec = np.array([4, 9, smax], np.int32)     # the last writes nothing
    if mode == "vector_pos":
        positions = pvec[:, None].copy()
    jkw, tkw = {}, {}
    if mode != "full":
        ckv = rng.normal(0, 1, (b, smax, jc.kv_lora_rank))
        kr = rng.normal(0, 1, (b, smax, 1, jc.qk_rope_dim))
        if mode == "prefill":
            ckv[:], kr[:] = 0, 0
        tcache = tattn.mla_cache_init(tc, b, smax, td)
        tcache["ckv"].copy_(pair(ckv, dt)[1])
        tcache["k_rope"].copy_(pair(kr, dt)[1])
        jkw["cache"] = {"ckv": pair(ckv, dt)[0], "k_rope": pair(kr, dt)[0]}
        tkw["cache"] = tcache
        jkw["pos"], tkw["pos"] = ((0, 0) if mode == "prefill" else (
            jnp.asarray(pvec[:, None]), torch.from_numpy(pvec[:, None])))
    want, wcache = exact(jattn.mla_apply, jp["attn"], xj, jc,
                         jnp.asarray(positions), jd, **jkw)
    got, gcache = tattn.mla_apply(tp, xt, tc, torch.from_numpy(positions),
                                  td, **tkw)
    assert got.dtype == td
    close(got, want, TOL[dt])
    if mode == "full":
        assert gcache is None and wcache is None
    else:
        for name in ("ckv", "k_rope"):
            assert gcache[name].shape == wcache[name].shape
            close(gcache[name], wcache[name], TOL[dt])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_case(dt, t, **overrides):
    jc, tc = in_dtype(*smoke("granite-moe-1b-a400m"), dt)
    jc = dataclasses.replace(jc, **overrides)
    tc = dataclasses.replace(tc, **overrides)
    jp = jmoe.moe_init(jax.random.PRNGKey(3), jc)
    tp = port_params(torch_tree(jp), dt)
    x = np.random.default_rng(10).normal(0, 1, (2, t // 2, jc.d_model))
    return jc, tc, jp, tp, *pair(x, dt)


@pytest.mark.parametrize("dt", [F32, BF16])
def test_route(dt):
    jc, tc, jp, tp, xj, xt = _moe_case(dt, 64)
    wv, wi = jmoe._route(jp, xj, jc)
    gv, gi = tmoe._route(tp, xt, tc)
    assert tp["router"].dtype == torch.float32 and gv.dtype == torch.float32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    close(gv, wv, TOL[F32])


@pytest.mark.parametrize("dt", [F32, BF16])
def test_moe_dense_apply(dt, bf16_dots):
    jc, tc, jp, tp, xj, xt = _moe_case(dt, 16)
    jd, td = dtypes(dt)
    want = jmoe.moe_apply(jp, xj, jc, jd)       # t = 16 takes the dense path
    got = tmoe.moe_apply(tp, xt, tc, td)
    assert got.dtype == td
    close(got, want, TOL[dt])
    close(tmoe.moe_dense_apply(tp, xt, tc, td), want, TOL[dt])


@pytest.mark.parametrize("dt", [F32, BF16])
def test_moe_capacity_path_drops_as_the_reference(dt, monkeypatch,
                                                  bf16_dots):
    """t = 1024 in two groups of 512 at capacity factor 1.0 (cap 256 rows
    an expert): some picks overflow, and the port keeps exactly the
    reference's picks in exactly its buffer rows (its dispatch one-hots,
    read where it hands them to ``shard_as``)."""
    jc, tc, jp, tp, xj, xt = _moe_case(dt, 1024, moe_capacity_factor=1.0)
    jd, td = dtypes(dt)
    seen = []

    def spy(x, *axes):
        seen.append(x)
        return x
    monkeypatch.setattr(jmoe, "shard_as", spy)
    want = jmoe.moe_apply(jp, xj, jc, jd)
    got = tmoe.moe_apply(tp, xt, tc, td)
    close(got, want, TOL[dt])
    g, tg, e, k = 2, 512, tc.num_experts, tc.moe_top_k
    cap = 256
    assert seen[0].shape == (g, tg, e, cap)
    _, gate_idx = tmoe._route(tp, xt.reshape(g, tg, -1), tc)
    pos, keep = tmoe.capacity_slots(gate_idx, e, cap)
    disp = torch.zeros(g, tg, e, cap)
    gg, tt, ss = torch.nonzero(keep, as_tuple=True)
    disp[gg, tt, gate_idx[gg, tt, ss], pos[gg, tt, ss]] = 1
    np.testing.assert_array_equal(disp.numpy(),
                                  np.asarray(seen[0], np.float32))
    dropped = int((~keep).sum())
    assert 0 < dropped < g * tg * k


def test_moe_token_count_that_does_not_split_raises():
    jc, tc, jp, tp, xj, xt = _moe_case(F32, 1026)
    x = xt.reshape(1, 1026, -1)[:, :1025]
    with pytest.raises(ValueError, match="t=1025 does not split"):
        jmoe.moe_apply(jp, jnp.asarray(x.numpy()), jc, jnp.float32)
    with pytest.raises(ValueError, match="t=1025 does not split"):
        tmoe.moe_apply(tp, x, tc, torch.float32)


def test_aux_load_balance_loss():
    rng = np.random.default_rng(11)
    logits = rng.normal(0, 1, (40, 6)).astype(np.float32)
    idx = rng.integers(0, 6, (40, 2)).astype(np.int32)
    want = jmoe.aux_load_balance_loss(jnp.asarray(logits), jnp.asarray(idx), 6)
    got = tmoe.aux_load_balance_loss(torch.from_numpy(logits),
                                     torch.from_numpy(idx), 6)
    close(got, want, TOL[F32])


# ---------------------------------------------------------------------------
# Mamba-2
# ---------------------------------------------------------------------------

def _mamba_case(dt):
    jc, tc = in_dtype(*smoke("mamba2-2.7b"), dt)
    jp = perturbed({"mamba": jm2.mamba_init(jax.random.PRNGKey(4), jc)})
    return jc, tc, jp["mamba"], port_params(torch_tree(jp["mamba"]), dt)


@pytest.mark.parametrize("dt", [F32, BF16])
def test_causal_conv(dt):
    jc, tc, jp, tp = _mamba_case(dt)
    jd, td = dtypes(dt)
    xj, xt = pair(np.random.default_rng(12).normal(0, 1, (2, 9, 256)), dt)
    want = jm2._causal_conv(xj, jp["conv_w_x"], jp["conv_b_x"], jd)
    got = tm2._causal_conv(xt, tp["conv_w_x"], tp["conv_b_x"], td)
    assert got.dtype == td
    close(got, want, TOL[dt])


def test_segsum():
    x = np.random.default_rng(13).normal(0, 1, (2, 3, 7)).astype(np.float32)
    want = np.asarray(jm2._segsum(jnp.asarray(x)))
    got = tm2._segsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    close(got[fin], want[fin], TOL[F32])


@pytest.mark.parametrize("dt", [F32, BF16])
def test_ssd_chunked_two_chunks(dt):
    rng = np.random.default_rng(14)
    b, s, h, p, n = 2, 256, 4, 32, 16
    jd, td = dtypes(dt)
    xj, xt = pair(rng.normal(0, 1, (b, s, h, p)), dt)
    dtv = np.log1p(np.exp(rng.normal(-1, 1, (b, s, h)))).astype(np.float32)
    A = -np.arange(1, h + 1, dtype=np.float32) / 4
    bj, bt = pair(rng.normal(0, 1, (b, s, n)), dt)
    cj, ct = pair(rng.normal(0, 1, (b, s, n)), dt)
    wy, wst = jm2.ssd_chunked(xj, jnp.asarray(dtv), jnp.asarray(A), bj, cj,
                              128, edt=jd)
    gy, gst = tm2.ssd_chunked(xt, torch.from_numpy(dtv), torch.from_numpy(A),
                              bt, ct, 128, edt=td)
    assert gy.dtype == td and gst.dtype == torch.float32
    close(gy, wy, TOL[dt])
    close(gst, wst, TOL[dt])


def test_ssd_chunked_raises_off_the_chunk():
    x = torch.zeros(1, 200, 2, 4)
    with pytest.raises(ValueError, match="seq_len=200 is not a multiple"):
        tm2.ssd_chunked(x, torch.ones(1, 200, 2), -torch.ones(2),
                        torch.zeros(1, 200, 3), torch.zeros(1, 200, 3), 128)
    with pytest.raises(ValueError, match="seq_len=200 is not a multiple"):
        jm2.ssd_chunked(jnp.zeros((1, 200, 2, 4)), jnp.ones((1, 200, 2)),
                        -jnp.ones(2), jnp.zeros((1, 200, 3)),
                        jnp.zeros((1, 200, 3)), 128)


@pytest.mark.parametrize("dt", [F32, BF16])
def test_mamba_apply_state_and_conv_tail(dt):
    """Two chunks of 128: the output, the final SSM state and the conv
    tails; then one recurrent step from that state."""
    jc, tc, jp, tp = _mamba_case(dt)
    jd, td = dtypes(dt)
    rng = np.random.default_rng(15)
    xj, xt = pair(rng.normal(0, 1, (2, 256, jc.d_model)), dt)
    want, (wst, (wcx, wcbc)) = exact(jm2.mamba_apply, jp, xj, jc, jd)
    got, (gst, (gcx, gcbc)) = tm2.mamba_apply(tp, xt, tc, td)
    close(got, want, TOL[dt])
    close(gst, wst, TOL[dt])
    for g, w in ((gcx, wcx), (gcbc, wcbc)):
        assert g.shape == w.shape == (2, tm2.CONV_W - 1, g.shape[-1])
        close(g, w, TOL[dt])
    # one decode step from the captured state
    hj, ht = pair(rng.normal(0, 1, (2, 1, jc.d_model)), dt)
    jstate = {"ssm": wst, "conv_x": wcx.astype(jnp.float32),
              "conv_bc": wcbc.astype(jnp.float32)}
    tstate = {"ssm": torch.from_numpy(np.asarray(wst)),
              "conv_x": torch.from_numpy(np.asarray(wcx, np.float32)),
              "conv_bc": torch.from_numpy(np.asarray(wcbc, np.float32))}
    wout, wnext = exact(jm2.mamba_decode_step, jp, hj, jstate, jc, jd)
    gout, gnext = tm2.mamba_decode_step(tp, ht, tstate, tc, td)
    close(gout, wout, TOL[dt])
    for name in ("ssm", "conv_x", "conv_bc"):
        assert gnext[name].dtype == torch.float32
        close(gnext[name], wnext[name], TOL[dt])


# ---------------------------------------------------------------------------
# Whisper encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", [F32, BF16])
def test_encode(dt):
    jc, tc, jp, tp = carried("whisper-large-v3")
    jc, tc = in_dtype(jc, tc, dt)
    fj, ft = pair(_frames(jc, 2, seed=16), dt)
    want = exact(JM._encode, jc, jp, fj)
    got = TM._encode(tc, port_params(tp, dt), ft)
    assert got.shape == (2, jc.encoder_seq, jc.d_model)
    close(got, want, TOL[dt])


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def _frames(cfg, b, seed=5):
    return np.random.default_rng(seed).normal(
        0, 1, (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def carried(arch):
    """(JAX config, port config, JAX params, port params) on the same
    weights."""
    jc, tc = smoke(arch)
    jp = perturbed(JM.init(jc, jax.random.PRNGKey(0)))
    return jc, tc, jp, convert.lm_params_from_numpy(tc, flat(jp),
                                                    device="cpu")


def _batch(cfg, toks, frames, lib):
    batch = {"tokens": toks}
    if cfg.is_encdec:
        batch["enc_frames"] = frames
    return batch if lib == "torch" else {k: jnp.asarray(v)
                                         for k, v in batch.items()}


def _vector_pos(t):
    return np.array([[t], [t - 7]], np.int32)


@functools.lru_cache(maxsize=None)
def reference_runs(arch):
    """The reference's forward logits, prefill logits and cache, and
    scalar- and vector-pos decode logits and caches on (2, 16) tokens:
    prefill 12, then decode tokens 12..15 at positions 12..15 (scalar) or
    [12 + t, 5 + t] (vector)."""
    jc, _, jp, _ = carried(arch)
    b, s, half, smax = 2, 16, 12, 24
    toks = _tokens(jc, b, s, seed=1)
    frames = _frames(jc, b) if jc.is_encdec else None
    full, _ = exact(JM.forward, jc, jp, _batch(jc, toks, frames, "jax"))
    plog, cache = exact(JM.forward, jc, jp,
                        _batch(jc, toks[:, :half], frames, "jax"),
                        make_cache_len=smax)
    out = dict(tokens=toks, frames=frames, full=np.asarray(full),
               prefill=np.asarray(plog), cache=jax.tree.map(np.asarray, cache))
    for kind in ("scalar", "vector"):
        c, logs = cache, []
        for t in range(half, s):
            pos = jnp.int32(t) if kind == "scalar" else jnp.asarray(
                _vector_pos(t))
            lg, c = exact(JM.decode_step, jc, jp,
                          jnp.asarray(toks[:, t:t + 1]), c, pos)
            logs.append(np.asarray(lg))
        out[kind] = (np.concatenate(logs, 1), jax.tree.map(np.asarray, c))
    return out


def cache_close(got, want, cfg, rel):
    """Every leaf of the port's cache against the reference's (group axis
    unstacked), and the encoder output."""
    P = len(cfg.pattern)
    assert len(got["blocks"]) == cfg.num_layers
    for layer, lc in enumerate(got["blocks"]):
        ref = jax.tree.map(lambda a: a[layer // P],
                           want["blocks"][f"l{layer % P}"])
        assert sorted(lc) == sorted(ref)
        for part in lc:
            assert sorted(lc[part]) == sorted(ref[part])
            for name in lc[part]:
                g, w = lc[part][name], ref[part][name]
                assert g.shape == w.shape, (layer, part, name)
                close(g, w, rel)
    if want["enc_out"] is None:
        assert got["enc_out"] is None
    else:
        close(got["enc_out"], want["enc_out"], rel)


def _port_prefill(arch, half=12, smax=24):
    _, tc, _, tp = carried(arch)
    ref = reference_runs(arch)
    batch = _batch(tc, torch.from_numpy(ref["tokens"][:, :half]),
                   None if ref["frames"] is None
                   else torch.from_numpy(ref["frames"]), "torch")
    return TM.forward(tc, tp, batch, make_cache_len=smax)


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_matches_reference(arch):
    _, tc, _, tp = carried(arch)
    ref = reference_runs(arch)
    batch = _batch(tc, torch.from_numpy(ref["tokens"]),
                   None if ref["frames"] is None
                   else torch.from_numpy(ref["frames"]), "torch")
    logits, none = TM.forward(tc, tp, batch)
    assert none is None and logits.shape == (2, 16, tc.padded_vocab)
    close(logits, ref["full"], TOL[F32])


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_cache_matches_reference(arch):
    jc, _, _, _ = carried(arch)
    ref = reference_runs(arch)
    logits, cache = _port_prefill(arch)
    close(logits, ref["prefill"], TOL[F32])
    cache_close(cache, ref["cache"], jc, TOL[F32])


@pytest.mark.parametrize("kind", ["scalar", "vector"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_step_matches_reference(arch, kind):
    jc, tc, _, tp = carried(arch)
    ref = reference_runs(arch)
    toks = torch.from_numpy(ref["tokens"])
    _, cache = _port_prefill(arch)
    logs = []
    for t in range(12, 16):
        pos = t if kind == "scalar" else torch.from_numpy(_vector_pos(t))
        lg, cache = TM.decode_step(tc, tp, toks[:, t:t + 1], cache, pos)
        logs.append(lg)
    want_logits, want_cache = ref[kind]
    close(torch.cat(logs, 1), want_logits, TOL[F32])
    cache_close(cache, want_cache, jc, TOL[F32])


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_bf16_matches_reference(arch, bf16_dots):
    """The serving dtype: bf16 compute and cache, weights as their bf16
    copies (the router and Mamba-2's A_log, D and dt_bias stay float32) on
    the port's side, cast at use on the reference's; a prefill of 8 and
    two per-slot decode steps."""
    jc, tc, jp, tp = carried(arch)
    jc, tc = in_dtype(jc, tc, BF16)
    tp = TM.cast_weights(tp, torch.bfloat16)
    kept = []
    TM._map(tp, lambda name, t: kept.append(t.dtype) if name in (
        "router", "A_log", "D", "dt_bias") else None)
    assert all(d == torch.float32 for d in kept)
    toks = _tokens(jc, 2, 10, seed=3)
    frames = _frames(jc, 2) if jc.is_encdec else None
    gl, gc = TM.forward(tc, tp, _batch(tc, torch.from_numpy(toks[:, :8]),
                                       None if frames is None
                                       else torch.from_numpy(frames),
                                       "torch"), make_cache_len=16)
    wl, wc = exact(JM.forward, jc, jp, _batch(jc, toks[:, :8], frames, "jax"),
                   make_cache_len=16)
    close(gl, wl.astype(jnp.float32), TOL[BF16])
    for t in (8, 9):
        pv = np.array([[t], [t - 5]], np.int32)
        wd, wc = exact(JM.decode_step, jc, jp, jnp.asarray(toks[:, t:t + 1]),
                       wc, jnp.asarray(pv))
        gd, gc = TM.decode_step(tc, tp, torch.from_numpy(toks[:, t:t + 1]),
                                gc, torch.from_numpy(pv))
        assert gd.dtype == torch.bfloat16
        close(gd, wd.astype(jnp.float32), TOL[BF16])


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_decode_matches_forward(arch):
    """Port mirror of the reference's test: teacher-forced decode through
    the cache (KV, latent or SSM state) reproduces the full forward
    logits."""
    cfg = ARCHS[arch].smoke_config()
    params = TM.init(cfg, torch.Generator().manual_seed(0))
    b, s = 2, 16
    toks = torch.from_numpy(_tokens(cfg, b, s, seed=1))
    frames = (torch.from_numpy(_frames(cfg, b)) if cfg.is_encdec else None)
    full, _ = TM.forward(cfg, params, _batch(cfg, toks, frames, "torch"))
    half = s // 2
    _, cache = TM.forward(cfg, params,
                          _batch(cfg, toks[:, :half], frames, "torch"),
                          make_cache_len=s)
    outs = []
    for t in range(half, s):
        lg, cache = TM.decode_step(cfg, params, toks[:, t:t + 1], cache, t)
        outs.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), full[:, half:],
                               rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _served_params(arch, seed):
    jc, tc = smoke(arch)
    return convert.lm_params_from_numpy(
        tc, flat(JM.init(jc, jax.random.PRNGKey(seed))), device="cpu")


@pytest.mark.parametrize("deadline", [None, 3])
@pytest.mark.parametrize("arch", SERVED)
def test_serve_matches_reference_stream(arch, deadline):
    """The same requests, prompts and weights: the same greedy tokens per
    rid and the same evictions; an evicted request re-prefills its prompt
    and tokens into a slot (every cache leaf, SSM state included)."""
    kw = dict(requests=3, batch=2, max_new=6, prompt_len=5, max_len=32,
              quiet=True, seed=1, max_rounds=deadline, max_evictions=10)
    want = {r.rid: (r.out, r.evictions) for r in jserve.serve(arch, **kw)}
    got = {r.rid: (r.out, r.evictions)
           for r in serve(arch, params=_served_params(arch, 1), device="cpu",
                          **kw)}
    assert got == want
    if deadline:
        assert any(ev > 0 for _, ev in got.values())


def test_splice_refuses_a_cache_of_another_shape():
    cfg = ARCHS["mamba2-2.7b"].smoke_config()
    full = TM.init_cache(cfg, 2, 16)
    short = {"blocks": [{"ssm": {**c["ssm"],
                                 "conv_x": c["ssm"]["conv_x"][:1, :2]}}
                        for c in TM.init_cache(cfg, 1, 16)["blocks"]]}
    with pytest.raises(ValueError, match="does not fit a slot"):
        TM.splice(full, short, 1)


# ---------------------------------------------------------------------------
# parameter counts and the converter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_param_count_matches_reference(arch):
    n = ARCHS[arch].CONFIG.param_count()
    jcfg = JARCHS[arch].CONFIG
    shapes = jax.eval_shape(lambda k: JM.init(jcfg, k),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    assert n == sum(int(np.prod(x.shape, dtype=object))
                    for x in jax.tree.leaves(shapes))
    biggest = max(int(np.prod(x.shape, dtype=object))
                  for x in jax.tree.leaves(shapes))
    if biggest < 2 ** 31:     # the reference's int32 product does not wrap
        assert n == jcfg.param_count()


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_converter_round_trip(arch):
    jc, tc = smoke(arch)
    fl = flat(JM.init(jc, jax.random.PRNGKey(0)))
    tp = convert.lm_params_from_numpy(tc, fl, device="cpu")
    back = convert.lm_params_to_numpy(tc, tp)
    assert sorted(back) == sorted(fl)
    for k in fl:
        np.testing.assert_array_equal(back[k], fl[k])
    again = convert.lm_params_from_numpy(tc, back, device="cpu")
    meta = TM.init(tc, device="meta")
    assert len(TM.leaves(again)) == len(TM.leaves(meta))
    for a, b, m in zip(TM.leaves(again), TM.leaves(tp), TM.leaves(meta)):
        assert torch.equal(a, b) and a.shape == m.shape
