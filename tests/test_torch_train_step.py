"""The port's LM train step (``repro_torch.models.steps``) against the JAX
package's on the CPU, for the dense attention configurations at the smoke
size, and MiniCPM3's MLA (``tests/test_torch_train_step_families.py`` and
``test_torch_train_step_jamba.py`` hold the other five):
the reference's own weights (``repro.models.model.init`` at PRNGKey(0),
biases and scales perturbed) and optimizer state carried across by
``convert.train_state_from_numpy``, the same numpy batch.

Tolerances, of each leaf's largest magnitude (float32): loss rel 1e-5;
grads 1e-4 against ``jax.value_and_grad(steps.loss_fn)``.  One full step
against the reference's jitted step:

- the grad norm within 1e-6 of the float64 norm of the reference's own
  grads; the jitted reference sums the squared grads in float32 in an
  order that loses up to 5.1e-4 of the norm on these models, so the two
  metrics are held to 1e-3 of each other;
- the optimizer statistics as each side's clip scale left them, divided
  by that scale (squared for the second moments) — 1e-4 for AdamW's first
  moment, 2e-4 for the statistics of squared grads (twice the grads'
  relative error);
- the parameters 1e-4, except at elements whose reference grad is below
  1e-3 of its leaf's largest: the first step divides a grad by statistics
  of its own size (AdamW's m/√v, Adafactor's column statistics), so there
  a last-bit difference in the grad moves the update by up to its whole
  size, and the element is held to 4·lr of the reference's."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import steps as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import steps as TS  # noqa: E402
from test_torch_lm_families import perturbed  # noqa: E402

DENSE = ["qwen3-4b", "qwen1.5-110b", "nemotron-4-340b", "qwen2-vl-7b",
         "minicpm3-4b"]
LR = 1e-3
ROWS, SEQ = 2, 16


@pytest.fixture(autouse=True)
def _few_threads():
    """Tiny ops: more threads than cores only thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def ref_flat(tree):
    """The reference tree as {``/``-joined path: numpy array}
    (NamedTuple fields by name)."""
    def key(k):
        for a in ("key", "name", "idx"):
            if hasattr(k, a):
                return str(getattr(k, a))
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(key(k) for k in p): np.asarray(v) for p, v in leaves}


def leaf_close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err, tol)


def batch_pair(cfg, rows=ROWS, seq=SEQ, seed=3):
    """(JAX batch, port batch) of the same tokens and labels (and the
    encoder frames, and M-RoPE's positions, where the config takes
    them)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (rows, seq + 1)).astype(np.int32)
    arrs = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_encdec:
        arrs["enc_frames"] = rng.standard_normal(
            (rows, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.mrope:
        pos = np.broadcast_to(np.arange(seq), (rows, seq))
        arrs["positions3"] = np.ascontiguousarray(
            np.broadcast_to(pos[:, None, :], (rows, 3, seq))).astype(np.int32)
    jb = {k: jnp.asarray(v) for k, v in arrs.items()}
    tb = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                              else v.copy()) for k, v in arrs.items()}
    return jb, tb


@functools.lru_cache(maxsize=None)
def carried(arch, **overrides):
    """(JAX config, port config, JAX TrainState, flat numpy state): the
    reference's init at PRNGKey(0), perturbed, and its optimizer state."""
    jc = dataclasses.replace(JARCHS[arch].smoke_config(), **overrides)
    tc = dataclasses.replace(ARCHS[arch].smoke_config(), **overrides)
    st = JS.init_train_state(jc, jax.random.PRNGKey(0))
    st = st._replace(params=perturbed(st.params))
    return jc, tc, st, ref_flat(st)


def port_state(arch, **overrides):
    """A fresh port TrainState from ``carried`` (steps update in place)."""
    _, tc, _, flat = carried(arch, **overrides)
    return convert.train_state_from_numpy(tc, flat, device="cpu")


@functools.lru_cache(maxsize=None)
def ref_grads(arch, rows=ROWS, seq=SEQ, **overrides):
    """The reference's loss and grads (``jax.value_and_grad``) on
    ``batch_pair``."""
    jc, _, st, _ = carried(arch, **overrides)
    jb, _ = batch_pair(jc, rows=rows, seq=seq)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: JS.loss_fn(jc, p, jb)))(st.params)
    return dict(loss=float(loss), grads=ref_flat(grads))


@functools.lru_cache(maxsize=None)
def ref_step(arch, grad_accum=1, rows=ROWS, **overrides):
    """The reference's jitted train step's state and metrics on
    ``batch_pair``."""
    jc, _, st, _ = carried(arch, **overrides)
    jb, _ = batch_pair(jc, rows=rows)
    state, metrics = jax.jit(JS.make_train_step(
        jc, lr=LR, grad_accum=grad_accum))(st, jb)
    return dict(state=ref_flat(state), loss=float(metrics["loss"]),
                gnorm=float(metrics["grad_norm"]))


def port_grads(arch, rows=ROWS, seq=SEQ, **overrides):
    _, tc, _, _ = carried(arch, **overrides)
    st = port_state(arch, **overrides)
    _, tb = batch_pair(tc, rows=rows, seq=seq)
    loss, grads = TS.loss_and_grads(tc, st.params, tb)
    return float(loss), convert.lm_params_to_numpy(
        tc, T.unflatten(st.params, grads))


def check_grads(arch, rows=ROWS, seq=SEQ, **overrides):
    ref = ref_grads(arch, rows=rows, seq=seq, **overrides)
    loss, grads = port_grads(arch, rows=rows, seq=seq, **overrides)
    assert abs(loss - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    assert sorted(grads) == sorted(ref["grads"])
    for k, g in grads.items():
        leaf_close(g, ref["grads"][k], 1e-4, k)


def clip_scale(gnorm):
    return min(1.0, 1.0 / max(gnorm, 1e-9))


def check_train_step(arch, grad_accum=1, rows=ROWS, **overrides):
    """One step against the reference's jitted step (with ``grad_accum``
    microbatches of the ``rows``: their mean grads are the whole batch's,
    as every row has as many labels)."""
    jc, tc, st, _ = carried(arch, **overrides)
    ref = ref_grads(arch, rows=rows, **overrides)
    step = ref_step(arch, grad_accum=grad_accum, rows=rows, **overrides)
    _, tb = batch_pair(tc, rows=rows)
    state, metrics = TS.make_train_step(tc, lr=LR, grad_accum=grad_accum)(
        port_state(arch, **overrides), tb)
    loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    assert metrics["loss"].dtype == metrics["grad_norm"].dtype == \
        torch.float32
    exact = np.sqrt(sum((np.asarray(g, np.float64) ** 2).sum()
                        for g in ref["grads"].values()))
    assert abs(gnorm - exact) <= 1e-6 * exact, (gnorm, exact)
    assert abs(loss - step["loss"]) <= 1e-5 * abs(step["loss"])
    assert abs(gnorm - step["gnorm"]) <= 1e-3 * exact
    got = convert.train_state_to_numpy(tc, state)
    assert sorted(got) == sorted(step["state"])
    assert int(got["step"]) == int(got["opt/count"]) == 1
    mine, theirs = clip_scale(gnorm), clip_scale(step["gnorm"])
    for k, want in step["state"].items():
        name = k.split("/")[1] if k.startswith("opt/") else None
        if name in ("mu",):
            leaf_close(got[k] / mine, want / theirs, 1e-4, k)
        elif name in ("nu", "vr", "vc", "v"):
            leaf_close(got[k] / mine ** 2, want / theirs ** 2, 2e-4, k)
        elif k.startswith("params/"):
            g = np.abs(ref["grads"][k[len("params/"):]])
            sharp = g >= 1e-3 * g.max()
            p, w = np.asarray(got[k], np.float64), np.asarray(want,
                                                              np.float64)
            err = np.abs(p - w)
            assert err[sharp].max(initial=0) <= 1e-4 * np.abs(w).max(), k
            assert err[~sharp].max(initial=0) <= 4 * LR, k


def check_grad_accum(arch):
    """``grad_accum=2`` over 4 rows against the reference's scan, on
    AdamW (whose first moment after one step is the clipped grad over
    10): the accumulated grads, the loss and the norm."""
    kw = dict(optimizer="adamw")
    _, tc, _, _ = carried(arch, **kw)
    ref = ref_step(arch, grad_accum=2, rows=4, **kw)
    _, tb = batch_pair(tc, rows=4)
    state, metrics = TS.make_train_step(tc, lr=LR, grad_accum=2)(
        port_state(arch, **kw), tb)
    loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    assert abs(loss - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    assert abs(gnorm - ref["gnorm"]) <= 1e-3 * gnorm
    got = convert.train_state_to_numpy(tc, state)
    for k, want in ref["state"].items():
        if k.startswith("opt/mu/"):
            leaf_close(got[k] / (0.1 * clip_scale(gnorm)),
                       want / (0.1 * clip_scale(ref["gnorm"])), 1e-4, k)


def check_remat_bit_identical(arch):
    """Per-group remat (``torch.utils.checkpoint``) gives the grads and one
    step's state of the run without it, bit for bit."""
    _, tc, _, _ = carried(arch)
    _, tb = batch_pair(tc)
    runs = []
    for remat in (False, True):
        cfg = dataclasses.replace(tc, remat=remat)
        st = port_state(arch)
        loss, grads = TS.loss_and_grads(cfg, st.params, tb)
        st, m = TS.make_train_step(cfg, lr=LR)(st, tb)
        runs.append([loss, m["grad_norm"], *grads, *T.leaves(st)])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def check_loss_falls(arch):
    """Mirror of tests/test_models.py:41: one step from the port's own
    init, then the loss falls over three more on the same batch."""
    cfg = ARCHS[arch].smoke_config()
    state = TS.init_train_state(cfg, torch.Generator().manual_seed(0))
    step = TS.make_train_step(cfg, lr=1e-3)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)))
    batch = {"tokens": toks, "labels": toks}
    if cfg.is_encdec:
        batch["enc_frames"] = torch.randn(2, cfg.encoder_seq, cfg.d_model,
                                          generator=torch.Generator()
                                          .manual_seed(1))
    if cfg.mrope:
        pos = torch.arange(32).expand(2, 32)
        batch["positions3"] = pos[:, None, :].expand(2, 3, 32)
    state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    assert np.isfinite(loss) and loss > 0
    assert int(state.step) == 1
    for _ in range(3):
        state, metrics = step(state, batch)
    assert float(metrics["loss"]) < loss


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_reference(arch):
    check_grads(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_train_step_matches_reference(arch):
    check_train_step(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_grad_accum_matches_reference(arch):
    check_grad_accum(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_remat_is_bit_identical(arch):
    check_remat_bit_identical(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_loss_falls(arch):
    check_loss_falls(arch)


def test_cross_entropy_matches_reference_and_ignores_minus_one():
    rng = np.random.default_rng(9)
    logits = rng.normal(0, 3, (2, 5, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (2, 5)).astype(np.int32)
    labels[0, 1] = labels[1, 4] = -1
    want = JS.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 40)
    got = TS.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(labels))
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    none = TS.cross_entropy(torch.from_numpy(logits),
                            torch.full((2, 5), -1))
    assert float(none) == 0.0


def test_prefill_and_decode_steps_match_the_model():
    from repro_torch.models import model as TM
    _, tc, _, _ = carried("qwen3-4b")
    params = port_state("qwen3-4b").params
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, tc.vocab_size, (2, 9)))
    last, cache = TS.make_prefill_step(tc, 12)(params, {"tokens": toks[:, :8]})
    full, _ = TM.forward(tc, params, {"tokens": toks})
    assert last.shape == (2, 1, tc.padded_vocab)
    leaf_close(last, full[:, 7:8].detach(), 1e-5)
    nxt, logits, _ = TS.make_decode_step(tc)(params, toks[:, 8:9], cache, 8)
    leaf_close(logits, full[:, 8:9].detach(), 1e-5)
    assert nxt.dtype == torch.int32 and torch.equal(
        nxt[:, 0], torch.argmax(logits[:, -1], -1).int())
