"""The port's optimizers, schedules and L1 prox (``repro_torch.optim``)
against the JAX package's on the CPU, and mirrors of tests/test_optim.py.

The parity cases run the reference's ``update`` on its stacked parameter
tree and the port's on its per-layer tree (``blocks`` a list of layer
dicts), with the same numpy parameters and grads, for 3 steps: a stacked
(G, d) norm scale (factored by the reference's Adafactor), a (G, d, f)
weight, a (G, E, d, f) expert leaf, an unstacked (V, d) matrix and a 1-D
leaf.  Tolerance rtol 1e-6 of each element, plus 1e-6 of its leaf's
largest magnitude (an element summed from terms of opposite signs)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import adafactor as jaf  # noqa: E402
from repro.optim import adamw as jaw  # noqa: E402
from repro.optim import prox as jprox  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.optim import adafactor, adamw, prox, schedule  # noqa: E402

G, E, D, F, V = 3, 2, 8, 6, 10


def close(got, want, rtol=1e-6):
    got = np.asarray(torch.as_tensor(got).double())
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


# ---------------------------------------------------------------------------
# mirrors of tests/test_optim.py
# ---------------------------------------------------------------------------

def _train(opt_mod, steps=200, lr=0.05, **kw):
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((64, 8)), dtype=torch.float32)
    w_true = torch.tensor(rng.standard_normal((8, 4)), dtype=torch.float32)
    y = x @ w_true
    params = {"w": torch.tensor(np.random.default_rng(0).standard_normal(
        (8, 4)), dtype=torch.float32), "b": torch.zeros(4)}
    state = opt_mod.init(params)

    def loss_of(p):
        return torch.mean((x @ p["w"] + p["b"] - y) ** 2)
    for _ in range(steps):
        ws = {k: v.detach().requires_grad_() for k, v in params.items()}
        grads = torch.autograd.grad(loss_of(ws), [ws["b"], ws["w"]])
        params, state, _ = opt_mod.update({"b": grads[0], "w": grads[1]},
                                          state, params, lr, **kw)
    return float(loss_of(params))


def test_adamw_minimizes():
    assert _train(adamw, weight_decay=0.0) < 0.05


def test_adafactor_minimizes():
    assert _train(adafactor) < 0.2


def test_adafactor_state_is_factored():
    st = adafactor.init({"w": torch.zeros(32, 16)})
    assert st.vr["w"].shape == (32,)
    assert st.vc["w"].shape == (16,)


def test_grad_clipping():
    g = {"a": torch.full((10,), 100.0)}
    clipped, norm = adamw.clip_by_global_norm(g, 1.0)
    assert float(norm) > 100
    np.testing.assert_allclose(float(adamw.global_norm(clipped)), 1.0,
                               rtol=1e-5)


def test_clip_scale_is_the_references():
    """min(1, max_norm / max(norm, 1e-9)) — not clip_grad_norm_'s
    max_norm / (norm + 1e-6)."""
    for norm in (0.0, 1e-12, 0.5, 3.0, 1e6):
        want = float(jnp.minimum(1.0, 2.0 / jnp.maximum(jnp.float32(norm),
                                                        1e-9)))
        got = float(adamw.clip_scale(torch.tensor(norm), 2.0))
        assert got == want, (norm, got, want)


def test_warmup_cosine_shape():
    f = schedule.warmup_cosine(1e-3, warmup_steps=10, total_steps=100)
    assert float(f(0)) == 0.0
    np.testing.assert_allclose(float(f(10)), 1e-3, rtol=1e-5)
    assert float(f(100)) < float(f(50)) < float(f(10))
    np.testing.assert_allclose(float(f(100)), 1e-4, rtol=1e-2)


def test_rsqrt_schedule():
    f = schedule.rsqrt(1e-3, warmup_steps=100)
    assert float(f(50)) < float(f(99))
    assert float(f(400)) < float(f(100))


def test_prox_l1_is_soft_threshold():
    x = {"p": torch.tensor([-2.0, -0.5, 0.0, 0.5, 2.0])}
    out = prox.prox_l1(x, lr=1.0, lam=1.0)
    np.testing.assert_allclose(out["p"].numpy(), [-1.0, 0.0, 0.0, 0.0, 1.0])
    np.testing.assert_allclose(float(prox.sparsity(out)), 2 / 5, rtol=1e-6)
    assert float(prox.l1_penalty(out)) == 2.0


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["constant", "warmup_cosine", "rsqrt"])
def test_schedules_equal_the_references_in_float32(name):
    """Each float32 value within one ulp of the reference's, called step
    by step: the port rounds its cos from float64, XLA's CPU cos is an ulp
    off the correctly rounded value at a few steps (fused under ``jit`` the
    reference moves by up to 3 ulps)."""
    args = {"constant": (3e-3,), "warmup_cosine": (3e-3, 7, 60),
            "rsqrt": (3e-3, 7)}[name]
    jf, tf = getattr(jsched, name)(*args), getattr(schedule, name)(*args)
    steps = np.arange(0, 80, dtype=np.int32)
    want = np.array([jf(jnp.int32(s)) for s in steps], np.float32)
    got = np.array([tf(torch.tensor(s, dtype=torch.int32)).item()
                    for s in steps], np.float32)
    assert tf(torch.tensor(3)).dtype == torch.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def _stacked_case(seed=0):
    """(reference params, port params, port stacks): the reference's tree
    stacked over G groups, the port's per layer."""
    rng = np.random.default_rng(seed)

    def nrm(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    ref = {"blocks": {"l0": {"norm": {"scale": 1 + 0.1 * nrm(G, D)},
                             "mlp": {"wi": nrm(G, D, F)},
                             "moe": {"wi": nrm(G, E, D, F)}}},
           "embed": nrm(V, D), "bias": nrm(F)}
    layers = [{"norm": {"scale": ref["blocks"]["l0"]["norm"]["scale"][g]},
               "mlp": {"wi": ref["blocks"]["l0"]["mlp"]["wi"][g]},
               "moe": {"wi": ref["blocks"]["l0"]["moe"]["wi"][g]}}
              for g in range(G)]
    port = T.map_tree(lambda a: torch.tensor(a),
                      {"blocks": layers, "embed": ref["embed"],
                       "bias": ref["bias"]})
    stacks = {"embed": (False, [("embed",)]), "bias": (False, [("bias",)])}
    for sub in (("norm", "scale"), ("mlp", "wi"), ("moe", "wi")):
        stacks["blocks/l0/" + "/".join(sub)] = (
            True, [("blocks", g) + sub for g in range(G)])
    return ref, port, stacks


def _ref_flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in leaves}


def _port_as_ref(port):
    """The port's per-layer tree stacked as the reference's, flat."""
    out = {"embed": port["embed"].numpy(), "bias": port["bias"].numpy()}
    for sub in (("norm", "scale"), ("mlp", "wi"), ("moe", "wi")):
        out["blocks/l0/" + "/".join(sub)] = np.stack(
            [T.get(layer, sub).numpy() for layer in port["blocks"]])
    return out


def _grads(step):
    ref, port, _ = _stacked_case(seed=100 + step)
    return ref, port


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_update_matches_reference_on_stacked_leaves(opt):
    ref, port, stacks = _stacked_case()
    jmod, tmod = (jaw, adamw) if opt == "adamw" else (jaf, adafactor)
    jp = jax.tree.map(jnp.asarray, ref)
    jst = jmod.init(jp)
    tst = adamw.init(port) if opt == "adamw" else adafactor.init(port,
                                                                 stacks)
    kw = {} if opt == "adamw" else {"stacks": stacks}
    lr = 0.05
    for step in range(3):
        # large grads on step 0 (the clip binds), small after (it does not)
        scale = 10.0 if step == 0 else 0.01
        gref, gport = _grads(step)
        gref = jax.tree.map(lambda a: jnp.asarray(a * scale), gref)
        gport = T.map_tree(lambda t: t * scale, gport)
        jp, jst, jn = jmod.update(gref, jst, jp, lr)
        port, tst, tn = tmod.update(gport, tst, port, lr, **kw)
        close(tn, jn)
        want, got = _ref_flat(jp), _port_as_ref(port)
        for k in want:
            close(got[k], want[k])
        assert int(tst.count) == int(jst.count) == step + 1
        if opt == "adamw":
            for name in ("mu", "nu"):
                w = _ref_flat(getattr(jst, name))
                g = _port_as_ref(getattr(tst, name))
                for k in w:
                    close(g[k], w[k])
        else:
            for name in ("vr", "vc", "v"):
                w = _ref_flat(getattr(jst, name))
                g = getattr(tst, name)
                assert sorted(g) == sorted(w)
                for k in w:
                    close(g[k], w[k])


def test_adafactor_stacked_statistics_shapes():
    """A per-layer norm scale is factored as the reference's (G, d) leaf:
    row statistics per layer, column statistics over the layers."""
    _, port, stacks = _stacked_case()
    st = adafactor.init(port, stacks)
    assert st.vr["blocks/l0/norm/scale"].shape == (G,)
    assert st.vc["blocks/l0/norm/scale"].shape == (D,)
    assert st.vr["blocks/l0/moe/wi"].shape == (G, E, D)
    assert st.vc["blocks/l0/moe/wi"].shape == (G, E, F)
    assert st.v["bias"].shape == (F,) and st.vr["bias"].shape == (1,)
    with pytest.raises(ValueError, match="cover"):
        adafactor.init(port, {k: v for k, v in stacks.items()
                              if k != "bias"})


def test_prox_matches_reference():
    rng = np.random.default_rng(4)
    ref = {"a": rng.normal(0, 1, (5, 7)).astype(np.float32),
           "b": rng.normal(0, 1, (9,)).astype(np.float32)}
    mask = {"a": rng.random((5, 7)) < 0.5, "b": rng.random(9) < 0.5}
    port = {"blocks": [{"a": torch.tensor(ref["a"])}],
            "b": torch.tensor(ref["b"]).to(torch.bfloat16)}
    tmask = {"blocks": [{"a": torch.tensor(mask["a"])}],
             "b": torch.tensor(mask["b"])}
    jref = {"a": jnp.asarray(ref["a"]),
            "b": jnp.asarray(ref["b"], jnp.bfloat16)}
    want = jprox.prox_l1(jref, 0.5, 1.2, jax.tree.map(jnp.asarray, mask))
    got = prox.prox_l1(port, 0.5, 1.2, tmask)
    assert got["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["blocks"][0]["a"].numpy(),
                                  np.asarray(want["a"]))
    np.testing.assert_array_equal(got["b"].float().numpy(),
                                  np.asarray(want["b"], np.float32))
    np.testing.assert_array_equal(
        prox.soft_threshold(torch.tensor([np.nan, -3.0, 0.1]), 1.0).numpy(),
        np.asarray(jprox.soft_threshold(jnp.asarray([np.nan, -3.0, 0.1]),
                                        1.0)))
    close(prox.l1_penalty(port), jprox.l1_penalty(jref))
    close(prox.sparsity(got), jprox.sparsity(want))
