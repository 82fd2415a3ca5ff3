"""The port's feature-tap API, FIA's aggregate feature gradient and YAILA's
ridge fit against the JAX package.

One set of seeded weights in both packages (``toy_cnn`` and the narrow
Bottleneck ResNet at 32², fp32 on the CPU).  ``Surrogate.features`` and
its users (``feature``, ``apply(tap_fns=...)``, ``apply_with_feats``,
``feature_shape``) against JAX's ``Surrogate``; the feature gradient the
port takes with ``torch.autograd.grad`` at the hooked activation against
JAX's zero-offset probe, to ``1e-5·max|ref|``; and ``yaila_calculate_w``
(``torch.linalg.solve``) against JAX's (``jnp.linalg.solve``) to 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transferattack_tpu as ta
import transferattack_torch as tt
from test_torch_port_input_ops import T, close
from test_torch_port_models import narrow_bottleneck_pair, registry_pair
from transferattack_tpu.advanced_objective import cfm as jcfm
from transferattack_tpu.models import find_feature as jfind
from transferattack_torch.advanced_objective import cfm as tcfm
from transferattack_torch.models import find_feature, tap_key

# (reference name of a stage, JAX key of a block) each model has
TAPS = {"toy_cnn": ("layer2", "stage1"), "narrow_bottleneck": ("layer3", "layer2_0")}


@pytest.fixture(scope="module", params=["toy_cnn", "narrow_bottleneck"])
def pair(request):
    if request.param == "toy_cnn":
        return request.param, registry_pair("toy_cnn", seed=4)
    return request.param, narrow_bottleneck_pair(seed=4)


def images(seed=2, n=4):
    return np.random.RandomState(seed).rand(n, 32, 32, 3).astype(np.float32)


@pytest.fixture(scope="module")
def jax_feats(pair):
    """JAX's logits and every stage's feature (and, on the narrow Bottleneck,
    a block's) of one batch, from one jitted ``apply_with_feats`` each."""
    model, (js, _, _) = pair
    x = images(4)
    run = jax.jit(js.apply_with_feats, static_argnums=2)
    logits, feats = run(js.variables, jnp.asarray(x), "stage")
    out = {k: jfind(feats, k) for k in ("stage1", "stage2", "stage3", "stage4")
           if jfind(feats, k) is not None}
    if model == "narrow_bottleneck":
        out["layer2_0"] = jfind(run(js.variables, jnp.asarray(x), "layer2_0")[1], "layer2_0")
    return x, logits, out


def test_feature_and_its_shape_match_jax(pair, jax_feats):
    """``feature`` at a tap in either naming, and ``feature_shape``."""
    model, (js, ts, _) = pair
    x, jl, jf = jax_feats
    for layer in TAPS[model]:
        tl, tf = ts.feature(T(x), layer)
        close(tl, jl, 1e-4)
        close(tf, jf[tap_key(layer)], 1e-4)
        assert ts.feature_shape(x.shape, layer) == tuple(js.feature_shape(x.shape, layer))


def test_tap_fns_mix_matches_jax(pair):
    """A tap function that mixes the live feature with a fixed one, as
    ILPD's and CFM's do: logits and the input gradient of a loss."""
    model, (js, ts, _) = pair
    x = images(3)
    layer = TAPS[model][1]
    clean = np.random.RandomState(5).rand(*ts.feature_shape(x.shape, layer)).astype(np.float32)

    def jloss(a):
        lg = js.apply(js.variables, a, tap_fns={layer: lambda f: 0.3 * f + 0.7 * clean})
        return jnp.sum(lg * jnp.arange(lg.shape[-1])), lg

    (_, jl), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(x))
    tx = T(x).requires_grad_(True)
    tl = ts.apply(tx, tap_fns={layer: lambda f: 0.3 * f + 0.7 * T(clean)})
    (tl * torch.arange(tl.shape[-1])).sum().backward()
    close(tl, jl, 1e-4)
    close(tx.grad, jg, 1e-4)


def test_apply_with_feats_matches_jax(pair, jax_feats):
    """Every stage tap, and one block with the stages (YAILA's forward)."""
    model, (_, ts, _) = pair
    x, jl, jf = jax_feats
    tl, tfeats = ts.apply_with_feats(T(x), "stage")
    close(tl, jl, 1e-4)
    stages = sorted(tfeats)
    assert stages == sorted(k for k in jf if k.startswith("stage")) and len(stages) >= 2
    for k in stages:
        close(tfeats[k], jf[k], 1e-4)
    if model == "narrow_bottleneck":
        block = TAPS[model][1]
        _, tfeats = ts.apply_with_feats(T(x), ("stage", block))
        assert sorted(tfeats) == [block] + stages
        close(find_feature(tfeats, block), jf[block], 1e-4)
        assert find_feature(tfeats, "layer9_0") is None


def fia_pair(pair, masks, **kw):
    """FIA in both packages, its dropout copies from ``masks``."""
    _, (js, ts, _) = pair
    jcls = type("FIA", (ta.load_attack_class("fia"),),
                {"perturb_input": lambda self, x, k, i: x * jnp.asarray(masks)[i]})
    tcls = type("FIA", (tt.load_attack_class("fia"),),
                {"perturb_input": lambda self, x, g, i: x * T(masks)[i]})
    return jcls(model_name=js, **kw), tcls(model_name=ts, device="cpu", **kw)


def test_fia_aggregate_feature_gradient_matches_jax_offset_probe(pair):
    """FIA's aggregate, over three dropout copies, of the feature gradient of
    the label's probability: ``autograd.grad`` at the hooked activation
    against JAX's gradient at a zero offset added there."""
    model, _ = pair
    x = images(6)
    y = np.random.RandomState(6).randint(0, 10, size=4)
    masks = (np.random.RandomState(7).rand(3, *x.shape) > 0.3).astype(np.float32)
    jatk, tatk = fia_pair(pair, masks, num_ens=3, feature_layer=TAPS[model][0])
    agg = jax.jit(jatk.aggregate_grad)(jatk.model.variables, jnp.asarray(x), jnp.asarray(y),
                                        jax.random.PRNGKey(0))
    close(tatk.aggregate_grad(T(x), T(y), None), agg)
    assert tatk.grad_evals == 3


def test_yaila_ridge_fit_matches_jax():
    rng = np.random.RandomState(8)
    H = rng.randn(3, 10, 257).astype(np.float32)
    r = rng.rand(3, 10, 1).astype(np.float32) * 5
    close(tcfm.yaila_calculate_w(T(H), T(r), 1.0),
          jcfm.yaila_calculate_w(jnp.asarray(H), jnp.asarray(r), 1.0))
