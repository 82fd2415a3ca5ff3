"""The port's eval models against the JAX package's, on the CPU in fp32.

For each family (VGG-16, MobileNet-v2, Inception-v3, ViT, DeiT, PiT,
Visformer, Swin), two witnesses:

* **through the bridge**: one set of seeded numpy weights in the JAX flat
  layout loads into both packages (the port through
  ``transferattack_torch.utils.bridge``);
* **native load**: a seeded ``state_dict`` of the port's own module goes
  through the JAX converter (``torch_state_dict_to_flax``), which checks the
  port's module names against the rules the JAX package holds for torch
  checkpoints.  Visformer has no torch twin in the JAX tests, so this is the
  only witness for its names.  The native load runs once more with both
  models' variables rounded to bf16, as the CLI's ``--bf16`` eval does.

Logits must agree with ``atol=2e-4, rtol=1e-3`` (the bar of
``test_torch_port_models.py``).  The classes that take widths run narrow;
the others at their full width on the smallest input they take.  Full
widths at the native input sizes are marked ``slow``.  ``Preprocess``'s
resize branch is held against JAX's in both directions.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transferattack_tpu.models as jm
import transferattack_torch.models as tm
from test_torch_port_models import flatten, random_variables, unflatten
from transferattack_tpu.utils.convert import reconcile_with_module, torch_state_dict_to_flax
from transferattack_torch.utils.bridge import load_flat_variables


def _jax(module_name, cls, **kw):
    import importlib

    return getattr(importlib.import_module(f"transferattack_tpu.models.{module_name}"),
                   cls)(**kw)


def _port(module_name, cls, *args, **kw):
    import importlib

    return getattr(importlib.import_module(f"transferattack_torch.models.{module_name}"),
                   cls)(*args, **kw)


IMNET = (jm.IMAGENET_MEAN, jm.IMAGENET_STD)
INCEPTION = (jm.INCEPTION_MEAN, jm.INCEPTION_STD)
VIT_NARROW = dict(patch_size=16, dim=64, depth=2, num_heads=2, num_classes=10)
PIT_NARROW = dict(patch_size=4, stride=2, base_dims=(8, 8), depth=(2, 2), heads=(2, 4),
                  num_classes=10)
VISFORMER_NARROW = dict(init_channels=8, embed_dim=32, depths=(1, 1, 1), num_heads=2,
                        num_classes=10)
# three stages at 64²: windows of 4 with shifts at 16² and 8², one window
# covering the map (no shift) at 4²
SWIN_NARROW = dict(patch_size=4, embed_dim=32, depths=(2, 2, 2), num_heads=(2, 4, 8),
                   window_size=4, num_classes=10)


def vgg16(size):
    from transferattack_tpu.models.vgg import CFG16

    return (_jax("vgg", "VGG", cfg=CFG16, num_classes=10),
            _port("vgg", "VGG", CFG16, num_classes=10, img_size=size), IMNET)


# family -> (size) -> (JAX backbone, port backbone, (mean, std)), and its
# test input size
FAMILIES = {
    "vgg16": (vgg16, 32),
    "mobilenet_v2": (lambda size: (_jax("mobilenet", "MobileNetV2", num_classes=10),
                                   _port("mobilenet", "MobileNetV2", num_classes=10),
                                   IMNET), 32),
    "inception_v3": (lambda size: (_jax("inception", "InceptionV3", num_classes=10),
                                   _port("inception", "InceptionV3", num_classes=10),
                                   INCEPTION), 75),
    "vit": (lambda size: (_jax("vit", "VisionTransformer", **VIT_NARROW),
                          _port("vit", "VisionTransformer", img_size=size, **VIT_NARROW),
                          IMNET), 32),
    "deit": (lambda size: (_jax("vit", "VisionTransformer", distilled=True, **VIT_NARROW),
                           _port("vit", "VisionTransformer", distilled=True,
                                 img_size=size, **VIT_NARROW), IMNET), 32),
    "pit": (lambda size: (_jax("pit", "PiT", **PIT_NARROW),
                          _port("pit", "PiT", img_size=size, **PIT_NARROW), IMNET), 32),
    "visformer": (lambda size: (_jax("visformer", "Visformer", **VISFORMER_NARROW),
                                _port("visformer", "Visformer", img_size=size,
                                      **VISFORMER_NARROW), IMNET), 64),
    "swin": (lambda size: (_jax("swin", "SwinTransformer", **SWIN_NARROW),
                           _port("swin", "SwinTransformer", img_size=size, **SWIN_NARROW),
                           IMNET), 64),
}


@functools.lru_cache(maxsize=None)
def jax_apply(family, size):
    """The JAX family model's ``apply``, jitted once for both witnesses (one
    compile is faster than Flax's op-by-op dispatch on the CPU)."""
    backbone, _, (mean, std) = FAMILIES[family][0](size)
    return jax.jit(jm.WrappedModel(backbone=backbone, size=size, mean=mean, std=std).apply)


def jax_logits(family, size, variables, x):
    return np.asarray(jax_apply(family, size)(variables, jnp.asarray(x)))


def port_logits(backbone, size, mean_std, x, flat=None, state_dict=None, bf16=False):
    module = tm.WrappedModel(backbone, size, *mean_std)
    if flat is not None:
        load_flat_variables(module, flat)
    else:
        backbone.load_state_dict(state_dict)
    module.eval()
    if bf16:
        tm.round_variables_to_bf16(module)
    with torch.no_grad():
        return module(torch.from_numpy(x)).numpy()


def seeded_state_dict(module, seed):
    """The port module's ``state_dict`` filled from a seed: kernels at
    lecun-normal scale, norms and BatchNorm statistics off the identity,
    small biases and embeddings."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in module.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            out[k] = v
            continue
        if k.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif k.endswith("running_mean"):
            a = rng.normal(0, 0.05, shape)
        elif k.endswith("weight") and len(shape) >= 2:
            a = rng.normal(0, 1 / np.sqrt(np.prod(shape[1:])), shape)
        elif k.endswith("weight"):
            a = rng.normal(1.0, 0.1, shape)
        else:  # biases, tokens, position embeddings, relative position bias
            a = rng.normal(0, 0.05, shape)
        out[k] = torch.from_numpy(a.astype(np.float32))
    return out


def _input(size, seed):
    return np.random.RandomState(seed).rand(2, size, size, 3).astype(np.float32)


def check_bridge(family, size, seed=0):
    jb, tb, ms = FAMILIES[family][0](size)
    flat = random_variables(jm.WrappedModel(backbone=jb, size=size, mean=ms[0],
                                            std=ms[1]), size, seed)
    x = _input(size, seed + 1)
    np.testing.assert_allclose(port_logits(tb, size, ms, x, flat=flat),
                               jax_logits(family, size, unflatten(flat), x),
                               atol=2e-4, rtol=1e-3)


def check_native(family, size, seed=2, bf16=False):
    """``bf16``: both models' variables rounded to bf16, JAX's as its CLI's
    ``--bf16`` eval casts them."""
    jb, tb, ms = FAMILIES[family][0](size)
    sd = seeded_state_dict(tb, seed)
    converted = torch_state_dict_to_flax(sd)
    reference = unflatten(random_variables(
        jm.WrappedModel(backbone=jb, size=size, mean=ms[0], std=ms[1]), size))
    variables, report = reconcile_with_module(converted, reference)
    assert not report["missing"], report["missing"][:8]
    assert not report["mismatched"], report["mismatched"][:8]
    assert set(flatten(converted)) == set(flatten(reference)), "unused converted keys"
    if bf16:
        variables = jax.tree.map(
            lambda v: v.astype(jnp.bfloat16) if v.dtype == jnp.float32 else v, variables)
    x = _input(size, seed + 1)
    np.testing.assert_allclose(port_logits(tb, size, ms, x, state_dict=sd, bf16=bf16),
                               jax_logits(family, size, variables, x),
                               atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_logits_match_jax_through_the_bridge(family):
    check_bridge(family, FAMILIES[family][1])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_native_state_dict_converts_to_the_jax_model(family):
    check_native(family, FAMILIES[family][1])


# the families with BatchNorm, whose multiplier is bf16 arithmetic under
# ``--bf16`` (ResNet's is in test_torch_port_cli.py), and one without
@pytest.mark.parametrize("family", ["inception_v3", "mobilenet_v2", "visformer", "vit"])
def test_bf16_eval_variables_match_jax(family):
    """The eval model under ``--bf16``, off-identity BN statistics included."""
    check_native(family, FAMILIES[family][1], bf16=True)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["vgg16", "inception_v3", "vit_base_patch16_224"])
def test_full_width_registry_model_matches_jax(name):
    """The registry's model at its own input size, through the bridge."""
    builder, size, mean, std = jm._MODEL_REGISTRY[name]
    jb = builder()
    flat = random_variables(jm.WrappedModel(backbone=jb, size=size, mean=mean, std=std),
                            size, seed=3)
    ts = tm.make_model(name, pretrained=False, device="cpu")
    load_flat_variables(ts.module, flat)
    x = _input(size, 4)[:1]
    with torch.no_grad():
        t = ts.apply(torch.from_numpy(x)).numpy()
    j = jm.WrappedModel(backbone=jb, size=size, mean=mean, std=std).apply(
        unflatten(flat), jnp.asarray(x))
    np.testing.assert_allclose(t, np.asarray(j), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("src,dst", [(40, 32), (224, 299)])
def test_preprocess_resize_matches_jax(src, dst):
    """Preprocess's resize (antialiased when it shrinks) and normalisation,
    and its input gradient, against JAX's ``jax.image.resize``."""
    mean, std = jm.INCEPTION_MEAN if dst == 299 else jm.IMAGENET_MEAN, jm.IMAGENET_STD
    rng = np.random.RandomState(dst)
    x = rng.rand(2, src, src, 3).astype(np.float32)
    cot = rng.randn(2, dst, dst, 3).astype(np.float32)
    jpre = jm.Preprocess(dst, mean, std)
    j_out, vjp = jax.vjp(lambda v: jpre.apply({}, v), jnp.asarray(x))
    (j_grad,) = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_(True)
    t_out = tm.Preprocess(dst, mean, std)(xt)
    (t_grad,) = torch.autograd.grad(t_out, xt, torch.from_numpy(cot))
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), atol=1e-5)
    np.testing.assert_allclose(t_grad.numpy(), np.asarray(j_grad), atol=1e-5)


def test_bridge_fills_every_eval_model_at_its_own_size():
    """Every leaf of each paper eval model maps onto one tensor of the
    port's model, and the port's parameter shapes are the JAX ones, at the
    registry's input size."""
    from transferattack_torch.utils import cnn_model_paper, vit_model_paper
    from transferattack_torch.utils.bridge import torch_key, torch_layout

    for name in cnn_model_paper[1:] + vit_model_paper:  # resnet50: test_torch_port_models
        builder, size, mean, std = jm._MODEL_REGISTRY[name]
        shapes = flatten(jax.eval_shape(
            jm.WrappedModel(backbone=builder(), size=size, mean=mean, std=std).init,
            jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32)))
        zero = np.float32(0)  # a zero-strided stand-in: names and shapes only
        bridged = {torch_key(k): torch_layout(k, np.broadcast_to(zero, s.shape)).shape
                   for k, s in shapes.items()}
        port_builder, port_size, _, _, sized = tm._MODEL_REGISTRY[name]
        assert port_size == size, name
        with torch.device("meta"):  # shapes only
            backbone = port_builder(img_size=size) if sized else port_builder()
        target = {f"backbone.{k}": tuple(v.shape) for k, v in backbone.state_dict().items()
                  if not k.endswith("num_batches_tracked")}
        assert len(bridged) == len(shapes) and bridged == target, name
