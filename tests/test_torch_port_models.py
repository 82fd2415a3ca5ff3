"""The port's models against the JAX package's, through the weights bridge.

One set of weights, made with numpy from a seed in the flat layout that
``save_npz_variables`` writes (BatchNorm statistics and affine parameters
off the identity, so that BN matters), is loaded into both packages.  Logits must
agree with ``atol=2e-4, rtol=1e-3`` and input gradients under the bar of
``tests/test_torch_parity.py`` (fp32 on the CPU; the two differ only in the
order of floating-point sums).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transferattack_tpu.models as jm
import transferattack_torch.models as tm
from transferattack_torch.utils.bridge import load_flat_variables

NARROW_STAGES = (2, 1, 1, 1)


def flatten(tree, prefix=()):
    """Flax variables (or their shapes) → ``{"params/backbone/...": leaf}``."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(flatten(v, prefix + (str(k),)))
        else:
            flat["/".join(prefix + (str(k),))] = v
    return flat


def unflatten(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *parents, leaf = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def random_variables(module, size, seed=0, inputs=None):
    """Seeded numpy weights for a Flax ``module``, in the flat layout:
    kernels at lecun-normal scale, small biases, and every BatchNorm moved
    off the identity (statistics and affine parameters), so BN matters.
    ``inputs``: the module's input, where it is not a (1, size, size, 3)
    image, or a tuple of its inputs (ADA's generator takes an image and z)."""
    inputs = jnp.zeros((1, size, size, 3)) if inputs is None else inputs
    args = inputs if isinstance(inputs, tuple) else (inputs,)
    shapes = flatten(jax.eval_shape(module.init, jax.random.PRNGKey(0), *args))
    rng = np.random.RandomState(seed)
    flat = {}
    for k, s in sorted(shapes.items()):
        shape = s.shape
        if k.endswith("/kernel"):
            v = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif k.endswith("/mean"):
            v = rng.normal(0, 0.05, shape)
        elif k.endswith("/var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif k.endswith("/scale"):
            v = rng.normal(1.0, 0.1, shape)
        else:
            v = rng.normal(0, 0.05, shape)
        flat[k] = v.astype(np.float32)
    return flat


def jax_surrogate(backbone, size, mean, std, flat, num_classes):
    module = jm.WrappedModel(backbone=backbone, size=size, mean=mean, std=std)
    return jm.Surrogate(name="twin", module=module, variables=unflatten(flat),
                        input_size=size, num_classes=num_classes)


def narrow_bottleneck_pair(seed=0):
    """``ResNet(stage_sizes=(2, 1, 1, 1), block_cls=Bottleneck,
    num_classes=10)`` at 32², built in both packages with ``WrappedModel``
    and ``Surrogate`` and loaded with one set of weights."""
    from transferattack_tpu.models.resnet import Bottleneck as JBottleneck
    from transferattack_tpu.models.resnet import ResNet as JResNet
    from transferattack_torch.models.resnet import Bottleneck, ResNet

    mean, std = jm.IMAGENET_MEAN, jm.IMAGENET_STD
    jbackbone = JResNet(stage_sizes=NARROW_STAGES, block_cls=JBottleneck,
                        num_classes=10)
    flat = random_variables(jm.WrappedModel(backbone=jbackbone, size=32, mean=mean,
                                            std=std), 32, seed)
    js = jax_surrogate(jbackbone, 32, mean, std, flat, 10)
    tmod = tm.WrappedModel(ResNet(NARROW_STAGES, Bottleneck, num_classes=10),
                           32, mean, std)
    load_flat_variables(tmod, flat)
    tmod.eval().requires_grad_(False)
    ts = tm.Surrogate(name="twin", module=tmod, input_size=32, num_classes=10)
    return js, ts, flat


def registry_pair(name, seed=0):
    """A registered model at 32² in both packages, one set of weights.  The
    JAX twin is built from the classes its registry entry names."""
    from transferattack_tpu.models.resnet import BasicBlock, ResNet
    from transferattack_tpu.models.toy import ToyCNN

    jbackbone, mean, std = {
        "toy_cnn": (ToyCNN(), (0.5,) * 3, (0.5,) * 3),
        "resnet18": (ResNet(stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock),
                     jm.IMAGENET_MEAN, jm.IMAGENET_STD),
    }[name]
    flat = random_variables(jm.WrappedModel(backbone=jbackbone, size=32, mean=mean,
                                            std=std), 32, seed)
    js = jax_surrogate(jbackbone, 32, mean, std, flat, jbackbone.num_classes)
    ts = tm.make_model(name, pretrained=False, input_size=32, device="cpu")
    load_flat_variables(ts.module, flat)
    return js, ts, flat


@pytest.fixture(scope="module", params=["toy_cnn", "resnet18", "narrow_bottleneck"])
def pair(request):
    if request.param == "narrow_bottleneck":
        return narrow_bottleneck_pair()
    return registry_pair(request.param)


def test_logits_agree(pair):
    js, ts, _ = pair
    x = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    j = np.asarray(jax.jit(js.apply)(js.variables, jnp.asarray(x)))
    with torch.no_grad():
        t = ts.apply(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(t, j, atol=2e-4, rtol=1e-3)


def test_input_gradients_agree(pair):
    js, ts, _ = pair
    rng = np.random.RandomState(1)
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    y = np.array([3, 7])

    def ce(img):
        logp = jax.nn.log_softmax(js.apply(js.variables, img))
        return -logp[jnp.arange(2), jnp.asarray(y)].mean()

    j_grad = np.asarray(jax.jit(jax.grad(ce))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    torch.nn.functional.cross_entropy(ts.apply(xt), torch.from_numpy(y)).backward()
    t_grad = xt.grad.numpy()
    denom = np.abs(j_grad).max() + 1e-12
    np.testing.assert_allclose(t_grad / denom, j_grad / denom, atol=5e-4)
    mask = np.abs(j_grad) > 1e-3 * denom
    assert (np.sign(t_grad[mask]) == np.sign(j_grad[mask])).mean() > 0.999


def test_make_model_reads_the_jax_weights_file(tmp_path, monkeypatch):
    """``$TA_TPU_WEIGHTS_DIR/<name>.npz`` loads into both packages alike."""
    flat = registry_pair("toy_cnn", seed=2)[2]
    np.savez(tmp_path / "toy_cnn.npz", **flat)
    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", str(tmp_path))
    js = jm.make_model("toy_cnn")
    ts = tm.make_model("toy_cnn", device="cpu")
    x = np.random.RandomState(3).rand(2, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        t = ts.apply(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(t, np.asarray(js.apply(js.variables, jnp.asarray(x))),
                               atol=2e-4, rtol=1e-3)


def test_random_init_is_recorded_and_seeded(monkeypatch, tmp_path):
    monkeypatch.setenv("TA_TPU_WEIGHTS_DIR", str(tmp_path))
    a = tm.make_model("toy_cnn2", device="cpu")
    b = tm.make_model("toy_cnn2", device="cpu")
    assert "toy_cnn2" in tm.fallback_weights_used()
    for (ka, va), (kb, vb) in zip(a.module.state_dict().items(),
                                  b.module.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert all(not p.requires_grad for p in a.module.parameters())


def test_no_cuda_means_an_error_not_a_cpu_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tm.make_model("toy_cnn", pretrained=False)


def test_bridge_maps_resnet50_names():
    """The 267 leaves of the JAX ResNet-50 fill every tensor of the port's."""
    from transferattack_torch.utils.bridge import torch_key

    flat = flatten(jax.eval_shape(
        lambda: jm.make_model("resnet50", pretrained=False, input_size=32).variables))
    assert len(flat) == 267
    assert torch_key("params/backbone/layer1_0/downsample_bn/scale") == \
        "backbone.layer1.0.downsample.1.weight"
    assert torch_key("batch_stats/backbone/layer4_2/bn3/var") == \
        "backbone.layer4.2.bn3.running_var"
    ts = tm.make_model("resnet50", pretrained=False, device="cpu")
    target = {k for k in ts.module.state_dict() if not k.endswith("num_batches_tracked")}
    assert {torch_key(k) for k in flat} == target


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_bridge_is_strict(fault):
    flat = registry_pair("toy_cnn")[2]
    if fault == "missing":
        del flat["params/backbone/conv2/bias"]
    elif fault == "extra":
        flat["params/backbone/conv3/kernel"] = np.zeros((3, 3, 32, 32), np.float32)
    else:
        flat["params/backbone/fc/kernel"] = np.zeros((32, 11), np.float32)
    ts = tm.make_model("toy_cnn", pretrained=False, device="cpu")
    with pytest.raises(ValueError, match={"missing": "missing \\['backbone.conv2.bias'",
                                          "extra": "unused \\['backbone.conv3.weight'",
                                          "shape": "wrong shape"}[fault]):
        load_flat_variables(ts.module, flat)


def test_fold_bn_matches_jax_fold_bn_variables():
    """``fold_bn`` of the port's module equals JAX's ``fold_bn_variables``
    bridged into the port, and leaves the logits as they were."""
    from transferattack_tpu.models.resnet import fold_bn_variables
    from transferattack_torch.models.resnet import Bottleneck, ResNet, fold_bn

    js, ts, _ = narrow_bottleneck_pair(seed=5)
    ref = tm.WrappedModel(ResNet(NARROW_STAGES, Bottleneck, num_classes=10), 32,
                          jm.IMAGENET_MEAN, jm.IMAGENET_STD)
    load_flat_variables(ref, {k: np.asarray(v)
                              for k, v in flatten(fold_bn_variables(js.variables)).items()})
    x = torch.from_numpy(np.random.RandomState(6).rand(2, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        before = ts.apply(x).numpy()
        fold_bn(ts.module)
        after = ts.apply(x).numpy()
    folded = ts.module.state_dict()
    for k, v in ref.state_dict().items():
        np.testing.assert_allclose(folded[k].numpy(), v.numpy(), rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(after, before, atol=5e-4, rtol=1e-4)
