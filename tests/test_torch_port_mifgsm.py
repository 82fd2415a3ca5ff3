"""The port's engine and MI-FGSM family against the JAX package.

FGSM, I-FGSM, MI-FGSM and NI-FGSM run in fp32 on the CPU, 3 iterations, on
one set of weights in both packages.  The deltas must agree in sign on more
than 99% of elements (the bar of ``tests/test_attack_parity.py``; a sign
can flip where a gradient element is near zero, because the two sum in
another order) and stay inside the eps-ball and [0, 1].
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transferattack_tpu as ta
import transferattack_tpu.attack as jattack
import transferattack_torch as tt
import transferattack_torch.attack as tattack
from test_torch_port_models import narrow_bottleneck_pair, registry_pair

EPS = 16 / 255
REPO = Path(__file__).resolve().parents[1]


def test_l1_normalize_agrees():
    g = np.random.RandomState(0).randn(4, 8, 8, 3).astype(np.float32)
    j = np.asarray(jattack.l1_normalize(jnp.asarray(g)))
    t = tattack.l1_normalize(torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=1e-6)


def test_softmax_cross_entropy_agrees():
    rng = np.random.RandomState(1)
    logits = (rng.randn(2, 4, 10) * 3).astype(np.float32)
    y = rng.randint(0, 10, size=4)
    j = np.asarray(jattack.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(y)))
    t = tattack.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(y))
    np.testing.assert_allclose(t.numpy(), j, atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module", params=["toy_cnn", "narrow_bottleneck"])
def pair(request):
    if request.param == "narrow_bottleneck":
        return narrow_bottleneck_pair(seed=5)
    return registry_pair(request.param, seed=5)


@pytest.mark.parametrize("key", ["fgsm", "ifgsm", "mifgsm", "nifgsm"])
def test_attack_agrees_with_jax(pair, key):
    js, ts, _ = pair
    rng = np.random.RandomState(6)
    x = rng.rand(4, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, size=4)
    j = np.asarray(ta.load_attack_class(key)(model_name=js, epoch=3)(x, y))
    t = tt.load_attack_class(key)(model_name=ts, epoch=3, device="cpu")(x, y).numpy()
    assert (np.sign(t) == np.sign(j)).mean() > 0.99
    assert np.abs(t).max() <= EPS + 1e-6
    assert (x + t).min() >= -1e-6 and (x + t).max() <= 1 + 1e-6
    assert np.abs(t).max() > 0


def test_l2_mifgsm_agrees_with_jax(pair):
    """The L2 step and eps-ball renorm projection of ``update_delta``."""
    js, ts, _ = pair
    rng = np.random.RandomState(9)
    x = rng.rand(4, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, size=4)
    kw = dict(epoch=3, norm="l2", eps=2.0, alpha=0.5)
    j = np.asarray(ta.load_attack_class("mifgsm")(model_name=js, **kw)(x, y))
    t = tt.load_attack_class("mifgsm")(model_name=ts, device="cpu", **kw)(x, y).numpy()
    assert (np.sign(t) == np.sign(j)).mean() > 0.99
    np.testing.assert_allclose(np.linalg.norm(t.reshape(4, -1), axis=1),
                               np.linalg.norm(j.reshape(4, -1), axis=1), rtol=1e-3)
    assert np.linalg.norm(t.reshape(4, -1), axis=1).max() <= 2.0 + 1e-5


def test_port_imports_no_jax():
    """Every module of the port imports without JAX, Flax, the JAX package
    or PIL (the card's machine has none of them)."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "transferattack_torch").rglob("*.py") if p.name != "__init__.py")
    assert "transferattack_torch.main" in modules and len(modules) >= 20
    code = (f"import sys, importlib, transferattack_torch; "
            f"[importlib.import_module(m) for m in {modules!r}]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'transferattack_tpu', 'PIL')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


@pytest.mark.slow
def test_resnet50_mifgsm_agrees_with_jax():
    """Full-width ResNet-50 at 64², batch 2, through the bridge."""
    from test_torch_port_models import jax_surrogate, random_variables

    import transferattack_tpu.models as jm
    import transferattack_torch.models as tm
    from transferattack_tpu.models.resnet import Bottleneck, ResNet
    from transferattack_torch.utils.bridge import load_flat_variables

    backbone = ResNet(stage_sizes=[3, 4, 6, 3], block_cls=Bottleneck)
    mean, std = jm.IMAGENET_MEAN, jm.IMAGENET_STD
    flat = random_variables(jm.WrappedModel(backbone=backbone, size=64, mean=mean,
                                            std=std), 64, seed=7)
    assert len(flat) == 267
    jsur = jax_surrogate(backbone, 64, mean, std, flat, 1000)
    tsur = tm.make_model("resnet50", pretrained=False, input_size=64, device="cpu")
    load_flat_variables(tsur.module, flat)
    rng = np.random.RandomState(8)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    y = rng.randint(0, 1000, size=2)
    j = np.asarray(ta.load_attack_class("mifgsm")(model_name=jsur, epoch=3)(x, y))
    t = tt.load_attack_class("mifgsm")(model_name=tsur, epoch=3, device="cpu")(x, y)
    assert (np.sign(t.numpy()) == np.sign(j)).mean() > 0.99
