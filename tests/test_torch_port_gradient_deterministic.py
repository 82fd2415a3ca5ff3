"""The port's gradient family against the JAX package: the attacks that draw
nothing at random, and the hyperparameter registry.

Each key runs in both packages on one set of weights (``toy_cnn`` at 32²,
batch 4, 3 iterations, fp32 on the CPU; EMI-FGSM also on the narrow
Bottleneck ResNet, and PI-FGSM there step by step).  The bar is that of
``tests/test_torch_port_mifgsm.py``: the deltas agree in sign on more than
99% of elements (a sign can flip where a gradient element is near zero,
because the two packages sum in another order), and stay inside the eps-ball
and [0, 1].
"""
import numpy as np
import pytest
import torch

import transferattack_torch as tt
from test_torch_port_models import narrow_bottleneck_pair, registry_pair
from transferattack_tpu import config as jconfig
from transferattack_torch import config as tconfig

import transferattack_tpu as ta

EPS = 16 / 255
EPOCH, BATCH = 3, 4
PORT_KEYS = sorted(tt.attack_zoo)
DETERMINISTIC = ["emifgsm", "ifgssm", "aifgtm", "adamsi_fgm", "pifgsm", "pcifgsm",
                 "iefgsm", "gnp", "dta", "mig", "gifgsm"]


def batch(seed=6, size=32, num_classes=10):
    rng = np.random.RandomState(seed)
    return (rng.rand(BATCH, size, size, 3).astype(np.float32),
            rng.randint(0, num_classes, size=BATCH))


def run_pair(key, pair, x, y, jax_seams=None, port_seams=None, eps=EPS, **kw):
    """``key`` in both packages on one pair of surrogates, with the seams
    given as methods of a subclass on each side; checks the bar and returns
    both deltas."""
    js, ts, _ = pair
    jcls, tcls = ta.load_attack_class(key), tt.load_attack_class(key)
    if jax_seams or port_seams:
        jcls = type(jcls.__name__, (jcls,), jax_seams or {})
        tcls = type(tcls.__name__, (tcls,), port_seams or {})
    kw = {"epoch": EPOCH, **kw}
    j = np.asarray(jcls(model_name=js, **kw)(x, y))
    t = tcls(model_name=ts, device="cpu", **kw)(x, y).numpy()
    agree = (np.sign(t) == np.sign(j)).mean()
    assert agree > 0.99, f"{key}: delta sign agreement {agree:.4f}"
    assert np.abs(t).max() <= eps + 1e-6
    assert (x + t).min() >= -1e-6 and (x + t).max() <= 1 + 1e-6
    assert np.abs(t).max() > 0
    return j, t


@pytest.fixture(scope="module")
def toy():
    return registry_pair("toy_cnn", seed=5)


@pytest.fixture(scope="module")
def narrow():
    return narrow_bottleneck_pair(seed=5)


@pytest.mark.parametrize("key", DETERMINISTIC)
def test_deterministic_key_agrees_with_jax(toy, key):
    run_pair(key, toy, *batch())


def test_emifgsm_agrees_on_the_narrow_bottleneck(narrow):
    run_pair("emifgsm", narrow, *batch(seed=7))


def test_pifgsm_steps_agree_on_the_narrow_bottleneck(narrow):
    """PI-FGSM on the narrow Bottleneck, held step by step: each port step
    starts from JAX's state.  Its projection is the sign of a ring sum of
    cut noise that is often exactly zero, so a last-bit difference in the
    sum's order flips a tie into a full ±gamma step (0.3% of elements a step
    here), and over a whole trajectory the flips compound
    (``tests/test_attack_parity3.py`` records the same for JAX against its
    torch twin: 0.93 at iteration 10).  Each step must meet the bar."""
    import jax

    from transferattack_torch.attack import AttackState

    js, ts, _ = narrow
    x, y = batch(seed=7)
    jatk = ta.load_attack_class("pifgsm")(model_name=js, epoch=EPOCH)
    tatk = tt.load_attack_class("pifgsm")(model_name=ts, epoch=EPOCH, device="cpu")
    jstate = jatk.init_state(x, y, jax.random.PRNGKey(0))
    jstep = jax.jit(jatk.step)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for t in range(EPOCH):
        tstate = AttackState(
            delta=torch.from_numpy(np.array(jstate.delta)),
            momentum=torch.from_numpy(np.array(jstate.momentum)), step=t,
            extra={"amplification": torch.from_numpy(
                np.array(jstate.extra["amplification"]))})
        out = tatk.step(xt, yt, tstate, None)
        jstate = jstep(jatk.model.variables, x, y, jstate)
        for name, tv, jv in (("delta", out.delta, jstate.delta),
                             ("momentum", out.momentum, jstate.momentum),
                             ("amplification", out.extra["amplification"],
                              jstate.extra["amplification"])):
            agree = (np.sign(tv.numpy()) == np.sign(np.asarray(jv))).mean()
            assert agree > 0.99, f"step {t}: {name} sign agreement {agree:.4f}"
        assert np.abs(out.delta.numpy()).max() <= EPS + 1e-6


def test_ifgssm_staircase_matches_jax():
    """The percentile staircase at a full-size image (50,176 pixels a
    channel), 'lower' quantiles included."""
    import jax.numpy as jnp

    from transferattack_tpu.gradient.ifgssm import staircase_sign as jstair
    from transferattack_torch.gradient.ifgssm import staircase_sign as tstair

    g = np.random.RandomState(3).randn(2, 224, 224, 3).astype(np.float32)
    np.testing.assert_array_equal(tstair(torch.from_numpy(g), 1.5625).numpy(),
                                  np.asarray(jstair(jnp.asarray(g), 1.5625)))


@pytest.mark.parametrize("key", PORT_KEYS)
def test_official_defaults_agree_with_jax(key):
    """Every port key's hyperparameters are JAX's, key for key (``device``
    is the port's own)."""
    port = tconfig.official_defaults(key)
    assert port.pop("device") == "cuda"
    assert port == jconfig.official_defaults(key)
    assert tt.attack_zoo[key] == ta.attack_zoo[key]
