"""The port's ResNet gradient surgery against the JAX package's, mode by mode.

Each surgery mode's input gradient (CE, fp32 on the CPU) is taken through the
port's ResNet and through JAX's on one set of seeded numpy weights, and must
agree within ``1e-4·max|ref|``; it must also differ from the plain model's,
so that no case passes with the surgery off.  The nets: ResNet-18 at 32² and
Bottleneck ResNets of stage sizes (2, 2, 2, 2) and (1, 1, 2, 1), every stage
with a non-first block where SGM and LLTA need one.  The modes with a
raw-PyTorch twin of the reference's hooks in ``tests/test_surgery_parity.py``
(SGM, LinBP, IAA, BPA, Ghost) are also held against it, on the twin's own
weights loaded into the port, at that file's bar (sign agreement > 0.99).

Ghost's skip scales are the ones JAX draws inside its model (sown as
``ghost_scale``), handed to the port's forward.  The default
``SurgeryConfig()`` must leave the plain path: no ``autograd.Function`` in
the graph.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn
import torch.nn.functional as F

import transferattack_tpu.models as jm
import transferattack_torch.models as tm
from test_surgery_parity import (
    TorchBottleneckNet,
    _FnModule,
    _linbp_torch_grad,
    _randomize_bn,
    _register_sgm_hooks,
    _ReLUSiLUFn,
    _SoftmaxPoolFn,
    _torch_input_grad,
)
from test_surgery_parity import _assert_sign_parity as twin_bar
from test_torch_parity import TorchResNet18
from test_torch_port_models import jax_surrogate, random_variables
from transferattack_tpu.model_related.checkpoint_surrogates import (
    quantize_per_channel as jquantize,
)
from transferattack_tpu.model_related.metassa import lowfreq as jlowfreq
from transferattack_tpu.models import resnet as jresnet
from transferattack_torch.model_related.checkpoint_surrogates import (
    quantize_per_channel as tquantize,
)
from transferattack_torch.model_related.metassa import lowfreq as tlowfreq
from transferattack_torch.models import resnet as tresnet
from transferattack_torch.utils.bridge import load_flat_variables

SIZE, BATCH = 32, 2
TOL = 1e-4  # max|port - JAX| / max|JAX|, fp32
MEAN, STD = jm.IMAGENET_MEAN, jm.IMAGENET_STD
NETS = {"resnet18": ((2, 2, 2, 2), "BasicBlock"),
        "bottleneck2222": ((2, 2, 2, 2), "Bottleneck"),
        "bottleneck1121": ((1, 1, 2, 1), "Bottleneck")}
IAA_LAMBDAS = (0.98, 0.87, 0.73, 0.19)
# (net, surgery fields); LinBP and BPA from the block '3_1' is: resnet18 5,
# (1, 1, 2, 1) 3 (JAX's own twin), (2, 2, 2, 2) 5
# (net, surgery fields) of each mode, the nets shared out among the modes
# (the twins below hold SGM, IAA, BPA and Ghost on ResNet-18 once more);
# LinBP and BPA from the block '3_1': 3 on (1, 1, 2, 1), as JAX's own twin,
# 5 on (2, 2, 2, 2)
CASES = [
    ("sgm", "bottleneck2222", {"gamma": 0.2 ** 0.5}),
    ("linbp", "bottleneck1121", {"linbp_start": 3}),
    ("iaa", "resnet18", {"softplus_beta": 20.0, "residual_scale": IAA_LAMBDAS}),
    ("bpa", "bottleneck2222", {"bpa_start": 5, "bpa_maxpool": True}),
    ("ghost", "resnet18", {"ghost_range": 0.16}),
    ("decay", "bottleneck2222", {}),
    ("faug", "resnet18", {}),
]


def data(seed=3):
    rng = np.random.RandomState(seed)
    return rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32), np.array([3, 7])


@functools.lru_cache(maxsize=None)
def weights(net, seed=0):
    stages, block = NETS[net]
    plain = jresnet.ResNet(stage_sizes=stages, block_cls=getattr(jresnet, block),
                           num_classes=10)
    return random_variables(jm.WrappedModel(backbone=plain, size=SIZE, mean=MEAN, std=STD),
                            SIZE, seed)


def build(net, fields):
    """(JAX surrogate, the port's wrapped model, the port's plain one) of
    ``net`` with the surgery ``fields``, on one set of weights."""
    stages, block = NETS[net]
    jblock, tblock = getattr(jresnet, block), getattr(tresnet, block)
    flat = weights(net)
    jbackbone = jresnet.ResNet(stage_sizes=stages, block_cls=jblock, num_classes=10,
                               surgery=jresnet.SurgeryConfig(**fields))
    js = jax_surrogate(jbackbone, SIZE, MEAN, STD, flat, 10)
    tmods = []
    for surgery in (tresnet.SurgeryConfig(**fields), tresnet.DEFAULT_SURGERY):
        tmod = tm.WrappedModel(tresnet.ResNet(stages, tblock, num_classes=10,
                                              surgery=surgery), SIZE, MEAN, STD)
        load_flat_variables(tmod, flat)
        tmods.append(tmod.eval().requires_grad_(False))
    return (js, *tmods)


def jax_grad(js, x, y, **apply_kw):
    """JAX's input gradient, the variables and the keywords' arrays passed
    to the jitted function as arguments (closed over, they would compile as
    constants)."""
    def ce(img, variables, kw):
        logp = jax.nn.log_softmax(js.apply(variables, img, **kw, **fns))
        return -logp[jnp.arange(len(y)), jnp.asarray(y)].mean()

    fns = {k: v for k, v in apply_kw.items() if k == "tap_fns"}
    kw = {k: v for k, v in apply_kw.items() if k != "tap_fns"}
    return np.asarray(jax.jit(jax.grad(ce))(jnp.asarray(x), js.variables, kw))


def port_grad(forward, x, y):
    xt = torch.from_numpy(x).requires_grad_(True)
    F.cross_entropy(forward(xt), torch.from_numpy(y)).backward()
    return xt.grad.numpy()


def jax_ghost_scales(js, x, rngs):
    """The per-channel skip scales JAX's ghost forward draws, by block."""
    @jax.jit
    def sown(variables, img, rngs):
        return js.module.apply(variables, img, rngs=rngs, mutable=["intermediates"])[1]

    blocks = sown(js.variables, jnp.asarray(x), rngs)["intermediates"]["backbone"]
    return {name: torch.from_numpy(np.asarray(v["ghost_scale"][0]).reshape(-1))
            for name, v in blocks.items() if "ghost_scale" in v}


def mode_inputs(mode, net, js, x):
    """(JAX apply keywords, the port's forward keywords, tap) of a mode
    that takes draws: Ghost's scales as JAX drew them, LLTA's per-image γ,
    FAUG's noise at the stem conv."""
    if mode == "ghost":
        rngs = {"ghost": jax.random.PRNGKey(11)}
        scales = jax_ghost_scales(js, x, rngs)
        return {"rngs": rngs}, {"ghost": lambda kind, name, shape: scales[name]}, None
    if mode == "decay":
        g = sum(n - 1 for n in NETS[net][0])
        gammas = np.random.RandomState(5).uniform(0.2, 1.5, (BATCH, g)).astype(np.float32)
        return {"gammas": jnp.asarray(gammas)}, {"gammas": torch.from_numpy(gammas)}, None
    if mode == "faug":
        noise = np.random.RandomState(6).normal(0, 0.3, (BATCH, SIZE // 2, SIZE // 2, 64))
        noise = noise.astype(np.float32)
        return ({"tap_fns": {"conv1": lambda f: f + noise}}, {},
                lambda f: f + torch.from_numpy(noise))
    return {}, {}, None


@pytest.mark.parametrize("mode,net,fields", CASES, ids=[f"{m}-{n}" for m, n, _ in CASES])
def test_surgery_gradient_agrees_with_jax(mode, net, fields):
    js, tmod, plain_mod = build(net, fields)
    x, y = data()
    jkw, tkw, tap = mode_inputs(mode, net, js, x)
    j = jax_grad(js, x, y, **jkw)
    surrogate = tm.Surrogate(name=net, module=tmod, input_size=SIZE, num_classes=10)
    t = port_grad(lambda a: surrogate.apply(a, tap_fns={"conv1": tap} if tap else None,
                                            **tkw), x, y)
    scale = np.abs(j).max()
    err = np.abs(t - j).max() / scale
    assert err <= TOL, f"{mode} on {net}: max|port - JAX| / max|JAX| = {err:.3e}"
    # the surgery is on: the plain model's gradient is another
    plain = port_grad(plain_mod, x, y)
    moved = np.abs(plain - j).max() / scale
    assert moved > 100 * TOL, f"{mode} on {net}: within {moved:.3e} of the plain gradient"


def twin_and_port(twin, stages, block, fields, size=SIZE):
    """The twin's weights (BN statistics moved) loaded into the port's net
    with the surgery ``fields``."""
    _randomize_bn(twin)
    backbone = tresnet.ResNet(stages, getattr(tresnet, block), num_classes=1000,
                              surgery=tresnet.SurgeryConfig(**fields))
    backbone.load_state_dict(twin.state_dict())
    return tm.WrappedModel(backbone, size, MEAN, STD).eval().requires_grad_(False)


def _iaa_twin(tmodel, beta, lambdas):
    def replace(mod):
        for n, child in mod.named_children():
            if isinstance(child, tnn.ReLU):
                setattr(mod, n, tnn.Softplus(beta=beta))
            else:
                replace(child)

    replace(tmodel)
    for stage in range(1, 5):
        for blk in getattr(tmodel, f"layer{stage}"):
            blk.bn2.register_forward_hook(lambda m, i, o, lam=lambdas[stage - 1]: o * lam)
    return tmodel


def _ghost_twin(tmodel, scales):
    def patch(blk, s):
        def fwd(x):
            identity = x if blk.downsample is None else blk.downsample(x)
            out = blk.relu(blk.bn1(blk.conv1(x)))
            return blk.relu(blk.bn2(blk.conv2(out)) + identity * s.reshape(1, -1, 1, 1))

        blk.forward = fwd

    for stage in range(1, 5):
        for j, blk in enumerate(getattr(tmodel, f"layer{stage}")):
            patch(blk, scales[f"layer{stage}_{j}"])
    return tmodel


TWINS = ["sgm", "linbp", "iaa", "bpa", "ghost"]


@pytest.mark.parametrize("mode", TWINS)
def test_surgery_gradient_agrees_with_the_reference_twin(mode):
    """The twins of ``tests/test_surgery_parity.py`` (the reference's hooks
    and module swaps on raw PyTorch) against the port, on 64² as there."""
    torch.manual_seed(40 + TWINS.index(mode))
    x, y = data(seed=TWINS.index(mode) + 3)
    x = np.repeat(np.repeat(x, 2, axis=1), 2, axis=2)  # 64²
    if mode == "linbp":
        twin = TorchBottleneckNet().eval()
        port = twin_and_port(twin, TorchBottleneckNet.STAGES, "Bottleneck",
                             {"linbp_start": 3}, 64)
        t_grad = _linbp_torch_grad(twin, x, y)
    else:
        twin = TorchResNet18().eval()
        fields = {"sgm": {"gamma": 0.2},
                  "iaa": {"softplus_beta": 20.0, "residual_scale": IAA_LAMBDAS},
                  "bpa": {"bpa_start": 5, "bpa_maxpool": True},
                  "ghost": {"ghost_range": 0.16}}[mode]
        port = twin_and_port(twin, (2, 2, 2, 2), "BasicBlock", fields, 64)
        if mode == "sgm":
            wrapped = tnn.Sequential(tnn.Identity(), twin).eval()
            _register_sgm_hooks(wrapped, gamma=0.2)
            t_grad = _torch_input_grad(wrapped, x, y)
        elif mode == "iaa":
            t_grad = _torch_input_grad(_iaa_twin(twin, 20.0, IAA_LAMBDAS), x, y)
        elif mode == "bpa":
            twin.maxpool = _FnModule(_SoftmaxPoolFn)
            for i, blk in enumerate(twin.layer3):
                if i >= 1:
                    blk.relu = _FnModule(_ReLUSiLUFn)
            for blk in twin.layer4:
                blk.relu = _FnModule(_ReLUSiLUFn)
            t_grad = _torch_input_grad(twin, x, y)
        else:
            rng = np.random.RandomState(8)
            scales = {f"layer{s}_{j}": torch.from_numpy(
                rng.uniform(0.84, 1.16, 64 * 2 ** (s - 1)).astype(np.float32))
                for s in range(1, 5) for j in range(2)}
            port_fwd = port
            port = lambda a: port_fwd(a, ghost=lambda kind, name, shape: scales[name])
            t_grad = _torch_input_grad(_ghost_twin(twin, scales), x, y)
    twin_bar(port_grad(port, x, y), t_grad)


def test_default_surgery_is_the_plain_path():
    """``SurgeryConfig()`` (the default, or an equal one): ``F.relu``,
    ``nn.MaxPool2d`` and a plain residual add, with no ``autograd.Function``
    anywhere in the backward graph, and the logits of the model built
    without a surgery."""
    x = torch.from_numpy(data()[0])
    outs = []
    for surgery in (tresnet.DEFAULT_SURGERY, tresnet.SurgeryConfig()):
        torch.manual_seed(0)
        net = tresnet.ResNet((2, 2, 2, 2), tresnet.Bottleneck, num_classes=10,
                             surgery=surgery)
        tm.init_weights(net, torch.Generator().manual_seed(1))
        model = tm.WrappedModel(net, SIZE, MEAN, STD).eval().requires_grad_(False)
        assert all(m.surgery == tresnet.DEFAULT_SURGERY for m in net.modules()
                   if isinstance(m, tresnet._Block))
        xt = x.clone().requires_grad_(True)
        out = model(xt)
        seen, stack = set(), [out.grad_fn]
        while stack:
            node = stack.pop()
            if node is None or node in seen:
                continue
            seen.add(node)
            assert not isinstance(node, torch.autograd.function.BackwardCFunction), node
            stack.extend(n for n, _ in node.next_functions)
        assert any("MaxPool2D" in type(n).__name__ for n in seen)
        outs.append(out.detach())
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(16, 8, 3, 3), (10, 40)], ids=["conv_oihw", "linear"])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_per_channel_agrees_with_jax(shape, bits):
    """The output channel is dim 0 of a PyTorch weight and the last axis of
    JAX's (HWIO, (in, out)): the same quantized values, moved."""
    w = np.random.RandomState(bits).normal(0, 0.1, shape).astype(np.float32)
    to_jax = (2, 3, 1, 0) if len(shape) == 4 else (1, 0)
    j = np.asarray(jquantize(jnp.asarray(w.transpose(to_jax)), bits))
    wt = torch.from_numpy(w).requires_grad_(True)
    t = tquantize(wt, bits)
    np.testing.assert_array_equal(t.detach().numpy().transpose(to_jax), j)
    assert len(np.unique(t.detach().numpy()[0])) <= 2 ** bits - 1
    t.sum().backward()  # the straight-through estimator
    np.testing.assert_array_equal(wt.grad.numpy(), np.ones(shape, np.float32))


def test_lowfreq_agrees_with_jax():
    x = np.random.RandomState(4).rand(2, 8, 6, 3).astype(np.float32)
    np.testing.assert_allclose(tlowfreq(torch.from_numpy(x)).numpy(),
                               np.asarray(jlowfreq(jnp.asarray(x))), rtol=0, atol=1e-7)
