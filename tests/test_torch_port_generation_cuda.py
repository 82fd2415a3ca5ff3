"""The generators and FAP on a card.

Each generator (GeneratorResnet, AdvGAN, ADA) on seeded weights, BatchNorm
off the identity, fp32 with TF32 off: the card's output within
``1e-4·max|ref|`` of the CPU's.  The keys take the card by default and the
CPU only when asked, and FAP launches the update kernel once a step, 20
times a call.  Imports no JAX, so it runs on the card's machine:
``python -m pytest --noconftest tests/test_torch_port_generation_cuda.py -m cuda``.
"""
import copy
import warnings

import numpy as np
import pytest
import torch

import transferattack_torch as tt
from transferattack_torch.generation import generators as tgen
from transferattack_torch.models import init_weights
from transferattack_torch.ops.fused_update import fused_sign_update

TOL = 1e-4


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def no_tf32():
    needs_card()
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def seeded(net, seed):
    gen = torch.Generator().manual_seed(seed)
    init_weights(net, gen)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.1 * torch.randn(m.num_features, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(m.num_features, generator=gen))
    return net.eval()


@pytest.mark.cuda
@pytest.mark.parametrize("name,size", [("resnet", 64), ("advgan", 64), ("advgan", 65),
                                       ("ada", 67)])
def test_generator_on_the_card_matches_the_cpu(no_tf32, name, size):
    net = seeded({"resnet": tgen.GeneratorResnet, "advgan": tgen.AdvGANGenerator,
                  "ada": tgen.ADAGenerator}[name](), seed=19)
    gen = torch.Generator().manual_seed(20)
    args = (torch.rand(2, 3, size, size, generator=gen),) + (
        (torch.randn(2, 16, generator=gen),) if name == "ada" else ())
    with torch.no_grad():
        ref = net(*args)
        out = copy.deepcopy(net).cuda()(*(a.cuda() for a in args)).cpu()
    assert out.shape == ref.shape
    err = float((out - ref).abs().max() / ref.abs().max())
    assert err <= TOL, f"{name} at {size}²: max|card - cpu| / max|cpu| = {err:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["ttp", "ge_advgan", "ada", "fap"])
def test_keys_take_the_card_unless_asked_for_the_cpu(key):
    needs_card()
    kw = {"model_name": "resnet18", "input_size": 64} if key == "fap" else {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        card, cpu = tt.load_attack_class(key)(**kw), tt.load_attack_class(key)(device="cpu", **kw)
    assert card.device.type == "cuda" and cpu.device.type == "cpu"
    x = np.random.RandomState(21).rand(2, 64, 64, 3).astype(np.float32)
    y = np.zeros(2, np.int64)
    delta = card(x, y)
    assert delta.device.type == "cuda" and cpu(x, y).device.type == "cpu"
    assert 0 < float(delta.abs().max()) <= card.eps + 1e-6


@pytest.mark.cuda
def test_fap_launches_the_update_kernel_once_a_step():
    needs_card()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        atk = tt.load_attack_class("fap")(model_name="resnet18", input_size=64)
    x = np.random.RandomState(22).rand(2, 64, 64, 3).astype(np.float32)
    fused_sign_update.launches = 0
    delta = atk(x, np.array([1, 2]))
    torch.cuda.synchronize()
    assert fused_sign_update.launches == atk.epoch == 20
    assert 0 < float(delta.abs().max()) <= 48 / 255 + 1e-6
