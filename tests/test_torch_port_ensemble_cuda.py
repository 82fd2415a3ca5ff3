"""DenseNet and the five ensemble keys (ENS, SVRE, CWA, AdaEA, SMER) on a
card.

DenseNet-121's input gradient at 64², fp32 with TF32 off, in
``channels_last`` (the port's layout) and in NCHW: no further from a CPU
fp64 copy than the CPU's fp32 is, plus ``1e-3·max|ref|``.  Each key on a
two-member ensemble (ResNet-18 and ``toy_cnn2``, ten classes) at 64²,
batch 2, 2 iterations, on the card and on the CPU with one seeded CPU
generator's draws: deltas agreeing in sign on at least 99% of elements.  In
bf16, SVRE's and SMER's inner steps launch the update kernel as their code
implies.  Imports no JAX, so it runs on the card's machine:
``python -m pytest --noconftest tests/test_torch_port_ensemble_cuda.py -m cuda``.
"""
import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import transferattack_torch as tt
from transferattack_torch.models import make_model
from transferattack_torch.ops.fused_update import fused_sign_update

EPS = 16 / 255
KEYS = ("ens", "svre", "cwa", "adaea", "smer")
PAIR = dict(model_name=["resnet18", "toy_cnn2"], num_classes=10, input_size=64,
            pretrained=False)


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


def input_grad(module, x, y, nchw=False):
    """CE's input gradient through ``module`` (a ``WrappedModel``), its
    backbone fed ``channels_last`` (as the port runs it) or NCHW."""
    x = x.clone().requires_grad_(True)
    inp = module.preprocess(x).permute(0, 3, 1, 2)
    logits = module.backbone(inp.contiguous() if nchw else inp)
    return torch.autograd.grad(F.cross_entropy(logits, y), x)[0]


def rel(a, b):
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["channels_last", "NCHW"])
def test_densenet121_gradient_on_the_card_against_fp64(no_tf32, layout):
    cpu = make_model("densenet121", pretrained=False, input_size=64, device="cpu")
    exact = copy.deepcopy(cpu.module).double()
    card = copy.deepcopy(cpu.module).cuda()
    if layout == "NCHW":
        card = card.to(memory_format=torch.contiguous_format)
    gen = torch.Generator().manual_seed(3)
    x = torch.rand(2, 64, 64, 3, generator=gen)
    y = torch.randint(0, 1000, (2,), generator=gen)
    ref = input_grad(exact, x.double(), y)
    on_cpu = input_grad(cpu.module, x, y)
    on_card = input_grad(card, x.cuda(), y.cuda(), nchw=layout == "NCHW")
    assert torch.isfinite(on_card).all()
    assert rel(on_card, ref) <= rel(on_cpu, ref) + 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("key", KEYS)
def test_key_on_the_card_against_the_cpu(no_tf32, key):
    rng = np.random.RandomState(41)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    y = rng.randint(0, 10, 2)
    d = {w: tt.load_attack_class(key)(epoch=2, device=w, **PAIR)(
        x, y, generator=torch.Generator().manual_seed(42)).cpu().numpy()
        for w in ("cuda", "cpu")}
    agree = (np.sign(d["cuda"]) == np.sign(d["cpu"])).mean()
    assert agree >= 0.99, f"{key}: card vs CPU sign agreement {agree}"
    assert 0 < np.abs(d["cuda"]).max() <= EPS + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["svre", "smer"])
def test_inner_steps_launch_the_update_kernel(key):
    needs_card()
    atk = tt.load_attack_class(key)(epoch=2, device="cuda", compute_dtype="bfloat16", **PAIR)
    x = torch.rand(2, 64, 64, 3, device="cuda")
    fused_sign_update.launches = 0
    delta = atk(x, torch.tensor([1, 2], device="cuda"))
    torch.cuda.synchronize()
    assert fused_sign_update.launches == 2 * (4 * atk.K + 1)
    assert atk.grad_evals == (2 * (atk.K + 2 * 4 * atk.K) if key == "svre" else 2 * 4 * atk.K)
    assert float(delta.abs().max()) <= EPS + 1e-6
