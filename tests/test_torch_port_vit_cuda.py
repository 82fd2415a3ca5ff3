"""The port's ViT gradient surgery and its ten ViT keys of ``model_related/``
on a card.

The surgery's input gradient on the card and on the CPU (a narrow ViT, a
narrow CaiT with class-attention hooks, Visformer, PiT, Inception-ResNet-v2
and Inception-v3 with ghost draws, fp32 with TF32 off), each against a CPU
fp64 copy: the card no further from it than the CPU, plus
``1e-3·max|ref|``; the padded average pool of the Inception models on a
``channels_last`` card tensor within ``1e-5`` of fp64.  Each key
against the CPU on a narrow ViT (one seeded CPU generator for both calls):
deltas agreeing in sign on at least 99% of elements.  Each key once at full
width (ViT-B/16, bf16, 224², batch 2, one iteration, few draws): a finite
delta inside its bounds and the update-kernel launches its code implies.
Imports no JAX, so it runs on the card's machine:
``python -m pytest --noconftest tests/test_torch_port_vit_cuda.py -m cuda``.
"""
import warnings

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import transferattack_torch as tt
from transferattack_torch.model_related.vit_attacks import TGR_CLS_SURGERY, TGR_SURGERY
from transferattack_torch.models import (IMAGENET_MEAN, IMAGENET_STD, Surrogate,
                                         WrappedModel, init_weights, make_model)
from transferattack_torch.models.inception import avgpool3
from transferattack_torch.models.vit import VisionTransformer, ViTSurgery
from transferattack_torch.ops.fused_update import fused_sign_update

EPS = 16 / 255
KEYS = ["tgr", "pna_patchout", "sapr", "fdap", "vdc", "fpr", "att", "setr", "ll2s", "ata_vit"]
SMALL = {"pna_patchout": {"sample_num_patches": 2}, "att": {"sample_num_patches": 2},
         "ll2s": {"num_scale": 2, "ops_num": 1, "num_robust_tokens": 3}}
NARROW = {"patch_size": 16, "dim": 64, "depth": 12, "num_heads": 2, "img_size": 32}


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def fp32():
    needs_card()
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def narrow_vit(where):
    module = WrappedModel(VisionTransformer(**NARROW), 32, IMAGENET_MEAN, IMAGENET_STD)
    init_weights(module, torch.Generator().manual_seed(7))
    return Surrogate(name="narrow", module=module.eval().requires_grad_(False).to(where),
                     input_size=32)


def calibrated(model, where):
    """``model`` with its BatchNorm statistics taken from a seeded batch, on
    ``where``: a random init's identity statistics normalise nothing, and
    Visformer's gradient is then ill-conditioned in fp32 (2.2e-3 of its max
    from fp64 on the CPU at 64²)."""
    for m in model.module.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = None  # the running statistics: this batch's
    model.module.train()
    with torch.no_grad():
        model.apply(torch.rand((8, 64, 64, 3), generator=torch.Generator().manual_seed(9)))
    model.module.eval().to(where)
    return model


def surgery_models(case, where):
    """(surrogate, forward keywords) of a surgery case on ``where``."""
    if case == "vit_tgr":
        return narrow_vit(where), {"surgery": TGR_SURGERY}
    if case == "vit_skip_attn_grad":
        return narrow_vit(where), {"surgery": ViTSurgery(skip_attn_grad=True)}
    if case == "cait_tgr":
        return (make_model("cait_s24_224", pretrained=False, input_size=32, device=where),
                {"surgery": TGR_SURGERY, "cls_surgery": TGR_CLS_SURGERY})
    if case == "pit_s_224":
        return (make_model(case, pretrained=False, input_size=64, device=where),
                {"surgery": TGR_SURGERY})
    if case == "visformer_small":
        return (calibrated(make_model(case, pretrained=False, input_size=64, device="cpu"),
                           where),
                {"surgery": ViTSurgery(attn_bwd=lambda g, m: 0.5 * g,
                                       mlp_in_bwd=lambda g, m: 0.8 * g)})
    if case == "inception_v3":  # ghost dropout masks at keep 0.9
        return (make_model("inception_v3", pretrained=False, input_size=75, device=where,
                           ghost_keep_prob=0.9),
                {"ghost": lambda kind, name, shape: (torch.rand(
                    shape, generator=torch.Generator().manual_seed(len(name))) < 0.9).to(where)})
    return (make_model("inception_resnet_v2", pretrained=False, input_size=96, device=where,
                       ghost_range=0.16),
            {"ghost": lambda kind, name, shape: (
                torch.rand(shape, generator=torch.Generator().manual_seed(len(name)))
                * 0.32 + 0.84).to(where)})


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["vit_tgr", "vit_skip_attn_grad", "cait_tgr",
                                  "visformer_small", "pit_s_224", "inception_resnet_v2",
                                  "inception_v3"])
def test_surgery_gradient_on_the_card_agrees_with_the_cpu(fp32, case):
    """Each fp32 gradient against a CPU fp64 copy: the card no further from it
    than the CPU is, plus 1e-3 of its max."""
    grads = {}
    for where, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                         ("cpu", torch.float64)):
        model, kw = surgery_models(case, where)
        model.module.to(dtype)
        size = model.input_size
        x = torch.rand((2, size, size, 3), generator=torch.Generator().manual_seed(3))
        xt = x.to(where, dtype).requires_grad_(True)
        F.cross_entropy(model.apply(xt, **kw), torch.tensor([3, 7], device=where)).backward()
        grads[where, dtype] = xt.grad.cpu().double()
    ref = grads["cpu", torch.float64]
    card, cpu = (float((grads[w, torch.float32] - ref).abs().max() / ref.abs().max())
                 for w in ("cuda", "cpu"))
    assert card <= cpu + 1e-3, f"{case}: from fp64, card {card:.3e}, CPU {cpu:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("count_include_pad", [True, False])
def test_avgpool3_gradient_on_a_channels_last_card_tensor(fp32, count_include_pad):
    """The padded 3×3 average pool of Inception-v3 and Inception-ResNet-v2,
    given a ``channels_last`` tensor on the card: its input gradient against
    a CPU fp64 one (``avg_pool2d``'s own channels_last CUDA backward is off
    by about the gradient's max)."""
    g = torch.Generator().manual_seed(8)
    x = torch.randn((2, 192, 9, 9), generator=g, dtype=torch.float64)
    w = torch.randn((2, 192, 9, 9), generator=g, dtype=torch.float64)
    grads = {}
    for where, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        xt = x.to(where, dtype).contiguous(memory_format=torch.channels_last).requires_grad_(True)
        (avgpool3(xt, count_include_pad) * w.to(where, dtype)).sum().backward()
        grads[where] = xt.grad.cpu().double()
    err = float((grads["cuda"] - grads["cpu"]).abs().max() / grads["cpu"].abs().max())
    assert err <= 1e-5, f"max|card - fp64| / max|fp64| = {err:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("key", KEYS)
def test_key_on_the_card_agrees_with_the_cpu(fp32, key):
    rng = np.random.RandomState(5)
    xs, ys = rng.rand(2, 32, 32, 3).astype(np.float32), rng.randint(0, 1000, 2)
    d = {}
    for where in ("cuda", "cpu"):
        with warnings.catch_warnings():  # SETR: no TRM checkpoint here
            warnings.simplefilter("ignore")
            atk = tt.load_attack_class(key)(model_name=narrow_vit(where), device=where, epoch=2,
                                            **SMALL.get(key, {}))
        d[where] = atk(xs, ys, generator=torch.Generator().manual_seed(6)).cpu().numpy()
    agree = float((np.sign(d["cuda"]) == np.sign(d["cpu"])).mean())
    assert agree >= 0.99, f"{key}: delta sign agreement card vs CPU {agree}"


@pytest.mark.cuda
@pytest.mark.parametrize("key", KEYS)
def test_key_runs_at_full_width_on_the_card(key):
    needs_card()
    x = torch.rand((2, 224, 224, 3), generator=torch.Generator().manual_seed(5)).cuda()
    kw = {"epoch": 1, **SMALL.get(key, {})}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        atk = tt.load_attack_class(key)(compute_dtype="bfloat16", device="cuda", **kw)
    with torch.no_grad():
        y = atk.model.apply(x, surgery=ViTSurgery()).argmax(-1)
    fused_sign_update.launches = 0
    delta = atk(x, y)
    torch.cuda.synchronize()
    assert fused_sign_update.launches == (0 if key == "ata_vit" else atk.epoch)
    assert bool(torch.isfinite(delta).all())
    bound = 1.0 if key == "ata_vit" else EPS  # ATA-ViT: a patch attack
    assert 0 < float(delta.abs().max()) <= bound + 1e-6
    adv = x + delta
    assert float(adv.min()) >= -1e-6 and float(adv.max()) <= 1 + 1e-6
