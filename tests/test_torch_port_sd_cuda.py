"""The Stable Diffusion stack's blocks and the training step on a card.

Each UNet and VAE block where a card path can go wrong on ``channels_last``
tensors (the resnet block's GroupNorm and time embedding, the transformer
with its explicit softmax maps and its ``scaled_dot_product_attention``
path, the VAE's single-head attention, its bottom-right-padded stride-2
down-sampling and its nearest up-sampling) runs on the card in fp32 with
TF32 off against the same block in fp64 on the CPU, output and input
gradient; the generator training step's loss and gradients against the
CPU; the SD backend takes the card by default.  Imports no JAX, so it runs
on the card's machine:
``python -m pytest --noconftest tests/test_torch_port_sd_cuda.py -m cuda``.
"""
import copy
import warnings

import numpy as np
import pytest
import torch

import transferattack_torch as tt
from transferattack_torch.defense.gd_unet import init_nonzero
from transferattack_torch.generation import diffattack_sd as tds
from transferattack_torch.generation import sd_text, sd_unet, sd_vae
from transferattack_torch.generation import train as ttrain
from transferattack_torch.generation.generators import GeneratorResnet
from transferattack_torch.models import init_weights, make_model

FP64_TOL = 1e-5  # fp32 on the card against fp64: max|d| / max|ref|
CPU_TOL = 1e-3   # fp32 on the card against fp32 on the CPU


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


def rel(out, ref):
    out, ref = out.detach().cpu().double(), ref.detach().cpu().double()
    return float((out - ref).abs().max() / ref.abs().max())


def seeded(module, seed):
    return init_nonzero(module, torch.Generator().manual_seed(seed))


def card_vs_fp64(block, x, *args, maps=False):
    """(output, input gradient[, maps]) errors of the block on the card in
    fp32 from a channels_last input against fp64 on the CPU, under one
    random output gradient."""
    found = []
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        gen = torch.Generator().manual_seed(3)
        mod = copy.deepcopy(block).to(dev, dtype)
        xi = x.to(dev, dtype)
        xi = (xi.contiguous(memory_format=torch.channels_last) if xi.ndim == 4 else xi)
        xi.requires_grad_(True)
        kw = {"maps": {"attn": [], "cross_attn": []}} if maps else {}
        out = mod(xi, *(a.to(dev, dtype) for a in args), **kw)
        g = torch.randn(out.shape, generator=gen, dtype=torch.float64).to(dev, dtype)
        (dx,) = torch.autograd.grad(out, xi, g)
        found.append((out, dx, kw.get("maps")))
    (out, dx, m), (ref, ref_dx, ref_m) = found
    errs = [rel(out, ref), rel(dx, ref_dx)]
    if maps:
        errs.append(max(rel(a, b) for a, b in zip(m["attn"] + m["cross_attn"],
                                                  ref_m["attn"] + ref_m["cross_attn"])))
    return errs


@pytest.mark.cuda
def test_resnet_block_with_time_embedding_matches_fp64(no_tf32):
    gen = torch.Generator().manual_seed(1)
    block = seeded(sd_unet.SDResnetBlock(64, 128, 256, 32), 1)
    x = 2.0 + 3.0 * torch.randn(2, 64, 16, 16, generator=gen)  # off zero mean
    errs = card_vs_fp64(block, x, torch.randn(2, 256, generator=gen))
    assert max(errs) <= FP64_TOL, errs


@pytest.mark.cuda
@pytest.mark.parametrize("with_maps", [True, False], ids=["maps", "sdpa"])
def test_transformer_and_its_maps_match_fp64(no_tf32, with_maps):
    gen = torch.Generator().manual_seed(2)
    block = seeded(sd_unet.SDTransformer2D(128, 64, 8, 32), 2)
    x, ctx = torch.randn(2, 128, 16, 16, generator=gen), torch.randn(2, 77, 64, generator=gen)
    errs = card_vs_fp64(block, x, ctx, maps=with_maps)
    assert max(errs) <= FP64_TOL, errs


@pytest.mark.cuda
@pytest.mark.parametrize("sample", ["down", "up"])
def test_vae_resampling_block_matches_fp64(no_tf32, sample):
    gen = torch.Generator().manual_seed(4)
    block = seeded(sd_vae.VAEBlock(64, 64, 2, 32, sample), 4)
    x = torch.randn(2, 64, 17 if sample == "down" else 16, 16, generator=gen)
    errs = card_vs_fp64(block, x)
    assert max(errs) <= FP64_TOL, errs


@pytest.mark.cuda
def test_vae_mid_block_attention_matches_fp64(no_tf32):
    block = seeded(sd_vae.VAEMidBlock(128, 32), 5)
    errs = card_vs_fp64(block, torch.randn(2, 128, 16, 16,
                                           generator=torch.Generator().manual_seed(5)))
    assert max(errs) <= FP64_TOL, errs


@pytest.mark.cuda
def test_generator_training_step_on_the_card_matches_the_cpu(no_tf32):
    net = GeneratorResnet()
    init_weights(net, torch.Generator().manual_seed(6))
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(60))
    found = {}
    for dev in ("cpu", "cuda"):
        surrogate = make_model("resnet18", pretrained=False, input_size=64, device=dev)
        g = copy.deepcopy(net).to(dev).eval().requires_grad_(True)
        loss = ttrain.generator_loss(g, surrogate, x.to(dev), torch.full((2,), 24, device=dev),
                                     16 / 255)
        loss.backward()
        found[dev] = loss.item(), torch.cat([p.grad.flatten().cpu() for p in g.parameters()])
    (loss, grad), (ref, ref_grad) = found["cuda"], found["cpu"]
    assert abs(loss - ref) <= 1e-4 * abs(ref)
    cos = float(grad.double() @ ref_grad.double() / (grad.double().norm() * ref_grad.double().norm()))
    assert cos >= 0.9999, cos


@pytest.mark.cuda
def test_sd_backend_takes_the_card():
    needs_card()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        atk = tt.load_attack_class("diffattack")(
            backend="sd", model_name="toy_cnn", diffusion_steps=4, start_step=1, iterations=1,
            image_size=16, unet=sd_unet.SDUNet(block_out_channels=(32, 64), layers_per_block=1,
                                               heads=2, cross_attention_dim=16, norm_groups=8),
            vae=sd_vae.SDVAE(block_out_channels=(32, 64), layers_per_block=1, groups=8),
            text=sd_text.CLIPTextEncoder(width=16, layers=2, heads=2))
    assert isinstance(atk, tds.SDDiffAttack) and atk.device.type == "cuda"
    x = np.random.RandomState(7).rand(2, 32, 32, 3).astype(np.float32)
    delta = atk(x, np.array([1, 2]))
    assert delta.device.type == "cuda" and bool(torch.isfinite(delta).all())
    adv = torch.from_numpy(x).cuda() + delta
    assert float(adv.min()) >= -1e-6 and float(adv.max()) <= 1 + 1e-6
