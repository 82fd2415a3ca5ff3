"""AIM, the guided-diffusion UNet, DiffPure and DiffAttack on a card.

The UNet's layers where a card path can go wrong on ``channels_last``
tensors (GroupNorm, the attention block's softmax, the down ResBlock's
2×2 average pool and its backward, on DiffAttack's gradient path), each on
the card in fp32 with TF32 off against the same layer in fp64 on the CPU;
AIM's generator and the full ImageNet-256 UNet within ``1e-3·max|ref|`` of
the CPU; the keys take the card by default and launch no update kernel.
Imports no JAX, so it runs on the card's machine:
``python -m pytest --noconftest tests/test_torch_port_diffusion_cuda.py -m cuda``.
"""
import copy
import warnings

import numpy as np
import pytest
import torch

import transferattack_torch as tt
from test_torch_port_generation_cuda import seeded as seeded_generator
from transferattack_torch.defense import gd_unet as tgd
from transferattack_torch.generation.aim import AIMGenerator
from transferattack_torch.ops.fused_update import fused_sign_update

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


def card_vs_fp64(layer, x, *args):
    """(output, input gradient) on the card in fp32 from a channels_last
    input, and in fp64 on the CPU, under one random output gradient."""
    gen = torch.Generator().manual_seed(3)
    results = []
    for dev, dtype, fmt in (("cuda", torch.float32, torch.channels_last),
                            ("cpu", torch.float64, torch.contiguous_format)):
        mod = copy.deepcopy(layer).to(dev, dtype)
        xi = x.to(dev, dtype).contiguous(memory_format=fmt).requires_grad_(True)
        out = mod(xi, *(a.to(dev, dtype) for a in args))
        g = torch.randn(out.shape, generator=gen, dtype=torch.float64).to(dev, dtype)
        (dx,) = torch.autograd.grad(out, xi, g)
        results.append((out, dx))
        gen.manual_seed(3)
    (out, dx), (ref, ref_dx) = results
    return rel(out, ref), rel(dx, ref_dx)


@pytest.mark.cuda
def test_group_norm_on_channels_last_matches_fp64(no_tf32):
    gen = torch.Generator().manual_seed(1)
    norm = tgd.init_nonzero(torch.nn.GroupNorm(32, 128, eps=1e-5), gen)
    x = 2.0 + 3.0 * torch.randn(2, 128, 28, 28, generator=gen)  # off zero mean
    err, err_dx = card_vs_fp64(norm, x)
    assert err <= FP64_TOL and err_dx <= FP64_TOL, (err, err_dx)


@pytest.mark.cuda
def test_attention_softmax_and_maps_match_fp64(no_tf32):
    gen = torch.Generator().manual_seed(2)
    block = tgd.init_nonzero(tgd.AttentionBlock(128, 64), gen)
    x = torch.randn(2, 128, 14, 14, generator=gen)
    err, err_dx = card_vs_fp64(block, x)
    assert err <= FP64_TOL and err_dx <= FP64_TOL, (err, err_dx)
    maps = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        maps[dev] = []
        with torch.no_grad():
            copy.deepcopy(block).to(dev, dtype)(
                x.to(dev, dtype).contiguous(memory_format=torch.channels_last), maps[dev])
    (m,), (ref,) = maps["cuda"], maps["cpu"]
    assert m.dtype == torch.float32 and m.shape == (2, 2, 196, 196)
    assert rel(m, ref) <= FP64_TOL
    assert float((m.sum(-1) - 1).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("side", [28, 27])
def test_avg_pool_backward_on_channels_last_matches_fp64(no_tf32, side):
    """The down ResBlock's 2×2 pool (``F.avg_pool2d(x, 2)``): no padding, so
    not the padded pool whose ``channels_last`` backward is wrong on CUDA;
    held all the same, at an odd side too."""
    x = torch.randn(2, 64, side, side, generator=torch.Generator().manual_seed(4))
    err, err_dx = card_vs_fp64(torch.nn.AvgPool2d(2), x)
    assert err <= FP64_TOL and err_dx <= FP64_TOL, (err, err_dx)


@pytest.mark.cuda
@pytest.mark.parametrize("up,down", [(False, True), (True, False)], ids=["down", "up"])
def test_resampling_resblock_matches_fp64(no_tf32, up, down):
    gen = torch.Generator().manual_seed(5)
    block = tgd.init_nonzero(tgd.ResBlock(64, 128, 64, up=up, down=down), gen)
    x, emb = torch.randn(2, 64, 16, 16, generator=gen), torch.randn(2, 128, generator=gen)
    err, err_dx = card_vs_fp64(block, x, emb)
    assert err <= FP64_TOL and err_dx <= FP64_TOL, (err, err_dx)


@pytest.mark.cuda
def test_aim_generator_on_the_card_matches_the_cpu(no_tf32):
    net = seeded_generator(AIMGenerator(), seed=6)
    gen = torch.Generator().manual_seed(60)
    x, guide = torch.rand(2, 3, 64, 64, generator=gen), torch.rand(1, 3, 64, 64, generator=gen)
    with torch.no_grad():
        ref = net(x, guide)
        out = copy.deepcopy(net).cuda()(x.cuda(), guide.cuda())
    assert rel(out, ref) <= CPU_TOL


@pytest.mark.cuda
def test_full_unet_on_the_card_matches_the_cpu(no_tf32):
    """The ImageNet-256 configuration (553M parameters), seeded on the card,
    at 64², two timesteps."""
    with torch.device("cuda"):
        unet = tgd.GuidedDiffusionUNet()
    tgd.init_nonzero(unet, torch.Generator(device="cuda").manual_seed(7))
    gen = torch.Generator().manual_seed(8)
    x, t = torch.randn(2, 3, 64, 64, generator=gen), torch.tensor([15.0, 700.0])
    with torch.no_grad():
        maps = []
        out = unet.to(memory_format=torch.channels_last)(
            x.cuda().contiguous(memory_format=torch.channels_last), t.cuda(), maps).cpu()
        cpu = unet.cpu()
        ref_maps = []
        ref = cpu(x, t, ref_maps)
    assert out.shape == (2, 6, 64, 64) and float(ref[:, :3].std()) > 0.1
    assert rel(out, ref) <= CPU_TOL
    assert len(maps) == len(ref_maps) == 16
    assert max(rel(m, r) for m, r in zip(maps, ref_maps)) <= CPU_TOL


@pytest.mark.cuda
def test_keys_take_the_card_and_launch_no_update_kernel():
    needs_card()
    x = np.random.RandomState(9).rand(2, 32, 32, 3).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        aim = tt.load_attack_class("aim")()
        diff = tt.load_attack_class("diffattack")(model_name="toy_cnn", diffusion_steps=4,
                                                  start_step=3, iterations=2)
    assert aim.device.type == diff.device.type == "cuda"
    fused_sign_update.launches = 0
    d_aim, d_diff = aim(x, None, idx=3), diff(x, np.array([1, 2]))
    assert fused_sign_update.launches == 0
    for d in (d_aim, d_diff):
        assert d.device.type == "cuda" and bool(torch.isfinite(d).all())
        adv = torch.from_numpy(x).cuda() + d
        assert float(adv.min()) >= -1e-6 and float(adv.max()) <= 1 + 1e-6
