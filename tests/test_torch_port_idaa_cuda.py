"""IDAA, Everywhere and ODI, their field warps and the mesh rasterizer on a
card.

On the card against the CPU, fp32 with TF32 off, one seeded CPU generator's
draws on both: each of IDAA's ten ops (its field, its warp and the warp's
input gradient within ``1e-5·max``); the rasterizer on each of ODI's meshes
at 64² (hit masks equal on at least 99.9% of pixels, face ids where both
hit, colours within 1e-5 where they agree); ``grid_sample``'s and the
texture gather's (``index_put`` with accumulation) backwards against fp64
on the CPU in two memory formats each; each key on
ResNet-18 at 64² (deltas agreeing in sign on at least 99% of elements).  At
full width (ResNet-50, bf16, 224², batch 2, few iterations): bounds and the
update-kernel launches its code implies (IDAA none, Everywhere epoch − 1,
ODI epoch).  Imports no JAX, so it runs on the card's machine:
``python -m pytest --noconftest tests/test_torch_port_idaa_cuda.py -m cuda``.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import transferattack_torch as tt
from transferattack_torch.input_transformation import idaa as tidaa
from transferattack_torch.models import make_model
from transferattack_torch.ops import image as timage
from transferattack_torch.ops import render3d
from transferattack_torch.ops.fused_update import fused_sign_update

EPS = 16 / 255
TOL = 1e-5
MESHES = ("pack", "pillow", "book")


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


def rel(a, b):
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


FIELDS = {"perspective": lambda d: tidaa.perspective_field(d["d"], 64, 64),
          "tps": lambda d: timage.tps_field(d["offsets"], 64, 64),
          "elastic": lambda d: (timage.gaussian_blur_sep(d["noise"], 27, 33.0, 31.0),),
          "fisheye": lambda d: timage.fisheye_field(d["cx"], d["cy"], d["g"], 64, 64)}


@pytest.mark.cuda
@pytest.mark.parametrize("op", tidaa.IDAA_OPS)
def test_op_on_the_card_agrees_with_the_cpu(op, no_tf32):
    gen = torch.Generator().manual_seed(tidaa.IDAA_OPS.index(op))
    x = torch.rand(4, 64, 64, 3, generator=gen)
    ct = torch.randn(4, 64, 64, 3, generator=gen)
    d = tidaa.op_draws(gen, op, 4, 64, 64)
    res = {}
    for dev in ("cuda", "cpu"):
        dd = {k: v.to(dev) for k, v in d.items()}
        xs = x.to(dev).requires_grad_(True)
        out = tidaa.apply_op(op, xs, **dd)
        (g,) = torch.autograd.grad((out * ct.to(dev)).sum(), xs)
        res[dev] = (out, g, FIELDS[op](dd) if op in FIELDS else ())
    assert rel(res["cuda"][0], res["cpu"][0]) <= TOL
    assert rel(res["cuda"][1], res["cpu"][1]) <= TOL
    for a, b in zip(res["cuda"][2], res["cpu"][2]):
        assert rel(a, b) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["NCHW", "channels_last"])
def test_grid_sample_backward_against_fp64(fmt):
    needs_card()
    gen = torch.Generator().manual_seed(1)
    x = torch.rand(4, 3, 48, 40, generator=gen, dtype=torch.float64)
    grid = torch.rand(4, 48, 40, 2, generator=gen, dtype=torch.float64) * 2.4 - 1.2
    ct = torch.randn(4, 3, 48, 40, generator=gen, dtype=torch.float64)

    def grad(inp, g, c):
        inp = inp.detach().requires_grad_(True)
        out = F.grid_sample(inp, g, mode="bilinear", padding_mode="zeros", align_corners=False)
        return torch.autograd.grad((out * c).sum(), inp)[0]

    layout = torch.channels_last if fmt == "channels_last" else torch.contiguous_format
    xc = x.float().cuda().contiguous(memory_format=layout)
    assert rel(grad(xc, grid.float().cuda(), ct.float().cuda()), grad(x, grid, ct)) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["NHWC", "channels_last"])
def test_texture_gather_backward_against_fp64(fmt):
    """The gather ``texture[b, v, u]`` of ``shade``, whose backward is
    ``index_put`` with accumulation (many pixels read one texel)."""
    needs_card()
    gen = torch.Generator().manual_seed(2)
    tex = torch.rand(2, 96, 80, 3, generator=gen, dtype=torch.float64)
    v = torch.randint(0, 96, (2, 4096), generator=gen)
    u = torch.randint(0, 80, (2, 4096), generator=gen)
    w = torch.rand(2, 4096, 1, generator=gen, dtype=torch.float64)
    ct = torch.randn(2, 4096, 3, generator=gen, dtype=torch.float64)
    b = torch.arange(2)[:, None]

    def grad(t, *idx_w_ct):
        bb, vv, uu, ww, cc = idx_w_ct
        t = t.detach().requires_grad_(True)
        return torch.autograd.grad((t[bb, vv, uu] * ww * cc).sum(), t)[0]

    t = tex.float().cuda()
    if fmt == "channels_last":
        t = t.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    got = grad(t, b.cuda(), v.cuda(), u.cuda(), w.float().cuda(), ct.float().cuda())
    assert rel(got, grad(tex, b, v, u, w, ct)) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", MESHES)
def test_rasterizer_on_the_card_agrees_with_the_cpu(mesh, no_tf32):
    gen = torch.Generator().manual_seed(10 + MESHES.index(mesh))
    settings, tex_size = render3d.ODI_MODEL_SETTINGS[mesh], render3d.ODI_TEXTURE_SIZES[mesh]
    img = F.interpolate(torch.rand(4, 3, 8, 8, generator=gen), size=(64, 64), mode="bilinear",
                        align_corners=True).permute(0, 2, 3, 1).contiguous()
    elev, azim, angle = (torch.randint(-35, 36, (4,), generator=gen) for _ in range(3))
    draws = {"solid": torch.rand(4, 3, generator=gen), "elev": elev, "azim": azim,
             "dist": torch.rand(4, generator=gen), "angle": angle,
             "light": torch.rand(4, 3, generator=gen), "ambient": torch.rand(4, generator=gen),
             "diffuse": torch.rand(4, generator=gen),
             "background": torch.rand(4, 64, 64, 3, generator=gen)}
    geo, col = {}, {}
    R, T = render3d.odi_camera(settings, draws)
    for dev in ("cuda", "cpu"):
        m = render3d.load_mesh(mesh, device=dev)
        geo[dev] = [t.cpu() for t in render3d.rasterize(m, R, T, 64, 64)]
        col[dev] = render3d.render_odi(img.to(dev), m, settings, tex_size, draws, 64, 64).cpu()
    (hc, fc, _), (hp, fp, _) = geo["cuda"], geo["cpu"]
    assert hp.float().mean() > 0.05, "the object is in view"
    assert (hc == hp).float().mean() >= 0.999
    both = hc & hp
    same = (fc == fp) & both
    assert same.float().sum() >= 0.999 * both.float().sum()
    diff = (col["cuda"] - col["cpu"]).abs().amax(-1).reshape(4, -1)
    assert float(diff[same].max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["idaa", "everywhere", "odi"])
def test_key_on_the_card_agrees_with_the_cpu(key, no_tf32):
    rng = np.random.RandomState(6)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    y = rng.randint(0, 1000, size=2)
    y2 = np.stack([y, (y + 500) % 1000], 1)
    kw = {"idaa": {"num_scale": 4, "epoch": 2}, "everywhere": {"epoch": 3},
          "odi": {"epoch": 2}}[key]
    out = {}
    for dev in ("cuda", "cpu"):
        model = make_model("resnet18", pretrained=False, input_size=64, device=dev)
        atk = tt.load_attack_class(key)(model_name=model, device=dev, **kw)
        out[dev] = atk(x, y2, generator=torch.Generator().manual_seed(7)).cpu().numpy()
    agree = (np.sign(out["cuda"]) == np.sign(out["cpu"])).mean()
    assert agree >= 0.99, f"{key}: delta sign agreement card vs CPU {agree:.4f}"


@pytest.fixture(scope="module")
def resnet50():
    needs_card()
    model = make_model("resnet50", pretrained=False, device="cuda")
    model.module.to(torch.bfloat16)
    model.compute_dtype = torch.bfloat16
    return model


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["idaa", "everywhere", "odi"])
def test_key_runs_at_full_width_on_the_card(resnet50, key):
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.rand(2, 224, 224, 3).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.randint(0, 1000, size=2)).cuda()
    atk = tt.load_attack_class(key)(model_name=resnet50, compute_dtype="bfloat16", epoch=2,
                                    device="cuda")
    fused_sign_update.launches = 0
    delta = atk(x, torch.stack([y, (y + 500) % 1000], 1))
    torch.cuda.synchronize()
    assert fused_sign_update.launches == {"idaa": 0, "everywhere": 1, "odi": 2}[key]
    assert bool(torch.isfinite(delta).all())
    assert 0 < float(delta.abs().max()) <= EPS + 1e-6
    assert float((x + delta).min()) >= -1e-6 and float((x + delta).max()) <= 1 + 1e-6
