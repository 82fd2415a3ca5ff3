"""The port's input-transformation keys, ANDA and MUMODIG on a card.

Each key once at full width (ResNet-50, bf16, 224², batch 2, one iteration,
few copies): a finite delta inside the eps-ball and [0, 1], and the
update-kernel launches its code implies (none for ANDA, which clips on its
own); and each on the card against the CPU (ResNet-18 at 64², fp32 with TF32
off), every draw from one seeded CPU generator handed to both calls: the
deltas agree in sign on more than 99% of elements (DeCowA at rho 0, and its
map step by its gradient's cosine).  Imports no JAX, so it runs on the card's
machine:
``python -m pytest --noconftest tests/test_torch_port_input_cuda.py -m cuda``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import transferattack_torch as tt
from transferattack_torch.models import make_model
from transferattack_torch.ops.fused_update import fused_sign_update

EPS = 16 / 255
KEYS = ["dim", "dem", "tim", "sim", "admix", "usmm", "ssm", "ssm_h", "ssm_p", "maskblock",
        "sia", "bsr", "mfi", "decowa", "ops", "su", "l2t", "anda", "mumodig"]
SMALL = {"admix": {"num_scale": 2}, "usmm": {"num_scale": 2},
         "ssm": {"num_spectrum": 2, "sample_chunk": 2}, "ssm_h": {"num_spectrum": 2},
         "sia": {"num_scale": 4}, "bsr": {"num_scale": 4}, "decowa": {"num_warping": 2},
         "ops": {"num_sample_neighbor": 2, "num_sample_operator": 2}, "anda": {"n_ens": 4},
         "mumodig": {"N_trans": 2}}
# DeCowA's map step differentiates bilinear sampling across its kinks, where
# the card and the CPU may take either side's slope: its signs are held at
# rho 0, its map step by the gradient's cosine
SIGNS = {"decowa": {"rho": 0.0}}


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture(scope="module")
def resnet50():
    needs_card()
    model = make_model("resnet50", pretrained=False, device="cuda")
    model.module.to(torch.bfloat16)
    model.compute_dtype = torch.bfloat16
    return model


@pytest.mark.cuda
@pytest.mark.parametrize("key", KEYS)
def test_key_runs_at_full_width_on_the_card(resnet50, key):
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.rand(2, 224, 224, 3).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.randint(0, 1000, size=2)).cuda()
    atk = tt.load_attack_class(key)(model_name=resnet50, compute_dtype="bfloat16",
                                    epoch=1, device="cuda", **SMALL.get(key, {}))
    fused_sign_update.launches = 0
    delta = atk(x, y)
    torch.cuda.synchronize()
    assert fused_sign_update.launches == (0 if key == "anda" else 1)
    assert bool(torch.isfinite(delta).all())
    assert 0 < float(delta.abs().max()) <= EPS + 1e-6
    assert float((x + delta).min()) >= -1e-6 and float((x + delta).max()) <= 1 + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("key", KEYS)
def test_key_on_the_card_agrees_with_the_cpu(key):
    needs_card()
    rng = np.random.RandomState(6)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    y = rng.randint(0, 1000, size=2)
    out = {}
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in ("cuda", "cpu"):
            model = make_model("resnet18", pretrained=False, input_size=64, device=dev)
            atk = tt.load_attack_class(key)(model_name=model, device=dev, epoch=2,
                                            **SMALL.get(key, {}), **SIGNS.get(key, {}))
            out[dev] = atk(x, y, generator=torch.Generator().manual_seed(7)).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    agree = (np.sign(out["cuda"]) == np.sign(out["cpu"])).mean()
    assert np.abs(out["cuda"]).max() <= EPS + 1e-6
    assert agree > 0.99


@pytest.mark.cuda
def test_decowa_map_step_on_the_card_agrees_with_the_cpu():
    """DeCowA at its official rho: each card step from the CPU's state, with
    the same draws, gives the CPU's gradient to a cosine above 0.99 (its
    signs are not held: see ``SIGNS``)."""
    needs_card()
    rng = np.random.RandomState(6)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    y = rng.randint(0, 1000, size=2)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        atks, xs, ys = {}, {}, {}
        for dev in ("cuda", "cpu"):
            model = make_model("resnet18", pretrained=False, input_size=64, device=dev)
            atks[dev] = tt.load_attack_class("decowa")(model_name=model, device=dev, epoch=2,
                                                       num_warping=2)
            xs[dev], ys[dev] = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        gen = torch.Generator().manual_seed(7)
        state = atks["cpu"].init_state(xs["cpu"], ys["cpu"], gen)
        for t in range(2):
            on_card = dataclasses.replace(state, delta=state.delta.cuda(),
                                          momentum=state.momentum.cuda())
            g = {dev: atks[dev].get_grad(xs[dev], ys[dev], on_card if dev == "cuda" else state,
                                         torch.Generator().manual_seed(50 + t))[0].cpu()
                 for dev in atks}
            assert float((g["cuda"] * g["cpu"]).sum() / g["cuda"].norm() / g["cpu"].norm()) > 0.99
            state = atks["cpu"].step(xs["cpu"], ys["cpu"], state, gen)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
