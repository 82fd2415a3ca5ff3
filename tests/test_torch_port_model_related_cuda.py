"""The port's ResNet gradient surgery and its 18 CNN keys of
``model_related/`` on a card.

Each surgery mode's input gradient on the card against the CPU (ResNet-18 at
64², fp32 with TF32 off): within ``1e-3·max|ref|``.  Each key once at full
width (its default surrogate, ResNet-50 or ResNet-18, bf16, 224², batch 2,
one iteration, short inner loops): a finite delta inside the eps-ball and
[0, 1], and the update-kernel launches its code implies.  Imports no JAX, so
it runs on the card's machine:
``python -m pytest --noconftest tests/test_torch_port_model_related_cuda.py -m cuda``.
The card-against-CPU agreement of every key is chip_smoke's phase 14a.
"""
import warnings

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import transferattack_torch as tt
from transferattack_torch.models import make_model
from transferattack_torch.models.resnet import SurgeryConfig
from transferattack_torch.ops.fused_update import fused_sign_update

EPS = 16 / 255
KEYS = ["sgm", "linbp", "iaa", "bpa", "ghost", "dhf", "mup", "awt", "faug", "dra", "mta",
        "dsm", "ags", "ma", "ana", "qaa", "metassa", "llta"]
# one iteration of each loop; AWT's SAM rate as chip_smoke's phase 14b takes
# it (at the official 0.002 one step saturates a seeded random ResNet-50's
# softmax and the input gradient is exactly 0)
ONE = {"awt": {"num_neighbor": 2, "sample_chunk": 2, "sam_lr": 2e-4}, "metassa": {"n_sample": 2},
       "llta": {"inner_iters": 1, "nsample": 2, "task_num": 1, "spt_size": 3, "qry_size": 2}}
SURGERY = {
    "sgm": {"gamma": 0.2}, "linbp": {"linbp_start": 5},
    "iaa": {"softplus_beta": 20.0, "residual_scale": (0.98, 0.87, 0.73, 0.19)},
    "bpa": {"bpa_start": 5, "bpa_maxpool": True}, "ghost": {"ghost_range": 0.16},
}


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


def model_related_launches(key, atk) -> int:
    return atk.epoch * (atk.n_sample + 1) if key == "metassa" else atk.epoch


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(SURGERY) + ["decay"])
def test_surgery_gradient_on_the_card_agrees_with_the_cpu(fp32, mode):
    rng = np.random.RandomState(3)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    y = torch.tensor([3, 7])
    gammas = torch.from_numpy(rng.uniform(0.2, 1.5, (2, 4)).astype(np.float32))
    grads = {}
    for where in ("cuda", "cpu"):
        model = make_model("resnet18", pretrained=False, input_size=64, device=where,
                           surgery=SurgeryConfig(**SURGERY.get(mode, {})))
        kw = {}
        if mode == "ghost":
            scales = torch.Generator().manual_seed(4)
            kw["ghost"] = lambda kind, name, shape: (
                torch.rand(shape, generator=scales) * 0.32 + 0.84).to(where)
        if mode == "decay":
            kw["gammas"] = gammas.to(where)
        xt = torch.from_numpy(x).to(where).requires_grad_(True)
        F.cross_entropy(model.apply(xt, **kw), y.to(where)).backward()
        grads[where] = xt.grad.cpu()
    ref = grads["cpu"]
    err = float((grads["cuda"] - ref).abs().max() / ref.abs().max())
    assert err <= 1e-3, f"{mode}: max|card - CPU| / max|CPU| = {err:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("key", KEYS)
def test_key_runs_at_full_width_on_the_card(key):
    needs_card()
    x = torch.rand((2, 224, 224, 3), generator=torch.Generator().manual_seed(5)).cuda()
    kw = {"epoch": 1, **ONE.get(key, {})}
    with warnings.catch_warnings():  # no checkpoints here: the base weights
        warnings.simplefilter("ignore")
        atk = tt.load_attack_class(key)(compute_dtype="bfloat16", device="cuda", **kw)
    with torch.no_grad():
        y = atk.model.apply(x).argmax(-1)
    fused_sign_update.launches = 0
    delta = atk(x, y)
    torch.cuda.synchronize()
    assert fused_sign_update.launches == model_related_launches(key, atk)
    assert bool(torch.isfinite(delta).all())
    assert 0 < float(delta.abs().max()) <= EPS + 1e-6
    adv = x + delta
    assert float(adv.min()) >= -1e-6 and float(adv.max()) <= 1 + 1e-6
