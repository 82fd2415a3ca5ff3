"""The port's 24 advanced-objective keys on a card.

Each key once at full width (ResNet-50, bf16, 224², batch 2, one iteration,
few copies): a finite delta inside the eps-ball and [0, 1], and the
update-kernel launches its code implies (none on the steps that clip on
their own); and each on the card against the CPU (ResNet-18 at 64², fp32
with TF32 off, 2 iterations, taps at layer2/layer3), every draw from one
seeded CPU generator handed to both calls: the deltas agree in sign on more
than 99% of elements.  Imports no JAX, so it runs on the card's machine:
``python -m pytest --noconftest tests/test_torch_port_objective_cuda.py -m cuda``.
"""
import numpy as np
import pytest
import torch

import transferattack_torch as tt
from transferattack_torch.models import make_model
from transferattack_torch.ops.fused_update import fused_sign_update
from transferattack_torch.utils.data import save_images

EPS = 16 / 255
KEYS = ["logit", "logit_margin", "potrip", "taig", "tap", "fuzziness_tuned", "ila", "ilpd",
        "fia", "rpa", "fmaa", "bfa", "naa", "danaa", "aa", "ir", "p2fa", "trap", "ata",
        "mfaa", "yaila", "cfm", "ftm", "fft"]
# one iteration of each loop and few copies (keys whose epoch counts more
# than their main loop say so)
ONE = {"trap": {"epoch": 2, "baseline_epoch": 1}, "taig": {"steps": 4},
       "fia": {"num_ens": 2}, "rpa": {"num_ens": 4}, "fmaa": {"num_ens": 2},
       "bfa": {"num_ens": 2, "warmup_epoch": 1}, "naa": {"N": 2}, "danaa": {"N": 2},
       "p2fa": {"num_ens": 2, "inner_steps": 2}, "mfaa": {"num_ens": 2},
       "yaila": {"ila_epoch": 1}, "fft": {"num_ens": 2, "ft_epoch": 1}}
# ResNet-18 at 64²: its blocks for MFAA, and the feature layers at layer2/3
SMALL18 = {**ONE, "ila": {"feature_layer": "layer2.1"}, "ilpd": {"feature_layer": "layer2.1"},
           "trap": {"epoch": 4, "baseline_epoch": 2},
           "mfaa": {"num_ens": 2, "taps": ("layer4_1", "layer3_1", "layer3_0", "layer2_1",
                                           "layer2_0")},
           "ata": {"layer_name": "layer3"}, "yaila": {"ila_epoch": 1}}
TARGETED = ("logit", "logit_margin", "potrip", "aa", "cfm", "ftm", "fft")


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def expected_launches(key, atk) -> int:
    """The update-kernel launches of one call, as the key's code implies:
    none on the steps with their own clip (P2FA, YAILA, TRAP's second
    phase, BFA's warm-up, FFT's fine-tune), two loops for ILA."""
    if key in ("p2fa", "yaila"):
        return 0
    return 2 * atk.epoch if key == "ila" else atk.epoch


def anchors(tmp_path, size, classes):
    """An AA anchor set: one seeded PNG a class, ``labels.csv`` 1-indexed."""
    names = [f"anchor_{c}.png" for c in classes]
    save_images(str(tmp_path / "images"),
                np.random.RandomState(5).rand(len(names), size, size, 3).astype(np.float32),
                names)
    (tmp_path / "labels.csv").write_text(
        "filename,label\n" + "".join(f"{n},{c + 1}\n" for n, c in zip(names, classes)))
    return str(tmp_path)


def labels(key, y):
    return np.stack([y, (y + 500) % 1000], axis=1) if key in TARGETED else y


@pytest.fixture(scope="module")
def resnet50():
    needs_card()
    model = make_model("resnet50", pretrained=False, device="cuda")
    model.module.to(torch.bfloat16)
    model.compute_dtype = torch.bfloat16
    return model


@pytest.mark.cuda
@pytest.mark.parametrize("key", KEYS)
def test_key_runs_at_full_width_on_the_card(resnet50, key, tmp_path):
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.rand(2, 224, 224, 3).astype(np.float32)).cuda()
    y = rng.randint(0, 1000, size=2)
    kw = {"epoch": 1, **ONE.get(key, {})}
    if key == "aa":
        kw["input_dir"] = anchors(tmp_path, 224, sorted(set(labels(key, y)[:, 1])))
    atk = tt.load_attack_class(key)(model_name=resnet50, compute_dtype="bfloat16",
                                    device="cuda", **kw)
    fused_sign_update.launches = 0
    delta = atk(x, labels(key, y))
    torch.cuda.synchronize()
    assert fused_sign_update.launches == expected_launches(key, atk)
    assert bool(torch.isfinite(delta).all())
    assert 0 < float(delta.abs().max()) <= atk.eps + 1e-6
    assert float((x + delta).min()) >= -1e-6 and float((x + delta).max()) <= 1 + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("key", KEYS)
def test_key_on_the_card_agrees_with_the_cpu(key, tmp_path):
    needs_card()
    rng = np.random.RandomState(6)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    y = rng.randint(0, 1000, size=2)
    kw = {"epoch": 2, **SMALL18.get(key, {})}
    if key == "aa":
        kw["input_dir"] = anchors(tmp_path, 64, sorted(set(labels(key, y)[:, 1])))
    out = {}
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in ("cuda", "cpu"):
            model = make_model("resnet18", pretrained=False, input_size=64, device=dev)
            atk = tt.load_attack_class(key)(model_name=model, device=dev, **kw)
            out[dev] = atk(x, labels(key, y),
                           generator=torch.Generator().manual_seed(7)).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    agree = (np.sign(out["cuda"]) == np.sign(out["cpu"])).mean()
    assert np.abs(out["cuda"]).max() <= atk.eps + 1e-6
    assert agree > 0.99
