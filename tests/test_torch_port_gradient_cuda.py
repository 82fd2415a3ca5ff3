"""The port's gradient family on a card against the CPU.

One deterministic key (MIG) and one seamed key (VMI-FGSM, its draws from one
numpy bank through ``neighbor_noise``) on one seeded ResNet-18 at 64², fp32
with TF32 off: the deltas must agree in sign on more than 99% of elements.
Imports no JAX, so it runs on the card's machine:
``python -m pytest --noconftest tests/test_torch_port_gradient_cuda.py -m cuda``.
"""
import numpy as np
import pytest
import torch

import transferattack_torch as tt
from transferattack_torch.models import make_model

EPS, EPOCH, BATCH, SIZE = 16 / 255, 3, 4, 64


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["mig", "vmifgsm"])
def test_key_on_the_card_agrees_with_the_cpu(key):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(6)
    x = rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32)
    y = rng.randint(0, 1000, size=BATCH)
    bank = torch.from_numpy(rng.uniform(-EPS, EPS, (EPOCH, BATCH, SIZE, SIZE, 3))
                            .astype(np.float32))
    kw = {"epoch": EPOCH, **({"num_neighbor": 1} if key == "vmifgsm" else {})}
    out = {}
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in ("cuda", "cpu"):
            model = make_model("resnet18", pretrained=False, input_size=SIZE, device=dev)
            atk = tt.load_attack_class(key)(model_name=model, device=dev, **kw)
            atk.neighbor_noise = lambda gen, xx, state: bank[state.step].to(xx.device)
            out[dev] = atk(x, y).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    assert (np.sign(out["cuda"]) == np.sign(out["cpu"])).mean() > 0.99
    assert np.abs(out["cuda"]).max() <= EPS + 1e-6
