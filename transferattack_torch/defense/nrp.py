"""NRP, the neural representation purifier (counterpart of
``transferattack_tpu/defense/nrp.py``; the reference's
``defense/nrp/{networks.py,purify.py}``).

The RRDB purifier NRP(3, 3, 64, 23), NCHW, with ESRGAN's module names
(``conv_first``, ``RRDB_trunk.{i}.RDB{k}.conv{m}``, ``trunk_conv``) and no
global residual, as JAX has it.  ``run_nrp`` purifies the adversarial PNGs
into ``purified_dir`` for a normal ``--eval`` pass; its dynamic mode adds
``0.05·N(0, 1)`` to each batch and clips the result to ``x ± 16/255`` (not
to [0, 1], as JAX: ``purify.py:26-63``).  The noise comes from a
``torch.Generator`` seeded ``seed``, one draw a batch on its own device, or
from ``noises``, one array a batch.

The purifier: ``$TA_TPU_WEIGHTS_DIR/nrp.npz`` through the weights bridge,
else a warning, ``nrp`` recorded and ``init_weights`` from a torch generator
seeded 3 (JAX: ``PRNGKey(3)``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..attack import draw
from ..models import load_aux, nhwc, resolve_device
from ..utils.data import AdvDataset, save_images


def _conv(n_in: int, n_out: int) -> nn.Conv2d:
    return nn.Conv2d(n_in, n_out, 3, padding=1)


class ResidualDenseBlock5C(nn.Module):
    """Five 3×3 convs, each after the first reading ``[x, x1, …]``; leaky
    ReLU 0.2 after the first four; ``x5·0.2 + x``."""

    def __init__(self, nf: int = 64, gc: int = 32):
        super().__init__()
        self.conv1, self.conv2, self.conv3, self.conv4 = (
            _conv(nf + k * gc, gc) for k in range(4))
        self.conv5 = _conv(nf + 4 * gc, nf)

    def forward(self, x):
        feats = [x]
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            feats.append(F.leaky_relu(conv(torch.cat(feats, 1)), 0.2))
        return self.conv5(torch.cat(feats, 1)) * 0.2 + x


class RRDB(nn.Module):
    def __init__(self, nf: int = 64, gc: int = 32):
        super().__init__()
        self.RDB1, self.RDB2, self.RDB3 = (ResidualDenseBlock5C(nf, gc) for _ in range(3))

    def forward(self, x):
        return self.RDB3(self.RDB2(self.RDB1(x))) * 0.2 + x


class NRPNet(nn.Module):
    """NRP(in=3, out=3, nf=64, nb=23) (``networks.py:46-61``)."""

    def __init__(self, nb: int = 23, nf: int = 64, gc: int = 32):
        super().__init__()
        self.conv_first = _conv(3, nf)
        self.RRDB_trunk = nn.Sequential(*(RRDB(nf, gc) for _ in range(nb)))
        self.trunk_conv = _conv(nf, 3)

    def forward(self, x):
        return self.trunk_conv(self.RRDB_trunk(self.conv_first(x)))


def load_purifier(nb: int = 23, ckpt: str = "nrp", device="cuda") -> NRPNet:
    """The purifier from ``<ckpt>.npz``, or the seeded fallback, recorded as
    ``nrp``; frozen, in eval mode, on ``device``."""
    net = load_aux(NRPNet(nb=nb), ckpt, 3, resolve_device(device), fallback="nrp")
    return net.to(memory_format=torch.channels_last)


def run_nrp(input_dir: str, output_dir: str, purified_dir: str, batchsize: int = 8,
            dynamic: bool = False, seed: int = 0, nb: int = 23, device="cuda",
            noises: Optional[Sequence[np.ndarray]] = None) -> str:
    """Purify the adversarial PNGs of ``output_dir`` into ``purified_dir``
    (``purify.py:26-63``), the output clipped to [0, 1]; returns
    ``purified_dir``."""
    dev = resolve_device(device)
    net = load_purifier(nb=nb, device=dev)
    ds = AdvDataset(input_dir=input_dir, output_dir=output_dir, eval_mode=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    eps = 16 / 255
    with torch.inference_mode():
        for b, (xs, _, names) in enumerate(ds.as_batches(batchsize)):
            x = torch.from_numpy(xs).to(dev)
            if dynamic:
                z = (draw(gen, torch.randn, tuple(x.shape), device=dev) if noises is None
                     else torch.as_tensor(noises[b], dtype=torch.float32, device=dev))
                x = torch.clamp(x + 0.05 * z, x - eps, x + eps)
            purified = torch.clamp(nhwc(net, x), 0.0, 1.0)
            save_images(purified_dir, purified.cpu().numpy(), names)
    return purified_dir
