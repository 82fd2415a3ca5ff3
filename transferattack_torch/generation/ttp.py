"""Generation-based attacks (counterpart of
``transferattack_tpu/generation/ttp.py``; the reference's
``generation/{ttp,m3d,cdtp,ltp,ge_advgan,dsva,ada}.py``).

Inference only: a pre-trained generator maps images to adversaries in one
forward, and no update kernel runs.  TTP and M3D smooth the output with a
3×3 Gaussian and keep one generator per target class, which the CLI's
per-class loop drives through ``idx``.  Generator weights load from
``$TA_TPU_WEIGHTS_DIR/<prefix>[_<class>].npz`` in the JAX package's flat
layout through the weights bridge.  Without a checkpoint the key records
its fallback, warns, and runs a seeded init of the port's own (a torch
generator seeded ``seed + 101 + key``, ADA ``seed + 131``; JAX's Flax init
draws other values from the same seeds).

No surrogate is built: ``model_name`` is only stored, as in JAX.
``compute_dtype`` is accepted and ignored, as JAX's ``**kwargs`` swallow it,
so a ``--bf16`` run keeps the generator in fp32.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..attack import draw
from ..models import aux_path, load_aux, nhwc, resolve_device
from ..ops.kernels import smooth_conv
from ..utils import generation_target_classes, img_max, img_min
from .generators import LATENT_DIM, ADAGenerator, AdvGANGenerator, GeneratorResnet


def _ttp_gaussian_kernel(kernel_size=3, sigma=1):
    """TTP's smoothing kernel (``ttp.py:get_gaussian_kernel``)."""
    coords = np.arange(kernel_size)
    grid = np.stack(np.meshgrid(coords, coords, indexing="ij"), -1).astype(np.float32)
    mean = (kernel_size - 1) / 2.0
    k = np.exp(-((grid - mean) ** 2).sum(-1) / (2 * sigma**2))
    return (k / k.sum()).astype(np.float32)


class GenerativeAttack:
    """Base: ``delta = clip(G(x) − x, ±eps)``; per-target-class checkpoints.
    ``forwards`` counts the generator forwards of the instance's calls."""

    # one generator forward a batch, prepared in a ``__call__`` of its own
    # (checkpoint, target class): runs whole on every rank
    host_state = True
    ckpt_prefix = ""
    targeted_generators = False   # one generator per generation target class
    smooth = False
    generator_cls = GeneratorResnet
    requires_batchsize: Optional[int] = None
    fallback_name: Optional[str] = None  # what a missing checkpoint is recorded as

    def __init__(self, model_name="resnet50", eps=16 / 255, targeted=False, seed=0,
                 attack=None, device="cuda", **kwargs):
        self.model_name = model_name
        self.eps = float(eps)
        self.seed = int(seed)
        self.attack = attack or type(self).__name__
        self.targeted = targeted
        self.device = resolve_device(device)
        self.forwards = 0
        self._generators = {}  # cache key -> loaded generator (JAX's ``_var_cache``)

    def checkpoint(self, idx: int):
        """(cache key, checkpoint name, fallback seed) of target index ``idx``."""
        key = idx if self.targeted_generators else 0
        name = (f"{self.ckpt_prefix}_{generation_target_classes[idx]}"
                if self.targeted_generators else self.ckpt_prefix)
        return key, name, self.seed + 101 + key

    def generator(self, idx: int = 0) -> nn.Module:
        """The generator of target index ``idx``, loaded once; a missing
        checkpoint is recorded under the key's prefix."""
        key, name, seed = self.checkpoint(idx)
        if key not in self._generators:
            net = load_aux(self.generator_cls(), name, seed, self.device,
                           fallback=self.fallback_name or self.ckpt_prefix)
            self._generators[key] = net.to(memory_format=torch.channels_last)
        return self._generators[key]

    def generate(self, net: nn.Module, x: torch.Tensor) -> torch.Tensor:
        adv = nhwc(net, x)
        if self.smooth:
            adv = smooth_conv(adv, _ttp_gaussian_kernel())
        return torch.clamp(adv - x, -self.eps, self.eps)

    def __call__(self, data, label, generator: Optional[torch.Generator] = None,
                 idx: int = 0) -> torch.Tensor:
        """``data``: (B, H, W, C) float in [0, 1].  Returns delta as a tensor
        on the attack's device; ``label`` and ``generator`` are not read."""
        x = torch.as_tensor(data, dtype=torch.float32, device=self.device).contiguous()
        net = self.generator(idx)
        self.forwards += 1
        with torch.no_grad():
            return self.generate(net, x)


class TTP(GenerativeAttack):
    """Targeted transferable perturbations (``ttp.py:11-61``)."""

    ckpt_prefix = "ttp_resnet50"
    targeted_generators = True
    smooth = True

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("targeted", True)
        super().__init__(*args, **kwargs)


class M3D(TTP):
    """Min-max model discrepancy generators (``m3d.py:11-177``)."""

    ckpt_prefix = "m3d_resnet50"


class CDTP(GenerativeAttack):
    """Cross-domain transferable perturbation (``cdtp.py:136-170``): one
    generator, untargeted, no smoothing.  ``domain=`` selects
    ``cdtp_<domain>.npz`` (the upstream release trains one generator a
    source domain), falling back to the flat ``cdtp.npz`` lookup."""

    ckpt_prefix = "cdtp"

    def __init__(self, *args, domain: str = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.domain = domain

    def checkpoint(self, idx: int):
        if self.domain and aux_path(f"cdtp_{self.domain}") is not None:
            return "domain", f"cdtp_{self.domain}", None
        return super().checkpoint(idx)


class LTP(GenerativeAttack):
    """Learned transferable perturbation via mid-level feature loss
    (``ltp.py:7-236``)."""

    ckpt_prefix = "ltp"


class GE_ADVGAN(GenerativeAttack):
    """Gradient-editing AdvGAN (``ge_advgan.py:108-180``): the generator's
    ``tanh`` output is the perturbation, cropped to the input where torch's
    shape arithmetic grew it (odd sides), clipped to ±eps and into the
    image box."""

    ckpt_prefix = "ge_advgan"
    generator_cls = AdvGANGenerator

    def generate(self, net, x):
        pert = nhwc(net, x)[:, :x.shape[1], :x.shape[2]]
        delta = torch.clamp(pert, -self.eps, self.eps)
        return torch.clamp(x + delta, img_min, img_max) - x


class DSVA(GenerativeAttack):
    """Generator trained against DINO+MAE ViT features (``dsva.py:124-175``)."""

    ckpt_prefix = "dsva"


class ADA(GenerativeAttack):
    """Adversarial-distribution U-Net with a stochastic latent
    (``ada.py:10-203``): one 16-d normal z per image (the reference doubles
    the batch and keeps the first half), the ``tanh`` output the
    perturbation, clipped to ±eps and into the image box.  Sides are
    edge-padded up to ≡ 3 (mod 4) and the output cropped back (224 → 227;
    299 is not padded).  z comes from ``generator``, else from a generator
    on the attack's device seeded ``seed + idx`` (JAX: ``PRNGKey(seed +
    idx)``), or is given as ``z``."""

    ckpt_prefix = "ada"
    generator_cls = ADAGenerator

    def checkpoint(self, idx: int):
        return 0, self.ckpt_prefix, self.seed + 131

    def __call__(self, data, label, generator: Optional[torch.Generator] = None,
                 idx: int = 0, z: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = torch.as_tensor(data, dtype=torch.float32, device=self.device).contiguous()
        H, W = x.shape[1], x.shape[2]
        ph, pw = (3 - H % 4) % 4, (3 - W % 4) % 4
        if z is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(self.seed + idx)
            z = draw(generator, torch.randn, (x.shape[0], LATENT_DIM), device=self.device)
        z = torch.as_tensor(z, dtype=torch.float32, device=self.device)
        net = self.generator(idx)
        self.forwards += 1
        with torch.no_grad():
            # numpy's "edge" pad is torch's "replicate", on NCHW
            xg = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="replicate")
            pert = nhwc(net, xg.permute(0, 2, 3, 1), z)[:, :H, :W]
            delta = torch.clamp(pert, -self.eps, self.eps)
            return torch.clamp(x + delta, img_min, img_max) - x
