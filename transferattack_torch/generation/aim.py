"""AIM and DiffAttack (counterpart of ``transferattack_tpu/generation/aim.py``;
the reference's ``generation/{aim,diffattack}.py``).

AIM: a GeneratorResnet conditioned on a guide image of the target class,
``concat(x, guide)`` in, one generator a target class.  The ten guides are
the port's own asset, ``assets/aim/guides.npz``: the reference's JPEGs
decoded to uint8 at their native sizes, because the card's machine has no
JPEG decoder.  Each is resized to the input's side with PIL's default
filter for RGB, bicubic (``utils/png.resize_bicubic``, bit for bit), as
JAX resizes the JPEG.

DiffAttack: with the converted Stable Diffusion weights present it is
``diffattack_sd.SDDiffAttack``; else ``DiffAttackGD``: DDIM inversion of the image to step
``start_step`` with DiffPure's guided-diffusion UNet, AdamW on that latent
against the surrogate's cross-entropy, the self-attention maps' distance to
the clean trajectory's and the variance of a pseudo cross-attention, then a
DDIM decode.  Not eps-bounded: the delta is the decoded image minus x.
"""
from __future__ import annotations

import os
import warnings
from typing import List, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..attack import softmax_cross_entropy
from ..models import make_model, nhwc, record_fallback, resolve_device, weights_root
from ..utils import generation_target_classes
from ..utils.bridge import save_flat_variables
from ..utils.png import read_png, resize_bicubic
from .generators import GeneratorResnet
from .ttp import GenerativeAttack

GUIDES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "assets", "aim",
                      "guides.npz")


class AIMGenerator(nn.Module):
    """``concat(x, guide)`` → GeneratorResnet with a 6-channel stem, named
    ``body`` as JAX's (``params/body/...``).  NCHW; the guide broadcasts
    over the batch."""

    def __init__(self):
        super().__init__()
        self.body = GeneratorResnet(in_channels=6)

    def forward(self, x, guide):
        return self.body(torch.cat([x, guide.expand_as(x)], dim=1))


def load_guide(cls: int, height: int, width: int) -> Optional[np.ndarray]:
    """The guide of target class ``cls`` at (height, width) as float32 in
    [0, 1]: from the port's npz, else ``$TA_TPU_WEIGHTS_DIR/aim_guide_<cls>.png``;
    None when neither has it."""
    img = None
    with np.load(GUIDES) as guides:
        if str(cls) in guides.files:
            img = guides[str(cls)]
    png = os.path.join(weights_root(), f"aim_guide_{cls}.png")
    if img is None and os.path.exists(png):
        img = read_png(png)
    if img is None:
        return None
    if img.shape[:2] != (height, width):
        img = resize_bicubic(img, (height, width))
    return img.astype(np.float32) / np.float32(255.0)


class AIM(GenerativeAttack):
    """Targeted semantic injection (``aim.py:235-286``): ``adv = clip(clip(G(x,
    guide), x ± eps), 0, 1)``.  Without a checkpoint ``aim_<class>.npz`` a
    generator is a seeded init of the port's own (a torch generator seeded
    ``seed + 151 + idx``), recorded as ``aim_generator``; a class without a
    guide takes a flat 0.5 one, recorded as ``aim_guides``."""

    ckpt_prefix = "aim"
    targeted_generators = True
    generator_cls = AIMGenerator
    fallback_name = "aim_generator"

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("targeted", True)
        super().__init__(*args, **kwargs)
        self._guides = {}

    def checkpoint(self, idx: int):
        return idx, f"{self.ckpt_prefix}_{generation_target_classes[idx]}", self.seed + 151 + idx

    def save_ckpt(self, idx: int, path: Optional[str] = None) -> str:
        """Write the generator of target index ``idx`` (loaded or drawn
        first if need be) to ``path``, by default ``aim_<class>.npz`` in the
        weights directory, in the JAX package's flat layout.  Returns the
        path."""
        cls = generation_target_classes[idx]
        path = path or os.path.join(weights_root(), f"{self.ckpt_prefix}_{cls}.npz")
        return save_flat_variables(self.generator(idx), path)

    def guide(self, idx: int, height: int, width: int) -> torch.Tensor:
        """(1, height, width, 3) guide of target index ``idx`` on the attack's
        device, cached."""
        key = (idx, height, width)
        if key not in self._guides:
            cls = generation_target_classes[idx]
            img = load_guide(cls, height, width)
            if img is None:
                record_fallback("aim_guides")
                warnings.warn(f"AIM: no guide for class {cls}; a flat 0.5 guide used.")
                img = np.full((height, width, 3), 0.5, np.float32)
            self._guides[key] = torch.from_numpy(img)[None].to(self.device)
        return self._guides[key]

    def __call__(self, data, label, generator: Optional[torch.Generator] = None,
                 idx: int = 0) -> torch.Tensor:
        """``data``: (B, H, W, C) float in [0, 1]; the generator and guide of
        target index ``idx``.  ``label`` and ``generator`` are not read."""
        x = torch.as_tensor(data, dtype=torch.float32, device=self.device).contiguous()
        net = self.generator(idx)
        guide = self.guide(idx, x.shape[1], x.shape[2]).permute(0, 3, 1, 2)
        self.forwards += 1
        with torch.no_grad():
            adv = torch.clamp(nhwc(net, x, guide), x - self.eps, x + self.eps)
            return torch.clamp(adv, 0.0, 1.0) - x


def sd_weights_present() -> bool:
    """Whether the converted Stable Diffusion weights are in the weights
    directory (``diffattack_sd.py:54-58``)."""
    return all(os.path.exists(os.path.join(weights_root(), f"{t}.npz"))
               for t in ("sd_unet", "sd_vae", "sd_text"))


class DiffAttack:
    """The registry's ``diffattack``: ``backend`` ``'auto'`` resolves to
    ``'sd'`` when the Stable Diffusion weights are present, else ``'gd'``,
    which builds :class:`DiffAttackGD` with the other keywords; ``'sd'``
    builds ``diffattack_sd.SDDiffAttack``."""

    def __new__(cls, backend: str = "auto", **kwargs):
        if backend == "auto":
            backend = "sd" if sd_weights_present() else "gd"
        if backend == "sd":
            from .diffattack_sd import SDDiffAttack

            return SDDiffAttack(**kwargs)
        return DiffAttackGD(**kwargs)

    def __init__(self, device="cuda", **kwargs):
        """Never runs (``__new__`` returns another class); it states the
        port's own keyword for ``config.official_defaults``."""


def adamw(params, lr: float) -> torch.optim.AdamW:
    """``optax.adamw(lr)``: weight decay 1e-4 (torch's default is 0.01),
    betas (0.9, 0.999), eps 1e-8."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


class DiffAttackGD:
    """Unrestricted diffusion-latent attack (``diffattack.py:38-1766``) over
    DiffPure's guided-diffusion UNet.

    DDIM-invert ``2x − 1`` to step ``start_step`` of a ``diffusion_steps``
    schedule, record the clean trajectory's attention maps (averaged over
    the decode steps), run ``iterations`` AdamW steps (optax's ``adamw``:
    weight decay 1e-4, betas 0.9 and 0.999, eps 1e-8) on the latent against
    ``∓CE·attack_weight`` + the mean squared distance of the kept maps to
    the clean ones ``·self_attn_weight`` + the variance of the pseudo
    cross-attention ``·cross_attn_weight`` + ``recon_weight·mse(img, x)``,
    and decode.  Maps of at most a quarter of the largest map's tokens are
    kept (all of them when there are two or fewer).  Each decode step is
    recomputed in the backward (``torch.utils.checkpoint``), so the
    memory holds one step's activations.  The surrogate runs in fp32;
    ``compute_dtype`` is swallowed, as JAX's ``**kwargs`` do.  ``losses``
    holds the loss of the last call's first and last iteration.
    """

    requires_batchsize: Optional[int] = None
    # its ``__call__`` inverts and decodes each batch through the UNet: runs
    # whole on every rank
    host_state = True

    def __init__(self, model_name="resnet50", eps=None, diffusion_steps=20,
                 start_step=15, iterations=30, lr=0.01, recon_weight=0.1,
                 attack_weight=10.0, cross_attn_weight=10000.0,
                 self_attn_weight=100.0, targeted=False, seed=0, attack="DiffAttack",
                 device="cuda", **kwargs):
        from ..defense.diffpure import DiffPure

        self.device = resolve_device(device)
        self.surrogate = make_model(model_name, pretrained=kwargs.pop("pretrained", True),
                                    input_size=kwargs.pop("input_size", None),
                                    device=self.device)
        self.dp = DiffPure(t_star=diffusion_steps, device=self.device)
        self.diffusion_steps = int(diffusion_steps)
        self.start_step = int(start_step)
        self.iterations = int(iterations)
        self.lr = float(lr)
        self.recon_weight = float(recon_weight)
        self.attack_weight = float(attack_weight)
        self.cross_attn_weight = float(cross_attn_weight)
        self.self_attn_weight = float(self_attn_weight)
        self.targeted = targeted
        self.seed = int(seed)
        self.attack = attack
        self.losses: List[float] = []

    @property
    def stride(self) -> int:
        return max(self.dp.T // self.diffusion_steps, 1)

    def _ddim_step(self, xt, t: int, t_to: int, maps=None):
        """Deterministic DDIM from timestep ``t`` to ``t_to`` (NHWC)."""
        acum = self.dp.alphas_cum
        eps = self.dp.unet_out(xt, t, maps)[..., :3]  # the variance channels unread
        a_t, a_to = acum[t], acum[t_to]
        x0 = (xt - float(np.sqrt(np.float32(1) - a_t)) * eps) / float(np.sqrt(a_t))
        return float(np.sqrt(a_to)) * x0 + float(np.sqrt(np.float32(1) - a_to)) * eps

    def invert(self, x2):
        """DDIM inversion of ``x2`` in [-1, 1] to step ``start_step``."""
        xt = x2
        for i in range(self.start_step):
            t = i * self.stride
            xt = self._ddim_step(xt, t, min(t + self.stride, self.dp.T - 1))
        return xt

    def _step_with_maps(self, xt, t: int, t_to: int):
        """One decode step and its attention maps; under autograd its
        activations are recomputed in the backward, not kept."""
        def step(xt):
            maps: List[torch.Tensor] = []
            return (self._ddim_step(xt, t, t_to, maps), *maps)

        if torch.is_grad_enabled() and xt.requires_grad:
            xt, *maps = checkpoint(step, xt, use_reentrant=False)
        else:
            xt, *maps = step(xt)
        return xt, maps

    def decode(self, latent, with_maps: bool = False):
        """(image in [0, 1], the attention maps averaged over the steps, or
        None) of a DDIM decode from step ``start_step``."""
        xt, acc = latent, None
        for i in range(self.start_step - 1, -1, -1):
            t = i * self.stride
            t_to = max(t - self.stride, 0)
            if with_maps:
                xt, maps = self._step_with_maps(xt, t, t_to)
                acc = maps if acc is None else [a + m for a, m in zip(acc, maps)]
            else:
                xt = self._ddim_step(xt, t, t_to)
        img = torch.clamp((xt + 1.0) / 2.0, 0.0, 1.0)
        if not with_maps:
            return img, None
        return img, [a / max(self.start_step, 1) for a in (acc or [])]

    @staticmethod
    def attn_keep(base_maps) -> List[int]:
        """Indices of the maps the self-attention term compares: at most a
        quarter of the largest map's tokens (``diffattack.py:703``)."""
        t_cap = max(m.shape[-1] for m in base_maps) if base_maps else 0
        return [i for i, m in enumerate(base_maps)
                if m.shape[-1] <= max(t_cap // 4, 1) or len(base_maps) <= 2]

    @staticmethod
    def self_attn(maps, base_maps, keep) -> torch.Tensor:
        """The kept maps' mean squared distance to the clean ones, averaged
        over ``keep``."""
        return sum(torch.mean((maps[i] - base_maps[i]) ** 2) for i in keep) / len(keep)

    @staticmethod
    def pseudo_cross_attn(maps) -> torch.Tensor:
        """(B, T) received attention of the first map of fewest tokens, mean
        over heads and query rows: the unconditional stand-in for SD's
        true-label cross-attention column."""
        smallest = min(maps, key=lambda m: m.shape[-1])
        return smallest.mean(dim=(1, 2))

    def loss(self, latent, x, y, base_maps, keep):
        """The four-term loss (``diffattack.py:279-287``) at ``latent``."""
        img, maps = self.decode(latent, with_maps=True)
        ce = softmax_cross_entropy(self.surrogate.apply(img), y).mean()
        total = (ce if self.targeted else -ce) * self.attack_weight
        if keep:
            total = total + self.self_attn(maps, base_maps, keep) * self.self_attn_weight
        if maps:
            total = total + torch.var(self.pseudo_cross_attn(maps), correction=0) \
                * self.cross_attn_weight
        return total + self.recon_weight * torch.mean((img - x) ** 2)

    def optimize(self, x, y) -> torch.Tensor:
        """The latent after ``iterations`` AdamW steps from the inversion of
        NHWC ``x`` in [0, 1], against labels ``y``."""
        with torch.no_grad():
            latent0 = self.invert(x * 2.0 - 1.0)
            _, base_maps = self.decode(latent0, with_maps=True)
        keep = self.attn_keep(base_maps)
        latent = latent0.clone().requires_grad_(True)
        opt = adamw([latent], self.lr)
        self.losses = []
        for i in range(self.iterations):
            loss = self.loss(latent, x, y, base_maps, keep)
            latent.grad, = torch.autograd.grad(loss, latent)
            opt.step()
            if i in (0, self.iterations - 1):
                self.losses.append(loss.item())
        return latent.detach()

    def __call__(self, data, label, generator: Optional[torch.Generator] = None,
                 idx: int = 0) -> torch.Tensor:
        """``data``: (B, H, W, C) float in [0, 1]; ``label`` (B,) or, targeted,
        (B, 2) with the target second.  Returns the delta on the attack's
        device; ``generator`` is not read (the attack draws nothing)."""
        x = torch.as_tensor(data, dtype=torch.float32, device=self.device).contiguous()
        label = torch.as_tensor(label)
        y = (label[:, 1] if self.targeted and label.ndim == 2 else label).to(self.device)
        latent = self.optimize(x, y)
        with torch.no_grad():
            return self.decode(latent)[0] - x
