"""DiffAttack on the Stable Diffusion stack (counterpart of
``transferattack_tpu/generation/diffattack_sd.py``; the reference's
``generation/diffattack.py:38-1766``).

VAE-encode the image at 512², DDIM-invert the latent to ``start_step`` under
the prompt "a photo of a <class text>", record the clean trajectory's
self-attention maps, run ``iterations`` AdamW steps on the latent against
``∓CE·attack_weight`` + the kept self maps' distance to the clean ones
``·self_attn_weight`` + the variance of the label token's cross-attention
column ``·cross_attn_weight`` + ``recon_weight·mse(img, x)``, then decode
with classifier-free guidance and VAE-decode back to pixels.

The backend runs when ``sd_unet.npz``, ``sd_vae.npz`` and ``sd_text.npz``
are in the weights directory (JAX's flat layout, through the weights
bridge); a missing one is recorded and replaced by a seeded init of the
port's own at Flax's default scales, drawn on the device the module was
built on from a ``torch.Generator`` seeded ``seed + 11``, ``+ 12``, ``+ 13``
(JAX draws ``PRNGKey`` of the same seeds).
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..attack import softmax_cross_entropy
from ..models import load_aux, make_model, resolve_device, weights_root
from ..ops.image import resize
from .aim import DiffAttackGD, adamw
from .sd_text import EOS, MAX_TOKENS, CLIPTextEncoder, SDTokenizer
from .sd_unet import SDUNet
from .sd_vae import SD_VAE_SCALE, SDVAE


def sd_alphas_cumprod(T: int = 1000, beta_start: float = 0.00085,
                      beta_end: float = 0.012) -> np.ndarray:
    """SD's scaled-linear schedule (diffusers' DDIMScheduler defaults), fp32."""
    betas = np.linspace(np.float32(beta_start ** 0.5), np.float32(beta_end ** 0.5), T,
                        dtype=np.float32) ** 2
    return np.cumprod(np.float32(1) - betas, dtype=np.float32)


class SDDiffAttack:
    """Latent optimization over the SD UNet, VAE and CLIP text encoder.

    ``unet``, ``vae``, ``text``: the modules to run (SD-1.5's by default,
    built on the device); each is filled from its npz or the seeded
    fallback (``models.load_aux``, Flax's init scales), as JAX fills its
    variables.  Each decode step under autograd
    (the unconditional and the conditional forward) is recomputed in the
    backward, so memory holds one step's activations.  ``forwards`` counts
    UNet forwards, those recomputed included; ``losses`` holds the loss of
    the last call's first and last iteration.  ``compute_dtype`` is
    swallowed: the stack and the surrogate run in fp32, as in JAX.
    """

    requires_batchsize: Optional[int] = None
    # its ``__call__`` tokenizes the prompts on the host (JAX's flag)
    host_state = True

    def __init__(self, model_name="resnet50", diffusion_steps=20, start_step=15, iterations=30,
                 lr=0.01, guidance=2.5, attack_weight=10.0, cross_attn_weight=10000.0,
                 self_attn_weight=100.0, recon_weight=0.1, image_size=512, targeted=False,
                 seed=0, attack="DiffAttack", unet=None, vae=None, text=None, device="cuda",
                 **kwargs):
        self.device = resolve_device(device)
        self.surrogate = make_model(model_name, pretrained=kwargs.pop("pretrained", True),
                                    input_size=kwargs.pop("input_size", None),
                                    device=self.device)
        def build(module, cls):
            if module is not None:
                return module
            with torch.device("meta"):  # every parameter is loaded or drawn next
                module = cls()
            return module.to_empty(device=self.device)  # so that a fallback draws there

        self.unet, self.vae, self.text = (
            load_aux(build(net, cls), tag, seed + k, self.device)
            .to(memory_format=torch.channels_last)
            for net, cls, tag, k in ((unet, SDUNet, "sd_unet", 11), (vae, SDVAE, "sd_vae", 12),
                                     (text, CLIPTextEncoder, "sd_text", 13)))
        self.tokenizer = SDTokenizer()
        self.T = 1000
        self.alphas_cum = sd_alphas_cumprod(self.T)
        self.diffusion_steps = int(diffusion_steps)
        self.start_step = int(start_step)
        self.iterations = int(iterations)
        self.lr = float(lr)
        self.guidance = float(guidance)
        self.attack_weight = float(attack_weight)
        self.cross_attn_weight = float(cross_attn_weight)
        self.self_attn_weight = float(self_attn_weight)
        self.recon_weight = float(recon_weight)
        self.image_size = int(image_size)
        self.targeted = targeted
        self.seed = int(seed)
        self.attack = attack
        self.forwards = 0
        self.losses: List[float] = []

    # ---- prompt -----------------------------------------------------------

    def class_text(self, idx: int) -> str:
        """Line ``idx`` of ``imagenet_classes.txt`` in the weights directory,
        else ``class <idx>``."""
        path = os.path.join(weights_root(), "imagenet_classes.txt")
        if os.path.exists(path):
            if not hasattr(self, "_classnames"):
                with open(path) as f:
                    self._classnames = [line.strip() for line in f]
            if idx < len(self._classnames):
                return self._classnames[idx]
        return f"class {idx}"

    def prompt_ids(self, labels: np.ndarray):
        """(cond ids, uncond ids, label-token position): the prompts "a photo
        of a <label text>" (``diffattack.py:759``) and "" for classifier-free
        guidance; the label token is the last one before EOS."""
        cond = self.tokenizer([f"a photo of a {self.class_text(int(c))}" for c in labels])
        uncond = self.tokenizer([""] * len(labels))
        return cond, uncond, ((cond != EOS).sum(axis=1) - 1).astype(np.int64)

    # ---- diffusion --------------------------------------------------------

    @property
    def stride(self) -> int:
        return max(self.T // self.diffusion_steps, 1)

    def eps(self, latent, t: int, ctx, maps=None):
        self.forwards += 1
        return self.unet(latent, torch.full((latent.shape[0],), float(t), device=latent.device),
                         ctx, maps)

    def _ddim(self, z, eps, t: int, t_to: int):
        a_t, a_to = self.alphas_cum[t], self.alphas_cum[t_to]
        x0 = (z - float(np.sqrt(np.float32(1) - a_t)) * eps) / float(np.sqrt(a_t))
        return float(np.sqrt(a_to)) * x0 + float(np.sqrt(np.float32(1) - a_to)) * eps

    def invert(self, z0, ctx):
        """DDIM inversion of the latent ``z0`` to step ``start_step`` under ``ctx``."""
        z = z0
        for i in range(self.start_step):
            t = i * self.stride
            z = self._ddim(z, self.eps(z, t, ctx), t, min(t + self.stride, self.T - 1))
        return z

    def _step(self, z, t: int, t_to: int, ctx_cond, ctx_uncond, with_maps: bool):
        """One guided DDIM step and the conditional forward's self and cross
        maps (one of each a transformer block); under autograd its
        activations are recomputed in the backward."""
        def step(z):
            eps_u = self.eps(z, t, ctx_uncond)
            maps = {"attn": [], "cross_attn": []} if with_maps else None
            eps_c = self.eps(z, t, ctx_cond, maps)
            eps = eps_u + self.guidance * (eps_c - eps_u)
            return (self._ddim(z, eps, t, t_to),
                    *((maps["attn"] + maps["cross_attn"]) if with_maps else ()))

        if torch.is_grad_enabled() and z.requires_grad:
            z, *found = checkpoint(step, z, use_reentrant=False)
        else:
            z, *found = step(z)
        half = len(found) // 2
        return z, found[:half], found[half:]

    def decode(self, latent, ctx_cond, ctx_uncond, with_maps: bool = False):
        """(latent at step 0, self maps, cross maps) of a guided DDIM decode
        from ``start_step``, the maps averaged over the steps
        (``diffattack.py:689-720``); empty lists without ``with_maps``."""
        z, acc_self, acc_cross = latent, None, None
        for i in range(self.start_step - 1, -1, -1):
            t = i * self.stride
            z, smaps, cmaps = self._step(z, t, max(t - self.stride, 0), ctx_cond, ctx_uncond,
                                         with_maps)
            acc_self = smaps if acc_self is None else [a + m for a, m in zip(acc_self, smaps)]
            acc_cross = cmaps if acc_cross is None else [a + m for a, m in zip(acc_cross, cmaps)]
        n = max(self.start_step, 1)
        return z, [a / n for a in acc_self or []], [a / n for a in acc_cross or []]

    def to_image(self, z, height: int, width: int):
        """The VAE decode of a step-0 latent, in [0, 1], NHWC at (height, width)."""
        img = self.vae.decode(z / SD_VAE_SCALE)
        img = torch.clamp((img + 1.0) / 2.0, 0.0, 1.0).permute(0, 2, 3, 1)
        return resize(img, height, width)

    # ---- attack -----------------------------------------------------------

    def prepare(self, x, labels) -> dict:
        """What the loss needs of NHWC ``x`` and its labels: the prompts'
        contexts, the inverted latent, the clean trajectory's self maps, the
        kept map indices (at most a quarter of the largest map's tokens,
        ``diffattack.py:703``) and the label token's one-hot position."""
        cond, uncond, pos = self.prompt_ids(np.asarray(labels))
        with torch.no_grad():
            ctx_cond = self.text(torch.from_numpy(cond).long().to(self.device))
            ctx_uncond = self.text(torch.from_numpy(uncond).long().to(self.device))
            x_sd = resize(x, self.image_size, self.image_size)
            z0 = self.vae.encode((x_sd * 2.0 - 1.0).permute(0, 3, 1, 2)) * SD_VAE_SCALE
            latent0 = self.invert(z0.contiguous(memory_format=torch.channels_last), ctx_cond)
            base = self.decode(latent0, ctx_cond, ctx_uncond, with_maps=True)[1]
        onehot = torch.nn.functional.one_hot(torch.from_numpy(pos), MAX_TOKENS).float()
        return {"ctx_cond": ctx_cond, "ctx_uncond": ctx_uncond, "latent0": latent0,
                "base": base, "keep": DiffAttackGD.attn_keep(base),
                "onehot": onehot.to(self.device)}

    def cross_attn_var(self, cmaps, onehot):
        """The label token's received cross-attention over heads and
        queries: its variance an image, averaged over the images and maps."""
        total = 0.0
        for m in cmaps:  # (B, heads, N, 77)
            col = torch.einsum("bhnt,bt->bhn", m, onehot)
            total = total + torch.var(col.reshape(m.shape[0], -1), dim=-1, correction=0).mean()
        return total / len(cmaps)

    def loss(self, latent, x, y, state: dict):
        """The four-term loss (``diffattack.py:279-287``) at ``latent``."""
        z, smaps, cmaps = self.decode(latent, state["ctx_cond"], state["ctx_uncond"],
                                      with_maps=True)
        img = self.to_image(z, x.shape[1], x.shape[2])
        ce = softmax_cross_entropy(self.surrogate.apply(img), y).mean()
        total = (ce if self.targeted else -ce) * self.attack_weight
        if state["keep"]:
            total = total + DiffAttackGD.self_attn(smaps, state["base"], state["keep"]) \
                * self.self_attn_weight
        if cmaps:
            total = total + self.cross_attn_var(cmaps, state["onehot"]) * self.cross_attn_weight
        return total + self.recon_weight * torch.mean((img - x) ** 2)

    def optimize(self, x, y, state: dict) -> torch.Tensor:
        """The latent after ``iterations`` AdamW steps (optax's ``adamw``)."""
        latent = state["latent0"].clone().requires_grad_(True)
        opt = adamw([latent], self.lr)
        self.losses = []
        for i in range(self.iterations):
            loss = self.loss(latent, x, y, state)
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
        yv = label[:, 1] if self.targeted and label.ndim == 2 else label
        state = self.prepare(x, yv.cpu().numpy())
        latent = self.optimize(x, yv.to(self.device), state)
        with torch.no_grad():
            z = self.decode(latent, state["ctx_cond"], state["ctx_uncond"])[0]
            return self.to_image(z, x.shape[1], x.shape[2]) - x
