"""DiffPure, diffusion purification (counterpart of the ``DiffPure`` class of
``transferattack_tpu/defense/diffpure.py``; the reference's
``defense/diffpure/diffpure.py:35-175`` and its vendored runners).

Diffuse ``x`` in [0, 1] to ``t_star`` with the DDPM forward process, then
reverse it with one of two samplers, ``diffusion_type``:

* ``'sde'``, the sampler the reference's defense script runs: the reverse
  VP-SDE (``RevVPSDE``, β from 0.1 to 20) integrated by Euler–Maruyama from
  τ₀ = 1 − t*/T to τ₁ = 1 − 1e-5 in steps of about 1e-3, the UNet's ε made a
  score through the continuous ᾱ(s);
* ``'ddpm'``: guided diffusion's ``p_sample`` with the learned-range
  variance and a clipped x₀.

The schedule (T = 1000 linear betas and the posterior constants) is built
in float64 and kept in fp32, as JAX keeps it; every scalar of a step is
computed in fp32 as JAX computes it, the SDE's time grid bit for bit (a
floor of s·T at an integer edge would otherwise move a timestep by one).
Noises come from a ``torch.Generator`` drawn on its own device, or are
given as ``noises`` (the first for the forward diffusion, then one a
reverse step).

The UNet: ``$TA_TPU_WEIGHTS_DIR/<ckpt>.npz`` through the weights bridge
(the full ImageNet-256 configuration), else a warning, the fallback
recorded as ``diffpure_unet`` and a seeded init (a torch generator seeded
9) of the tiny configuration ``_TINY_UNET``, whose zero-initialised output
layer makes ε exactly 0; ``unet_config`` picks the configuration
(``{}``: the full one).

``run_diffpure`` resizes each batch of adversarial PNGs to the native side,
``NATIVE_SIDE`` (256) with weights or 64 in the fallback, as
``jax.image.resize`` does (antialiased when it shrinks), purifies it, resizes
it back, classifies it with ``make_model(model_name)`` (ResNet-101) and
writes the prediction CSV.
"""
from __future__ import annotations

import itertools
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from ..attack import draw
from ..models import (aux_path, load_npz, make_model, nhwc, record_fallback, resolve_device,
                      weights_root)
from ..ops.image import resize
from ..utils.bridge import load_flat_variables
from .gd_unet import GuidedDiffusionUNet, init_unet
from .scoring import classify_dir

# the same architecture, tiny: the weightless fallback and the tests
_TINY_UNET = dict(model_channels=32, num_res_blocks=1, attention_ds=(2,), channel_mult=(1, 2),
                  num_head_channels=16)

f32 = np.float32


class DiffPure:
    """Diffusion purification to ``t_star`` (150 in the reference's defense script)
    with the ``'sde'`` or ``'ddpm'`` sampler.  ``forwards`` counts UNet
    forwards."""

    T = 1000  # discrete timesteps
    NATIVE_SIDE = 256  # the ImageNet-256 UNet's side
    BETA_MIN, BETA_MAX = 0.1, 20.0  # RevVPSDE's continuous endpoints

    def __init__(self, t_star: int = 150, ckpt: str = "diffpure_unet",
                 unet_config: Optional[dict] = None, diffusion_type: str = "sde", device="cuda"):
        if diffusion_type not in ("sde", "ddpm"):
            raise ValueError(f"unknown diffusion_type {diffusion_type!r}")
        self.diffusion_type = diffusion_type
        self.t_star = int(t_star)
        self.device = resolve_device(device)
        betas = np.linspace(1e-4, 0.02, self.T, dtype=np.float64)
        alphas = 1.0 - betas
        acum = np.cumprod(alphas)
        acum_prev = np.append(1.0, acum[:-1])
        # guided diffusion's posterior (gaussian_diffusion.py)
        post_var = betas * (1.0 - acum_prev) / (1.0 - acum)
        self.alphas_cum = acum.astype(f32)
        self.sqrt_recip_acum = np.sqrt(1.0 / acum).astype(f32)
        self.sqrt_recipm1_acum = np.sqrt(1.0 / acum - 1.0).astype(f32)
        self.post_mean_c1 = (betas * np.sqrt(acum_prev) / (1.0 - acum)).astype(f32)
        self.post_mean_c2 = ((1.0 - acum_prev) * np.sqrt(alphas) / (1.0 - acum)).astype(f32)
        self.log_post_var_clipped = np.log(np.append(post_var[1], post_var[1:])).astype(f32)
        self.log_betas = np.log(betas).astype(f32)

        path = aux_path(ckpt)
        config = unet_config if unet_config is not None else ({} if path else _TINY_UNET)
        if path:
            with torch.device("meta"):  # every parameter is loaded next: no host init
                unet = GuidedDiffusionUNet(**config)
            unet = unet.to_empty(device=self.device)
            load_flat_variables(unet, load_npz(path))
        else:
            record_fallback("diffpure_unet")
            warnings.warn(f"DiffPure: {ckpt}.npz not found under {weights_root()}; random-init "
                          "UNet used (its output layer is zero, so ε is 0).")
            unet = GuidedDiffusionUNet(**config)
            init_unet(unet, torch.Generator().manual_seed(9))
        self.fallback_weights = path is None
        self.unet = unet.eval().requires_grad_(False).to(self.device,
                                                         memory_format=torch.channels_last)
        self.forwards = 0

    def unet_out(self, xt, t, maps: Optional[list] = None):
        """The UNet's output (ε and the variance fraction) on NHWC ``xt`` at
        the integer timestep ``t``, in NHWC."""
        self.forwards += 1
        tt = torch.full((xt.shape[0],), float(t), dtype=torch.float32, device=xt.device)
        return nhwc(self.unet, xt, tt, maps)

    def _noise(self, generator, noises, i: int, like):
        if noises is not None:
            return torch.as_tensor(noises[i], dtype=torch.float32, device=like.device)
        return draw(generator, torch.randn, tuple(like.shape), device=like.device)

    def _diffuse(self, x, generator, noises):
        """x in [0, 1] → [-1, 1], diffused to ``t_star`` with the discrete ᾱ."""
        x2 = x * 2.0 - 1.0
        a = self.alphas_cum[self.t_star - 1]
        noise = self._noise(generator, noises, 0, x2)
        return float(np.sqrt(a)) * x2 + float(np.sqrt(f32(1) - a)) * noise

    def p_sample(self, xt, t: int, z):
        """One reverse DDPM step: learned-range variance, clipped x₀
        (``p_mean_variance``/``p_sample`` with clip_denoised=True)."""
        eps, var_frac = self.unet_out(xt, t).chunk(2, dim=-1)
        frac = (var_frac + 1.0) / 2.0
        log_var = (frac * float(self.log_betas[t])
                   + (1 - frac) * float(self.log_post_var_clipped[t]))
        x0 = float(self.sqrt_recip_acum[t]) * xt - float(self.sqrt_recipm1_acum[t]) * eps
        x0 = torch.clamp(x0, -1.0, 1.0)
        mean = float(self.post_mean_c1[t]) * x0 + float(self.post_mean_c2[t]) * xt
        return mean + (1.0 if t > 0 else 0.0) * torch.exp(0.5 * log_var) * z

    def sde_drift_diffusion(self, x, s):
        """Reverse VP-SDE drift and diffusion at fp32 time ``s`` ∈ (0, 1)
        (``RevVPSDE.rvpsde_fn``): ε → score through ᾱ(s) = exp(−½(β₁−β₀)s² −
        β₀s), the UNet at timestep floor(s·T)."""
        s = f32(s)
        beta_s = f32(self.BETA_MIN) + s * f32(self.BETA_MAX - self.BETA_MIN)
        acum_cont = np.exp(f32(-0.5 * (self.BETA_MAX - self.BETA_MIN)) * s * s
                           - f32(self.BETA_MIN) * s)
        eps, _ = self.unet_out(x, np.floor(s * f32(self.T))).chunk(2, dim=-1)
        score = -eps / float(np.sqrt(f32(1) - acum_cont))
        drift = float(f32(-0.5) * beta_s) * x - float(beta_s) * score
        return drift, np.sqrt(beta_s)

    def time_grid(self):
        """(fp32 τ of each Euler–Maruyama step, dt): a uniform grid from
        τ₀ = 1 − t*/T hitting τ₁ = 1 − 1e-5 exactly.  JAX computes τ = τ₀ +
        i·dt on fp32 operands, which XLA contracts into one fused
        multiply-add: the exact value rounded once to fp32 (float64 holds the
        product of two fp32 numbers exactly)."""
        t0, t1 = 1.0 - self.t_star / self.T, 1.0 - 1e-5
        n_steps = max(int(np.ceil((t1 - t0) / 1e-3)), 1)
        dt = (t1 - t0) / n_steps
        i = np.arange(n_steps, dtype=np.float64)
        return (np.float64(f32(t0)) + i * np.float64(f32(dt))).astype(f32), dt

    @torch.no_grad()
    def purify_sde(self, x, generator: Optional[torch.Generator] = None,
                   noises: Optional[Sequence] = None):
        """Euler–Maruyama on the reverse VP-SDE (``image_editing_sample``):
        x' = x − f(1 − τ) dτ + g(1 − τ) √dτ z.  NHWC in [0, 1] in and out."""
        x, generator = self._inputs(x, generator)
        xt = self._diffuse(x, generator, noises)
        taus, dt = self.time_grid()
        for i, tau in enumerate(taus):
            drift, diff = self.sde_drift_diffusion(xt, f32(1) - tau)
            z = self._noise(generator, noises, i + 1, xt)
            xt = xt + (-drift) * float(f32(dt)) + float(diff * np.sqrt(f32(dt))) * z
        return torch.clamp((xt + 1.0) / 2.0, 0.0, 1.0)

    @torch.no_grad()
    def purify_ddpm(self, x, generator: Optional[torch.Generator] = None,
                    noises: Optional[Sequence] = None):
        """Diffuse to t*, then ``p_sample`` from t* − 1 down to 0."""
        x, generator = self._inputs(x, generator)
        xt = self._diffuse(x, generator, noises)
        for i, t in enumerate(range(self.t_star - 1, -1, -1)):
            xt = self.p_sample(xt, t, self._noise(generator, noises, i + 1, xt))
        return torch.clamp((xt + 1.0) / 2.0, 0.0, 1.0)

    def _inputs(self, x, generator):
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device).contiguous()
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return x, generator

    def purify(self, x, generator: Optional[torch.Generator] = None,
               noises: Optional[Sequence] = None):
        if self.diffusion_type == "sde":
            return self.purify_sde(x, generator, noises)
        return self.purify_ddpm(x, generator, noises)

    __call__ = purify


def run_diffpure(input_dir: str, output_dir: str, batchsize: int = 4, t_star: int = 150,
                 model_name: str = "resnet101", out_csv: str = "diffpure_predictions.csv",
                 seed: int = 0, diffusion_type: str = "sde", device="cuda",
                 noises: Optional[Sequence[Sequence]] = None) -> str:
    """Purify, classify, write the prediction CSV (``diffpure.py:76-86``);
    returns its path.  Each batch is resized to the native 256² with weights
    or to 64² in the fallback (the tiny UNet attends at a downsample of 2:
    12,544 tokens at 224²), purified with a generator seeded ``seed`` (one
    draw a batch; ``noises``: one sequence of the sampler's noises a batch),
    resized back and classified in [0, 1].  The
    shipped driver's defaults: ``sde``, ResNet-101, t* 150."""
    dev = resolve_device(device)
    dp = DiffPure(t_star=t_star, diffusion_type=diffusion_type, device=dev)
    surrogate = make_model(model_name, device=dev)
    native = DiffPure.NATIVE_SIDE if not dp.fallback_weights else 64
    gen = torch.Generator(device=dev).manual_seed(seed)
    batches = itertools.count()

    def classify(x):
        side = x.shape[1]
        b = next(batches)
        if side == native:
            purified = dp(x, gen, None if noises is None else noises[b])
        else:
            purified = resize(dp(resize(x, native, native), gen,
                                 None if noises is None else noises[b]), side, side)
        return surrogate.apply(purified).argmax(-1)

    return classify_dir(classify, input_dir, output_dir, batchsize, out_csv, dev)
