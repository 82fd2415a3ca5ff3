"""MFI, mixed-frequency inputs (counterpart of
``input_transformation/mfi.py``).

Swaps or blends the high-frequency FFT components of x with those of a
shuffled-batch image inside a radial mask, adds gaussian noise, then scales
as SIM does: num_sample=3 mixes × num_scale=5 scales.  The gradient chains
through ``torch.fft``.  The draws are the seam :meth:`MFI.mix_draws`.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..attack import AttackState, draw
from ..gradient.mifgsm import MIFGSM
from .sim import scale_copies


@functools.lru_cache(maxsize=8)
def _radial_mask(H: int, W: int, radius: int, soft: bool, softness: float = 10.0) -> np.ndarray:
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    dist = np.sqrt((yy - H // 2) ** 2 + (xx - W // 2) ** 2)
    if soft:
        mask = 1.0 / (1.0 + np.exp((dist - radius) / softness))
    else:
        mask = (dist <= radius).astype(np.float32)
    return mask.astype(np.float32)[None, :, :, None]


def _fft2_shift(x):
    return torch.fft.fftshift(torch.fft.fft2(x, dim=(1, 2)), dim=(1, 2))


def _ifft2_shift(X):
    return torch.fft.ifft2(torch.fft.ifftshift(X, dim=(1, 2)), dim=(1, 2)).real


class MFI(MIFGSM):
    """Official args: mask_radius=100, gaussian_sigma=32, mfi_type='smfi',
    num_sample=3, num_scale=5."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, mask_radius=100, gaussian_sigma=32, mfi_type="smfi",
                 targeted=False, random_start=False, norm="linfty",
                 loss="crossentropy", attack="MFI", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.mask_radius = int(mask_radius)
        self.gaussian_sigma = float(gaussian_sigma)
        self.mfi_type = mfi_type
        self.num_sample = 3
        self.num_scale = 5

    def num_copies(self):
        return self.num_sample * self.num_scale

    def mix_draws(self, gen, x, state):
        """(perms (n, B), alphas (n,), noises (n, B, H, W, C)) of the
        ``num_sample`` mixes."""
        dev = x.device
        n = self.num_sample
        perms = torch.stack([self.draw_rows(gen, torch.randperm, x.shape[0], device=dev)
                             for _ in range(n)])
        alphas = draw(gen, torch.rand, n, device=dev)
        noises = self.draw_rows(gen, torch.randn, (n,) + x.shape, batch_axis=1, device=dev)
        return perms, alphas, noises

    def mix_one(self, x, perm, alpha, noise):
        """One mix from its draws (JAX's ``_mix_one``)."""
        H, W = x.shape[1], x.shape[2]
        X = _fft2_shift(x)
        M = _fft2_shift(self.whole_batch(x)[perm].detach())
        mask_l = torch.from_numpy(_radial_mask(H, W, self.mask_radius,
                                               self.mfi_type == "smfi")).to(x.device)
        mask_h = 1.0 - mask_l
        if self.mfi_type == "hmfi":
            mixed = X * mask_l + M * mask_h
        else:
            mixed = X * mask_l + alpha * (X * mask_h) + (1 - alpha) * (M * mask_h)
        return _ifft2_shift(mixed) + noise * (self.gaussian_sigma / 255.0)

    def transform(self, x, state: AttackState, gen):
        perms, alphas, noises = self.mix_draws(gen, x, state)
        mixed = torch.stack([self.mix_one(x, perms[i], alphas[i], noises[i])
                             for i in range(self.num_sample)])
        return scale_copies(mixed, self.num_scale).reshape((-1,) + x.shape)
