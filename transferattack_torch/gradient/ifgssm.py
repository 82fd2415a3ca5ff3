"""I-FGS²M, the staircase sign method (counterpart of ``gradient/ifgssm.py``).

sign(g) is replaced by a per-channel percentile staircase: pixels in higher
|g| percentile bins step proportionally farther.  Its own clip: the update
kernel is not on this path.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import img_max, img_min
from .mifgsm import MIFGSM


def staircase_sign(noise: torch.Tensor, k: float) -> torch.Tensor:
    """sign(noise) weighted by percentile-bin magnitude.

    Per (image, channel): thresholds at percentiles k, 2k, …, 100 of |noise|
    ('lower' interpolation, as ``jnp.quantile`` takes it: the element at
    ``floor(q·(n - 1))`` of the sorted values); an element in bin j gets
    magnitude k/100·(1+2j).
    """
    B, H, W, C = noise.shape
    abs_n = noise.abs()
    flat = abs_n.permute(0, 3, 1, 2).reshape(B, C, H * W)
    qs = (np.arange(k, 100.1, k) / 100.0).astype(np.float32)
    idx = torch.from_numpy(np.floor(qs * np.float32(H * W - 1)).astype(np.int64))
    med = flat.sort(dim=-1).values[..., idx.to(noise.device)]  # (B, C, Q), ascending
    # the bin of an element: how many thresholds lie below it
    bins = torch.searchsorted(med, flat.contiguous())  # (B, C, H·W)
    bins = bins.reshape(B, C, H, W).permute(0, 2, 3, 1)
    weights = (k / 100.0) * (1.0 + 2.0 * bins.to(noise.dtype))
    return torch.sign(noise) * weights


class IFGSSM(MIFGSM):
    """Official args: k=1.5625 (64 bins), decay=0."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 k=1.5625, targeted=False, random_start=False, norm="linfty",
                 loss="crossentropy", attack="I-FGSSM", **kwargs):
        kwargs.pop("decay", None)
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=0.0,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.k = float(k)

    def update_delta(self, delta, x, grad_dir, alpha=None):
        alpha = self.alpha if alpha is None else alpha
        delta = torch.clamp(delta + alpha * staircase_sign(grad_dir, self.k),
                            -self.eps, self.eps)
        return torch.clamp(x + delta, img_min, img_max) - x
