"""SSM_H and SSM_P, the 'bag of tricks' variants of SSM (counterpart of
``input_transformation/ssm_tricks.py``; ODI, in the same JAX file, is not
ported yet).

SSM_H: the spectral mask spares the lowest ``mask_ratio`` DCT corner.
SSM_P: one sample an iteration, the mask zeroed unless both the row and the
column clear the low band, and the gradient taken through the DCT chain
(the base engine's transform path).
"""
from __future__ import annotations

import torch

from ..attack import Attack, AttackState
from ..ops.dct import dct_2d, idct_2d
from .ssm import SSM


def _band(H: int, W: int, lh: int, lw: int, low: bool, x) -> torch.Tensor:
    m = torch.zeros(H, W, dtype=x.dtype, device=x.device)
    if low:
        m[:lh, :lw] = 1.0
    else:
        m[lh:, lw:] = 1.0
    return m[None, :, :, None]


class SSM_H(SSM):
    """High-frequency SSM, mask_ratio=0.05."""

    def __init__(self, *args, mask_ratio=0.05, **kwargs):
        kwargs.setdefault("attack", "SSM_H")
        super().__init__(*args, **kwargs)
        self.mask_ratio = float(mask_ratio)

    def spectrum_point(self, x, gen, step=None):
        gauss, mask = self.spectral_draws(gen, x, step)
        H, W = x.shape[1], x.shape[2]
        low = _band(H, W, int(H * self.mask_ratio), int(W * self.mask_ratio), True, x)
        x_dct = dct_2d(x + gauss)
        return idct_2d(x_dct * mask * (1 - low) + x_dct * low)


class SSM_P(SSM):
    """Block-wise SSM, mask_ratio=0.05: one spectrum sample an iteration,
    differentiated through the chain."""

    def __init__(self, *args, mask_ratio=0.05, **kwargs):
        kwargs.setdefault("attack", "SSM_P")
        super().__init__(*args, **kwargs)
        self.mask_ratio = float(mask_ratio)

    def spectrum_point(self, x, gen, step=None):
        gauss, mask = self.spectral_draws(gen, x, step)
        H, W = x.shape[1], x.shape[2]
        band = _band(H, W, int(H * self.mask_ratio), int(W * self.mask_ratio), False, x)
        return idct_2d(dct_2d(x + gauss) * mask * band)

    def transform(self, x, state: AttackState, gen):
        return self.spectrum_point(x, gen, state.step)[None]

    get_grad = Attack.get_grad
