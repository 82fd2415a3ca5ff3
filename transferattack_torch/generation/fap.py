"""FAP, the frequency-aware perturbation (counterpart of
``transferattack_tpu/generation/fap.py``; the reference's
``generation/fap.py``).

An iterative attack whose delta passes through a frequency gate before the
forward: RGB → YCbCr, one whole-image orthonormal 2-D DCT (``ops/dct.py``),
the coefficient plane tiled into 8×8 blocks, every tile times the same
(8, 8, 3) mask, untiled, inverse DCT, YCbCr → RGB, clamped into [0, 1] (the
reference's clamp of the gated delta, which drops its negative part; kept
as it is).  The gradient is taken at ``x + gate(delta)``, not through the
gate, and the raw delta takes the update kernel's step under an eps scaled
by ``192 / top_n``.  The mask keeps the ``top_n`` lowest zigzag
coefficients, or with a background set (``bg_dir``) the ``top_n`` globally
most important ones: mean |tiled DCT of the YCbCr input gradient| over up
to ``bg_num`` images.  Sides must be multiples of the block.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..attack import Attack, softmax_cross_entropy
from ..ops.dct import dct_2d, idct_2d
from ..utils.data import AdvDataset

_RGB2YCBCR = np.array(
    [[0.299, 0.587, 0.114],
     [-0.168736, -0.331264, 0.5],
     [0.5, -0.418688, -0.081312]], np.float32
)
_YCBCR2RGB = np.linalg.inv(_RGB2YCBCR).astype(np.float32)


def _mix(x: torch.Tensor, mat: np.ndarray) -> torch.Tensor:
    """Each pixel's channels times ``mat`` (JAX's ``einsum("bhwc,dc->bhwd")``)."""
    return x @ torch.as_tensor(mat, dtype=x.dtype, device=x.device).T


def rgb_to_ycbcr(x: torch.Tensor) -> torch.Tensor:
    return _mix(x, _RGB2YCBCR)


def ycbcr_to_rgb(x: torch.Tensor) -> torch.Tensor:
    return _mix(x, _YCBCR2RGB)


def tile_coeffs(v: torch.Tensor, block: int) -> torch.Tensor:
    """(B, H, W, C) coefficient plane → (B, nh, nw, block, block, C) tiles
    (the reference's ``blockify`` on the DCT output, ``fap.py:315-322``)."""
    B, H, W, C = v.shape
    return v.reshape(B, H // block, block, W // block, block, C).permute(0, 1, 3, 2, 4, 5)


def untile_coeffs(t: torch.Tensor, block: int, H: int, W: int) -> torch.Tensor:
    return t.permute(0, 1, 3, 2, 4, 5).reshape(t.shape[0], H, W, t.shape[-1])


def zigzag_lowfreq_mask(block: int, top_n: int) -> np.ndarray:
    """The ``top_n`` globally lowest (channel, i + j)-order coefficients of
    the (3, block, block) stack, luma first at equal order."""
    order = np.add.outer(np.arange(block), np.arange(block))
    order = np.stack([order * 3 + c for c in range(3)]).reshape(-1)
    keep = np.zeros(3 * block * block, np.float32)
    keep[np.argsort(order, kind="stable")[:top_n]] = 1.0
    return keep.reshape(3, block, block)


class FAP(Attack):
    """Official args (``fap.py:44-76``): top_n=64, block=8, epoch=20, eps
    scaled by 192/top_n (16/255 → 48/255), alpha = scaled eps / epoch."""

    def __init__(self, model_name="resnet50", epoch=20, eps=16 / 255, alpha=None,
                 decay=1.0, top_n=64, block_size=8, bg_dir=None, bg_num=100,
                 targeted=False, random_start=False, norm="linfty",
                 loss="crossentropy", attack="FAP", **kwargs):
        eff_eps = eps * (192.0 / float(top_n))
        super().__init__(model_name, epoch=epoch, eps=eff_eps,
                         alpha=(eff_eps / epoch) if alpha is None else alpha,
                         decay=decay, targeted=targeted, random_start=random_start,
                         norm=norm, loss=loss, attack=attack, **kwargs)
        self.top_n = int(top_n)
        self.block = int(block_size)
        self.bg_dir = bg_dir
        self.bg_num = int(bg_num)
        self._freq_mask = None

    def _grad_importance_mask(self) -> np.ndarray:
        """Mean |tiled DCT of the YCbCr input gradient| over up to ``bg_num``
        background images at the surrogate's input size, in batches of 16
        (``fap.py:160-182``), then one global top-n over the flattened
        (3, block, block) map (``fap.py:184-188``)."""
        s = self.model.input_size or 224
        ds = AdvDataset(input_dir=self.bg_dir, size=(s, s))
        imp = np.zeros((3, self.block, self.block), np.float32)
        count = 0
        for xs, ys, _ in ds.as_batches(16):
            if count >= self.bg_num:
                break
            x = torch.as_tensor(xs, device=self.device).requires_grad_(True)
            y = torch.as_tensor(ys, device=self.device).long()
            loss = softmax_cross_entropy(self.model.apply(x).float(), y).mean()
            (g,) = torch.autograd.grad(loss, x)
            u = tile_coeffs(dct_2d(rgb_to_ycbcr(g)), self.block)
            imp += u.abs().mean(dim=(0, 1, 2)).permute(2, 0, 1).cpu().numpy()
            count += len(xs)
        flat = imp.reshape(-1)
        mask = np.zeros_like(flat)
        mask[np.argsort(flat)[::-1][: self.top_n]] = 1.0
        return mask.reshape(3, self.block, self.block)

    def freq_mask(self) -> torch.Tensor:
        """The (block, block, 3) coefficient mask, made on first use."""
        if self._freq_mask is None:
            if self.bg_dir and os.path.isdir(self.bg_dir):
                mask = self._grad_importance_mask()
            else:
                mask = zigzag_lowfreq_mask(self.block, self.top_n)
            self._freq_mask = torch.from_numpy(mask.transpose(1, 2, 0).copy()).to(self.device)
        return self._freq_mask

    def gate_delta(self, delta: torch.Tensor) -> torch.Tensor:
        """YCbCr, whole-image DCT, tiled mask, inverse DCT, RGB, clamp
        (``fap.py:108-126``)."""
        H, W = delta.shape[1], delta.shape[2]
        if H % self.block or W % self.block:
            raise ValueError(f"FAP: image sides {H}x{W} are not multiples of its "
                             f"{self.block}-pixel block")
        t = tile_coeffs(dct_2d(rgb_to_ycbcr(delta)), self.block)
        rgb = ycbcr_to_rgb(idct_2d(untile_coeffs(t * self.freq_mask().to(t.dtype),
                                                 self.block, H, W)))
        return torch.clamp(rgb, 0.0, 1.0)

    def get_grad(self, x, y, state, gen):
        """The gradient at ``x + gate(delta)``, not through the gate."""
        return self.input_grad(x + self.gate_delta(state.delta), y, state, gen), {}
