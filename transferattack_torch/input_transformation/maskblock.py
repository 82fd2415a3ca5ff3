"""MaskBlock (counterpart of ``input_transformation/maskblock.py``): one
copy per ``patch_size`` grid cell, with that cell zeroed (16 copies at
224²)."""
from __future__ import annotations

import torch

from ..attack import AttackState
from ..gradient.mifgsm import MIFGSM
from ..utils import img_height, img_width


def block_masks(H: int, W: int, patch_size: int, device=None) -> torch.Tensor:
    """(n, H, W, 1): mask i zeroes grid cell i, rows first."""
    masks = []
    for i in range(0, H - patch_size + 1, patch_size):
        for j in range(0, W - patch_size + 1, patch_size):
            m = torch.ones(H, W, 1, device=device)
            m[i:i + patch_size, j:j + patch_size] = 0.0
            masks.append(m)
    return torch.stack(masks)


class MaskBlock(MIFGSM):
    """Official args: patch_size=56, alpha=2/255."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=2 / 255,
                 decay=1.0, patch_size=56, targeted=False, random_start=False,
                 norm="linfty", loss="crossentropy", attack="MaskBlock", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.patch_size = int(patch_size)

    def num_copies(self):
        return max((img_height // self.patch_size) * (img_width // self.patch_size), 1)

    def transform(self, x, state: AttackState, gen):
        masks = block_masks(x.shape[1], x.shape[2], self.patch_size, x.device)
        return x[None] * masks[:, None].to(x.dtype)
