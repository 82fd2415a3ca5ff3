"""EMI-FGSM, enhanced momentum (counterpart of ``gradient/emifgsm.py``).

``num_sample`` points along the previous gradient's direction form the
copies axis, one batch through the surrogate.
"""
from __future__ import annotations

import torch

from ..attack import AttackState, l1_normalize
from .mifgsm import MIFGSM


class EMIFGSM(MIFGSM):
    """Official args: num_sample=11, radius=7, linear spacing."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, num_sample=11, radius=7, sample_method="linear",
                 targeted=False, random_start=False, norm="linfty",
                 loss="crossentropy", attack="EMI-FGSM", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.num_sample = int(num_sample)
        self.radius = float(radius)
        self.sample_method = sample_method

    def num_copies(self):
        return self.num_sample

    def init_extra(self, x, y):
        return {"bar_grad": torch.zeros_like(x)}

    def transform(self, x, state: AttackState, gen):
        factors = torch.linspace(-self.radius, self.radius, self.num_sample,
                                 dtype=x.dtype, device=x.device)
        return x[None] + factors.reshape(-1, 1, 1, 1, 1) * self.alpha * state.extra["bar_grad"][None]

    def get_grad(self, x, y, state: AttackState, gen):
        grad, _ = super().get_grad(x, y, state, gen)
        return grad, {"bar_grad": l1_normalize(grad)}
