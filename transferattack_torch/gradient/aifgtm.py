"""AI-FGTM, Adam-style tanh momentum (counterpart of ``gradient/aifgtm.py``).

Raw-gradient first and second moments, a per-iteration Adam
bias-correction schedule of step sizes (summing to eps), and a tanh step
instead of sign.  Its own clip: the update kernel is not on this path.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..attack import Attack, AttackState
from ..utils import img_max, img_min


class AIFGTM(Attack):
    """Official args: beta_1=0.9, beta_2=0.99, lam=1.3, mu_1=1.5, mu_2=1.9."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, beta_1=0.9, beta_2=0.99, lam=1.3, mu_1=1.5, mu_2=1.9,
                 targeted=False, random_start=False, norm="linfty",
                 loss="crossentropy", attack="AI-FGTM", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.lam, self.mu_1, self.mu_2 = float(lam), float(mu_1), float(mu_2)
        corr = [(1 - beta_1 ** (t + 1)) / math.sqrt(1 - beta_2 ** (t + 1))
                for t in range(self.epoch)]
        total = sum(corr)
        # rounded to fp32, as JAX holds the schedule
        self.alphas = torch.tensor([self.eps / total * c for c in corr]).tolist()

    def init_extra(self, x, y):
        return {"v": torch.zeros_like(x)}

    def step(self, x, y, state: AttackState, gen):
        grad = self.input_grad(x + state.delta, y, state, gen)
        momentum = state.momentum + self.mu_1 * grad
        v = state.extra["v"] + self.mu_2 * grad * grad
        direction = self.lam * momentum / (torch.sqrt(v) + 1e-20)
        delta = torch.clamp(state.delta + self.alphas[state.step] * torch.tanh(direction),
                            -self.eps, self.eps)
        delta = torch.clamp(x + delta, img_min, img_max) - x
        return dataclasses.replace(state, delta=delta, momentum=momentum,
                                   step=state.step + 1, extra={"v": v})
