"""AdaMSI-FGM, adaptive momentum and step size (counterpart of
``gradient/adamsi_fgm.py``).

A second-moment accumulator with a time-varying beta2, a beta1_t schedule
from per-sample gradient L1 norms, and a raw (sign-free) delta update.  Its
own clip: the update kernel is not on this path.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..attack import AttackState
from ..utils import img_max, img_min
from .mifgsm import MIFGSM


class AdaMSI_FGM(MIFGSM):
    """Official args: lambda_=0.6."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, lambda_=0.6, targeted=False, random_start=False,
                 norm="linfty", loss="crossentropy", attack="AdaMSI_FGM", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.lambda_ = float(lambda_)

    def init_extra(self, x, y):
        return {"v": torch.zeros_like(x), "s_prev": x.new_zeros((x.shape[0],))}

    def step(self, x, y, state: AttackState, gen):
        t = float(state.step + 1)
        grad = self.input_grad(x + state.delta, y, state, gen)
        g_norm1 = grad.abs().sum(dim=(1, 2, 3))
        s_t = self.lambda_ * t ** 2 * g_norm1
        beta1_t = state.extra["s_prev"] / (s_t + 1.0)
        beta2_t = 1.0 - 1.0 / t
        v = beta2_t * state.extra["v"] + (1.0 - beta2_t) * grad * grad
        # the reference's literal expression: sqrt(v) + 1e-16 / sqrt(t)
        v_hat = torch.sqrt(v) + 1e-16 / math.sqrt(t)
        # the reference's (x0 + delta - x_prev) term is the current delta:
        # its x_prev is assigned once and never updated
        momentum = state.momentum * self.decay + beta1_t.reshape(-1, 1, 1, 1) * state.delta
        momentum = grad / v_hat + momentum
        delta = torch.clamp(state.delta + self.alpha * momentum, -self.eps, self.eps)
        delta = torch.clamp(x + delta, img_min, img_max) - x
        return dataclasses.replace(state, delta=delta, momentum=momentum,
                                   step=state.step + 1, extra={"v": v, "s_prev": s_t})
