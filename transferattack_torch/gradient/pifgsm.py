"""PI-FGSM, the patch-wise attack (counterpart of ``gradient/pifgsm.py``).

An amplified step plus a 'cut noise' projection that hands the budget
overflowing the eps-ball to neighbouring pixels through a uniform ring
kernel, a depthwise 3×3 convolution (``F.conv2d`` with ``groups=C``).  Its
own clip: the update kernel is not on this path.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..attack import Attack, AttackState
from ..utils import img_max, img_min


class PIFGSM(Attack):
    """Official args: decay=0, kern_size=3, gamma=16, beta=10."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=0.0, kern_size=3, gamma=16.0, beta=10.0, targeted=False,
                 random_start=False, norm="linfty", loss="crossentropy",
                 attack="PI-FGSM", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.kern_size = int(kern_size)
        self.gamma = gamma / 255.0
        self.beta = float(beta)

    def project_noise(self, x):
        """Depthwise convolution of NHWC ``x`` with the uniform ring kernel."""
        k, c = self.kern_size, x.shape[-1]
        kern = torch.full((k, k), 1.0 / (k * k - 1), dtype=x.dtype, device=x.device)
        kern[k // 2, k // 2] = 0.0
        out = F.conv2d(x.permute(0, 3, 1, 2), kern.expand(c, 1, k, k).contiguous(), padding=k // 2,
                       groups=c)
        return out.permute(0, 2, 3, 1)

    def init_extra(self, x, y):
        return {"amplification": torch.zeros_like(x)}

    def step(self, x, y, state: AttackState, gen):
        grad = self.input_grad(x + state.delta, y, state, gen)
        momentum = self.get_momentum(grad, state.momentum)
        amp_step = self.beta * self.alpha * torch.sign(momentum)
        amp = state.extra["amplification"] + amp_step
        cut_noise = torch.clamp(amp.abs() - self.eps, 0.0, 1e4) * torch.sign(amp)
        projection = self.gamma * torch.sign(self.project_noise(cut_noise))
        amp = amp + projection
        delta = torch.clamp(state.delta + amp_step + projection, -self.eps, self.eps)
        delta = torch.clamp(x + delta, img_min, img_max) - x
        return dataclasses.replace(state, delta=delta, momentum=momentum,
                                   step=state.step + 1, extra={"amplification": amp})
