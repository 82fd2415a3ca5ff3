"""SU, self-universality (counterpart of ``input_transformation/su.py``;
targeted by default).

The global adversary and a random-resized-crop local view go through DI
together; the loss is the logit of the target plus a cosine term between
the two views' features at a mid layer (``layer3``), and the gradient is
smoothed by a 5×5 gaussian.  The draws are the seam :meth:`SU.su_draws`.
"""
from __future__ import annotations

import torch

from ..attack import Attack, AttackState, draw
from ..ops.image import scale_and_translate
from ..ops.kernels import gaussian_kernel, smooth_conv
from .dim import resize_pad, resize_pad_draws

def crop_draws(gen, scale=(0.1, 0.1), device=None) -> dict:
    """One crop: its area fraction in [scale0, scale0 + scale1] and the
    fractional offsets of its corner."""
    area = scale[0] + draw(gen, torch.rand, (), device=device) * (scale[1] + 1e-6)
    side = torch.sqrt(area)
    ty = draw(gen, torch.rand, (), device=device) * (1 - side)
    tx = draw(gen, torch.rand, (), device=device) * (1 - side)
    return {"side": side, "ty": ty, "tx": tx}

def resized_crop(x, side, ty, tx):
    """The crop of side ``side`` (a fraction of the image) at fractional
    corner (ty, tx), resized back to full resolution."""
    H, W = x.shape[1], x.shape[2]
    s = 1.0 / side
    return scale_and_translate(x, (H, W), (s, s), (-ty * H * s, -tx * W * s))
class SU(Attack):
    """Official args: alpha=2/255, epoch=300, coef=0.001, scale=(0.1, 0.0),
    feature_layer='layer3', DI rate 1.1 with probability 0.7, TI kernel 5."""

    def __init__(self, model_name="resnet50", epoch=300, eps=16 / 255, alpha=2 / 255,
                 decay=1.0, coef=0.001, scale=(0.1, 0.0), feature_layer="layer3",
                 resize_rate=1.1, diversity_prob=0.7, kernel_size=5,
                 targeted=True, random_start=False, norm="linfty",
                 loss="crossentropy", attack="SU", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.coef = float(coef)
        self.scale = tuple(scale)
        self.feature_layer = feature_layer
        self.resize_rate = float(resize_rate)
        self.diversity_prob = float(diversity_prob)
        self.kernel = gaussian_kernel(int(kernel_size))

    def su_draws(self, gen, x, state):
        """(crop draws, DI draws) of one iteration."""
        return (crop_draws(gen, self.scale, x.device),
                resize_pad_draws(gen, x.shape[1], self.resize_rate, self.diversity_prob,
                                 x.device))

    def class_loss(self, logits, yy):
        """The classifier part of the loss: minus the mean logit of ``yy``."""
        return -logits.gather(1, yy[:, None])[:, 0].mean()

    def get_grad(self, x, y, state: AttackState, gen):
        crop, di = self.su_draws(gen, x, state)
        B = x.shape[0]
        used_coef = -1.0 if self.targeted else 1.0
        delta = state.delta.detach().requires_grad_(True)
        local = resized_crop(x, **crop) + delta
        both = resize_pad(torch.cat([x + delta, local]), **di)
        logits, feat = self.model.feature(both, self.feature_layer)
        self.grad_evals += 2
        logit_loss = self.class_loss(logits.float(), torch.cat([y, y]))
        fg, fl = feat[:B].reshape(B, -1), feat[B:].reshape(B, -1)
        cos = (fg * fl).sum(1) / (fg.norm(dim=1) * fl.norm(dim=1) + 1e-12)
        loss = -(logit_loss + self.coef * used_coef * cos.mean())
        (grad,) = torch.autograd.grad(loss, delta)
        return smooth_conv(grad, self.kernel), {}
