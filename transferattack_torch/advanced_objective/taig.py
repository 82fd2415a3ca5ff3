"""TAIG, transferable attack on integrated gradients (counterpart of
``advanced_objective/taig.py``).

Integrated gradients of the label's logit along the straight path from a
black image, ``steps + 1`` points; the points go through the surrogate as
one batch of ``(steps + 1)·B`` images.
"""
from __future__ import annotations

import torch

from ..attack import Attack, AttackState
from .logit import picked_logits


class TAIG(Attack):
    """Official args: steps=20, decay=0."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 steps=20, targeted=False, random_start=False, norm="linfty",
                 loss="crossentropy", attack="TAIG", **kwargs):
        kwargs.pop("decay", None)
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=0.0,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.steps = int(steps)

    def get_grad(self, x, y, state: AttackState, gen):
        xadv = (x + state.delta).detach()
        fracs = torch.arange(self.steps + 1, dtype=x.dtype, device=x.device) / self.steps
        points = (fracs.reshape(-1, 1, 1, 1, 1) * xadv[None]).requires_grad_(True)
        logits = self.get_logits(points)
        self.grad_evals += points.shape[0]
        # the reference descends the mean score (loss = -mean)
        (grads,) = torch.autograd.grad(-picked_logits(logits, y).mean(), points)
        return xadv * grads.mean(0), {}
