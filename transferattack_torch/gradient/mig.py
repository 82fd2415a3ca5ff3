"""MIG, momentum integrated gradients (counterpart of ``gradient/mig.py``).

The copies axis holds ``s_factor`` points on the straight path from a black
baseline; the loss is the mean softmax probability of the label; the
momentum accumulates the path-weighted integrated gradient.
"""
from __future__ import annotations

import torch

from ..attack import AttackState
from .mifgsm import MIFGSM


class MIG(MIFGSM):
    """Official args: s_factor=20, alpha=eps/epoch."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, decay=1.0,
                 s_factor=20, targeted=False, random_start=False, norm="linfty",
                 loss="crossentropy", attack="MIG", **kwargs):
        kwargs.pop("alpha", None)
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=eps / epoch,
                         decay=decay, targeted=targeted, random_start=random_start,
                         norm=norm, loss=loss, attack=attack, **kwargs)
        self.s_factor = int(s_factor)

    def num_copies(self):
        return self.s_factor

    def transform(self, x, state: AttackState, gen):
        fracs = torch.arange(1, self.s_factor + 1, dtype=x.dtype,
                             device=x.device) / self.s_factor
        return fracs.reshape(-1, 1, 1, 1, 1) * x[None]

    def get_loss(self, logits, y):
        probs = torch.softmax(logits, dim=-1)
        index = y.reshape(1, -1, 1).expand(probs.shape[0], -1, 1)
        loss = torch.gather(probs, -1, index).mean()
        return loss if self.targeted else -loss

    def get_grad(self, x, y, state: AttackState, gen):
        grad = self.input_grad(x + state.delta, y, state, gen)
        return (x + state.delta) * grad / self.s_factor, {}
