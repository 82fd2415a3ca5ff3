"""VA-I-FGSM, virtual auxiliary labels (counterpart of ``gradient/vaifgsm.py``).

Each iteration steps on the true-label CE gradient, then on the negated
gradients of ``aux_num`` random other classes (the seam
:meth:`VAIFGSM.sample_aux_labels`); the eps-ball clip comes once, at the
end.  One forward and 1 + aux_num backward passes from it.  Its own clip:
the update kernel is not on this path.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..attack import Attack, AttackState
from ..utils import img_max, img_min


class VAIFGSM(Attack):
    """Official args: alpha=0.007, epoch=20, aux_num=3."""

    def __init__(self, model_name="resnet50", epoch=20, eps=16 / 255, alpha=0.007,
                 aux_num=3, targeted=False, random_start=False, norm="linfty",
                 loss="crossentropy", attack="VA-I-FGSM", **kwargs):
        kwargs.pop("decay", None)
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=0.0,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.aux_num = int(aux_num)

    def sample_aux_labels(self, gen, y, num_classes):
        """(aux_num, B) distinct random labels, none the true class."""
        scores = self.draw_rows(gen, torch.rand, (y.shape[0], num_classes), device=y.device)
        scores[torch.arange(y.shape[0], device=y.device), y] = float("inf")
        return torch.topk(-scores, self.aux_num, dim=1).indices.T

    @staticmethod
    def ce_logit_grad(logits, labels):
        """d(mean CE)/d logits = (softmax - onehot)/B."""
        onehot = F.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)
        return (torch.softmax(logits, dim=-1) - onehot) / logits.shape[0]

    def step(self, x, y, state: AttackState, gen):
        point = (x + state.delta).requires_grad_(True)
        logits = self.model.apply(point)
        aux_labels = self.sample_aux_labels(gen, y, logits.shape[-1])
        sign = -1.0 if self.targeted else 1.0
        seeds = [sign * self.ce_logit_grad(logits.detach(), y)]
        seeds += [-sign * self.ce_logit_grad(logits.detach(), aux) for aux in aux_labels]
        delta = state.delta
        for i, seed in enumerate(seeds):
            (g,) = torch.autograd.grad(logits, point, seed, retain_graph=i < len(seeds) - 1)
            delta = torch.clamp(x + delta + self.alpha * torch.sign(g), img_min, img_max) - x
        self.grad_evals += len(seeds)
        return dataclasses.replace(state, delta=delta, step=state.step + 1)

    def finalize(self, state, x, y):
        # the one eps clip, at the end
        return torch.clamp(state.delta, -self.eps, self.eps)
