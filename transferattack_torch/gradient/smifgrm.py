"""SMI-FGRM, sampling-based fast gradient rescaling (counterpart of
``gradient/smifgrm.py``).

A depth-first random walk (each sample adds fresh noise to the previous
point; JAX draws it inline, here it is the seam
:meth:`SMIFGRM.neighbor_noise`) and a log2-rescaled momentum in place of the
sign.  The rescaled momentum's sign is the step, so the update kernel runs
once an iteration.
"""
from __future__ import annotations

import torch

from ..attack import Attack, AttackState


class SMIFGRM(Attack):
    """Official args: beta=1.5, num_neighbor=12, rescale_factor=2."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 beta=1.5, num_neighbor=12, rescale_factor=2.0, decay=1.0,
                 targeted=False, random_start=False, norm="linfty",
                 loss="crossentropy", attack="SMI-FGRM", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.radius = beta * self.eps
        self.num_neighbor = int(num_neighbor)
        self.rescale_factor = float(rescale_factor)

    def neighbor_noise(self, gen, x, state):
        """One step of the walk: a uniform draw in (-radius, radius)."""
        return (self.draw_rows(gen, torch.rand, x.shape, device=x.device)
                * (2 * self.radius) - self.radius)

    def rescale(self, g):
        """sign(g) · sigmoid(standardized log2|g|) · factor."""
        log_abs = torch.log2(g.abs() + 1e-38)
        dims = tuple(range(1, g.ndim))
        mean = log_abs.mean(dim=dims, keepdim=True)
        std = log_abs.std(dim=dims, keepdim=True, correction=1)
        norm = (log_abs - mean) / (std + 1e-12)
        return self.rescale_factor * torch.sign(g) * torch.sigmoid(norm)

    def get_grad(self, x, y, state: AttackState, gen):
        # sample i is taken at the walk's point i; the first is the adversary
        point, total = x + state.delta, torch.zeros_like(x)
        for _ in range(self.num_neighbor):
            total = total + self.input_grad(point, y, state, gen)
            point = point + self.neighbor_noise(gen, x, state)
        return total / self.num_neighbor, {}

    def get_momentum(self, grad, momentum):
        return self.rescale(super().get_momentum(grad, momentum))
