"""MEF, max-min evolutionary flatness (counterpart of ``gradient/mef.py``).

Keeps ``num_neighbor`` per-neighbour deltas, resampled each iteration from
the previous inverted-gradient direction and fresh uniform noise (the seam
:meth:`MEF.neighbor_noise`), takes a gradient at each, one neighbour at a
time as JAX's ``lax.map`` does, and accumulates their mean into the
momentum.
"""
from __future__ import annotations

import torch

from ..attack import Attack, AttackState


class MEF(Attack):
    """Official args: num_neighbor=20, gamma=2·eps, kesai=0.15·eps, epoch=20,
    inner_decay=0.9, decay=0.5."""

    def __init__(self, model_name="resnet50", epoch=20, eps=16 / 255, alpha=1.6 / 255,
                 num_neighbor=20, gamma=2.0, kesai=0.15, inner_decay=0.9, decay=0.5,
                 targeted=False, random_start=False, norm="linfty",
                 loss="crossentropy", attack="MEF", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.num_neighbor = int(num_neighbor)
        self.gamma = gamma * self.eps
        self.kesai = kesai * self.eps
        self.inner_decay = float(inner_decay)

    def init_extra(self, x, y):
        return {"grad_pgia": x.new_zeros((self.num_neighbor,) + x.shape)}

    def neighbor_noise(self, gen, x, state):
        """All neighbours' uniform draws in (-gamma, gamma), (num_neighbor, *x.shape)."""
        shape = (self.num_neighbor,) + x.shape
        return (self.draw_rows(gen, torch.rand, shape, batch_axis=1, device=x.device)
                * (2 * self.gamma) - self.gamma)

    def get_grad(self, x, y, state: AttackState, gen):
        noise = self.neighbor_noise(gen, x, state)
        sample_delta = state.delta[None] + noise + self.kesai * state.extra["grad_pgia"]
        grads = torch.stack([self.input_grad(x + d, y, state, gen) for d in sample_delta])
        gradient = grads / self.num_neighbor
        denom = gradient.abs().mean(dim=(2, 3, 4), keepdim=True)
        grad_pgia = gradient / (denom + 1e-12) - self.inner_decay * state.extra["grad_pgia"]
        return gradient.sum(0), {"grad_pgia": grad_pgia}
