"""GRA, the gradient relevance attack (counterpart of ``gradient/gra.py``).

A neighbourhood-averaged gradient fused with the current gradient by cosine
similarity, and a per-pixel decay indicator M that shrinks the step where
the momentum's sign flips.  The step size is per pixel, so GRA has its own
``update_delta`` and the update kernel (a scalar alpha) is not on its path.
"""
from __future__ import annotations

import dataclasses

import torch

from ..attack import Attack, AttackState, cosine_similarity, mean_over_draws
from ..utils import img_max, img_min


class GRA(Attack):
    """Official args: beta=3.5, num_neighbor=20, eta=0.94."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 beta=3.5, num_neighbor=20, decay=1.0, eta=0.94, targeted=False,
                 random_start=False, norm="linfty", loss="crossentropy",
                 sample_chunk=4, attack="GRA", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.radius = beta * self.eps
        self.num_neighbor = int(num_neighbor)
        self.eta = float(eta)
        self.sample_chunk = int(sample_chunk)

    def init_extra(self, x, y):
        # M starts at 1/eta, so the first step, where every sign "flips"
        # from the zero momentum, uses M = 1
        return {"M": torch.full_like(x, 1.0 / self.eta)}

    def neighbor_noise(self, gen, x, state):
        """One uniform draw in the (-beta·eps, beta·eps) box."""
        return (self.draw_rows(gen, torch.rand, x.shape, device=x.device)
                * (2 * self.radius) - self.radius)

    def step(self, x, y, state: AttackState, gen):
        grad = self.input_grad(x + state.delta, y, state, gen)

        def neighbor_grads(g, k):
            noise = torch.stack([self.neighbor_noise(g, x, state) for _ in range(k)])
            return self.input_grads(x + state.delta + noise, y, state, g)

        samgrad = mean_over_draws(neighbor_grads, gen, self.num_neighbor, self.sample_chunk)
        s = cosine_similarity(grad, samgrad)
        current = s * grad + (1 - s) * samgrad
        momentum = self.get_momentum(current, state.momentum)
        # keep M where the momentum's sign holds, shrink it by eta where it flipped
        eq = (torch.sign(state.momentum) == torch.sign(momentum)).to(x.dtype)
        M = state.extra["M"] * (eq + (1 - eq) * self.eta)
        delta = self.update_delta(state.delta, x, momentum, alpha=M * self.alpha)
        return dataclasses.replace(state, delta=delta, momentum=momentum,
                                   step=state.step + 1, extra={"M": M})

    def update_delta(self, delta, x, grad_dir, alpha=None):
        a = self.alpha if alpha is None else alpha
        delta = torch.clamp(delta + a * torch.sign(grad_dir), -self.eps, self.eps)
        return torch.clamp(x + delta, img_min, img_max) - x
