"""RAP, reverse adversarial perturbation (counterpart of ``gradient/rap.py``).

From iteration ``transpoint`` of ``epoch`` on, each iteration first solves
an inner maximization (``adv_steps`` I-FGSM steps against the attack loss,
with their own clip) for a worst-case perturbation n_rap, then takes the
outer gradient at ``x + delta + n_rap``.  The inner start is JAX's inline
draw, here the seam :meth:`RAP.init_n_rap`.  The outer step goes through the
base ``update_delta``: the update kernel runs once an iteration.
"""
from __future__ import annotations

import torch

from ..attack import Attack, AttackState
from ..utils import img_max, img_min


class RAP(Attack):
    """Official args: alpha=2/255, epoch=400, transpoint=100,
    epsilon_n=16/255, alpha_n=2/255, adv_steps=8, decay=1."""

    def __init__(self, model_name="resnet50", epoch=400, eps=16 / 255, alpha=2 / 255,
                 transpoint=100, epsilon_n=16 / 255, alpha_n=2 / 255, adv_steps=8,
                 inner_random_start=True, targeted=False, random_start=False,
                 norm="linfty", loss="crossentropy", attack="RAP", **kwargs):
        kwargs.pop("decay", None)
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=1.0,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.transpoint = int(transpoint)
        self.epsilon_n = float(epsilon_n)
        self.alpha_n = float(alpha_n)
        self.adv_steps = int(adv_steps)
        # the reference always starts the inner loop at random; False starts
        # it at zero
        self.inner_random_start = bool(inner_random_start)

    def init_n_rap(self, gen, point):
        """The inner loop's start, uniform in (-epsilon_n, epsilon_n), or zero."""
        if not self.inner_random_start:
            return torch.zeros_like(point)
        return (self.draw_rows(gen, torch.rand, point.shape, device=point.device)
                * (2 * self.epsilon_n) - self.epsilon_n)

    def get_n_rap(self, point, y, state, gen):
        """The inner maximization of the negated attack loss."""
        n_rap = torch.clamp(point + self.init_n_rap(gen, point), img_min, img_max) - point
        for _ in range(self.adv_steps):
            g = self.input_grad(point + n_rap, y, state, gen)
            n_rap = torch.clamp(n_rap - self.alpha_n * torch.sign(g),
                                -self.epsilon_n, self.epsilon_n)
            n_rap = torch.clamp(point + n_rap, img_min, img_max) - point
        return n_rap

    def get_grad(self, x, y, state: AttackState, gen):
        point = x + state.delta
        if state.step >= self.transpoint:
            point = point + self.get_n_rap(point, y, state, gen)
        return self.input_grad(point, y, state, gen), {}
