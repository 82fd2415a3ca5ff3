"""PGN, penalizing the gradient norm (counterpart of ``gradient/pgn.py``).

Each of ``num_neighbor`` samples takes a gradient at a random neighbour and
a second at the predicted descent point, then mixes the two.  JAX draws the
neighbour inline; here it is the seam :meth:`PGN.neighbor_noise`.
"""
from __future__ import annotations

import torch

from ..attack import Attack, AttackState, mean_over_draws

IMAGE_DIMS = (-3, -2, -1)  # H, W, C of a point or of a stack of points


class PGN(Attack):
    """Official args: beta=3.0, gamma=0.5, num_neighbor=20, alpha=eps/epoch."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, beta=3.0,
                 gamma=0.5, num_neighbor=20, decay=1.0, targeted=False,
                 random_start=False, norm="linfty", loss="crossentropy",
                 sample_chunk=4, attack="PGN", **kwargs):
        kwargs.pop("alpha", None)
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=eps / epoch,
                         decay=decay, targeted=targeted, random_start=random_start,
                         norm=norm, loss=loss, attack=attack, **kwargs)
        self.zeta = beta * self.eps
        self.gamma = float(gamma)
        self.num_neighbor = int(num_neighbor)
        self.sample_chunk = int(sample_chunk)

    def neighbor_noise(self, gen, x, state):
        """One uniform draw in the (-beta·eps, beta·eps) box."""
        return (self.draw_rows(gen, torch.rand, x.shape, device=x.device)
                * (2 * self.zeta) - self.zeta)

    def get_grad(self, x, y, state: AttackState, gen):
        def samples(g, k):
            noise = torch.stack([self.neighbor_noise(g, x, state) for _ in range(k)])
            x_near = x + state.delta + noise
            g1 = self.input_grads(x_near, y, state, g)
            # l1_normalize of each point's gradient
            g1n = g1 / (g1.abs().mean(dim=IMAGE_DIMS, keepdim=True) + 1e-12)
            g2 = self.input_grads(x_near - self.alpha * g1n, y, state, g)
            return (1 - self.gamma) * g1 + self.gamma * g2

        return mean_over_draws(samples, gen, self.num_neighbor, self.sample_chunk), {}
