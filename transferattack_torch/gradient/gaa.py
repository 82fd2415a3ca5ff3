"""GAA, the gradient aggregation attack (counterpart of ``gradient/gaa.py``).

Aggregates N pairs of (neighbour gradient, sharpness-aware lookahead
gradient), fused as g_hat + (1-λ)g' + (1+λ)g_hat, with per-sample
L1-normalized momentum.  The draw is the seam :meth:`GAA.neighbor_noise`.
"""
from __future__ import annotations

import torch

from ..attack import Attack, AttackState, mean_over_draws
from ..utils import img_max, img_min

IMAGE_DIMS = (-3, -2, -1)  # H, W, C of a point or of a stack of points


class GAA(Attack):
    """Official args: rho=1.6/255, lambda_param=0.2, xi=3.5·eps, N=20,
    alpha=eps/epoch."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, rho=1.6 / 255,
                 lambda_param=0.2, N=20, decay=1.0, targeted=False,
                 random_start=False, norm="linfty", loss="crossentropy",
                 sample_chunk=4, attack="GAA", **kwargs):
        kwargs.pop("alpha", None)
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=eps / epoch,
                         decay=decay, targeted=targeted, random_start=random_start,
                         norm=norm, loss=loss, attack=attack, **kwargs)
        self.rho = float(rho)
        self.lambda_param = float(lambda_param)
        self.xi = 3.5 * self.eps
        self.N = int(N)
        self.sample_chunk = int(sample_chunk)

    def neighbor_noise(self, gen, x, state):
        """One uniform draw in the (-xi, xi) box."""
        return self.draw_rows(gen, torch.rand, x.shape, device=x.device) * (2 * self.xi) - self.xi

    def get_grad(self, x, y, state: AttackState, gen):
        def samples(g, k):
            pert = torch.stack([self.neighbor_noise(g, x, state) for _ in range(k)])
            x_prime = torch.clamp(x + state.delta + pert, img_min, img_max)
            g_prime = self.input_grads(x_prime, y, state, g)
            n1 = g_prime.abs().sum(dim=IMAGE_DIMS, keepdim=True)
            g_hat = self.input_grads(x_prime + self.rho * g_prime / (n1 + 1e-8), y, state, g)
            return g_hat + (1 - self.lambda_param) * g_prime + (1 + self.lambda_param) * g_hat

        return mean_over_draws(samples, gen, self.N, self.sample_chunk), {}

    def get_momentum(self, grad, momentum):
        n1 = grad.abs().sum(dim=IMAGE_DIMS, keepdim=True)
        return momentum * self.decay + grad / (n1 + 1e-8)
