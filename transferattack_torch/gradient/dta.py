"""DTA, the direct tuning attack (counterpart of ``gradient/dta.py``).

Each iteration runs K small inner steps from the current adversary displaced
along an accumulated lookahead gt, averages the inner gradients and fuses
them with the outer gradient.  Each inner step goes through the base
``update_delta``, so the update kernel runs K + 1 times an iteration.
"""
from __future__ import annotations

import torch

from ..attack import Attack, AttackState, global_l1_normalize


class DTA(Attack):
    """Official args: beta=1.5 (unused by the loop), K=10, u=0.8."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 beta=1.5, K=10, u=0.8, decay=1.0, targeted=False,
                 random_start=False, norm="linfty", loss="crossentropy",
                 attack="DTA", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.K = int(K)
        self.u = float(u)

    def get_grad(self, x, y, state: AttackState, gen):
        t_grad = self.input_grad(x + state.delta, y, state, gen)
        gt, delta_tk = t_grad, state.delta
        gtk, momentum_tk = torch.zeros_like(x), torch.zeros_like(x)
        for _ in range(self.K):
            g = self.input_grad(x + delta_tk + gt, y, state, gen)
            gt = self.u * gt + global_l1_normalize(g, self.data_split)
            gtk = gtk + g
            momentum_tk = self.get_momentum(g, momentum_tk)
            delta_tk = self.update_delta(delta_tk, x, momentum_tk)
        return self.decay * t_grad + gtk / self.K, {}
