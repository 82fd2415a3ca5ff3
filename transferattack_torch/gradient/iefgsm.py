"""IE-FGSM, GNP and PC-I-FGSM, the lookahead-gradient family (counterpart of
``gradient/iefgsm.py``).

Each takes a second gradient at a point displaced along the first and fuses
the pair into the momentum update.  All three step through the base
``update_delta``, so the update kernel runs once an iteration.
"""
from __future__ import annotations

import torch

from ..attack import Attack, AttackState, global_l1_normalize, l1_normalize
from ..utils import img_max, img_min


class IEFGSM(Attack):
    """Anticipatory-point averaging: the momentum accumulates
    (g_present + g_anticipated)/2, both L1-normalized."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 targeted=False, random_start=False, norm="linfty",
                 loss="crossentropy", attack="IE-FGSM", **kwargs):
        kwargs.pop("decay", None)
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=1.0,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)

    def get_grad(self, x, y, state: AttackState, gen):
        g_p = l1_normalize(self.input_grad(x + state.delta, y, state, gen))
        g_a = l1_normalize(self.input_grad(x + state.delta + self.alpha * g_p, y, state, gen))
        return (g_p + g_a) / 2, {}

    def get_momentum(self, grad, momentum):
        # the gradients come normalized: plain decayed accumulation
        return momentum * self.decay + grad


class GNP(Attack):
    """Gradient-norm penalty: g = (1+beta)·g1 + beta·g2, g2 taken at
    x + r·ĝ1."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, r=0.01, beta=0.8, targeted=False, random_start=False,
                 norm="linfty", loss="crossentropy", attack="GNP", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.r = float(r)
        self.beta = float(beta)

    def get_grad(self, x, y, state: AttackState, gen):
        g1 = self.input_grad(x + state.delta, y, state, gen)
        g2 = self.input_grad(x + state.delta + self.r * l1_normalize(g1), y, state, gen)
        return (1 + self.beta) * g1 + self.beta * g2, {}


class PCIFGSM(Attack):
    """Prediction-correction: a K-step inner corrector whose gradient g_pre
    (globally L1-normalized terms) feeds the outer momentum; the inner
    example steps a full eps, with its own clip."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, K=1, targeted=False, random_start=False, norm="linfty",
                 loss="crossentropy", attack="PC-I-FGSM", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.K = int(K)

    def get_grad(self, x, y, state: AttackState, gen):
        grad = self.input_grad(x + state.delta, y, state, gen)
        g_pre = global_l1_normalize(grad, self.data_split)
        delta_pre = torch.zeros_like(x)  # init_delta without random start
        for _ in range(self.K):
            g = self.input_grad(x + state.delta + delta_pre, y, state, gen)
            g_pre = self.decay * g_pre + global_l1_normalize(g, self.data_split) / self.K
            delta_pre = torch.clamp(delta_pre + self.eps * torch.sign(g), -self.eps, self.eps)
            delta_pre = torch.clamp(x + delta_pre, img_min, img_max) - x
        return g_pre, {}
