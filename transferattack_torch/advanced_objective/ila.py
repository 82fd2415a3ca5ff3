"""ILA and ILPD, intermediate-level attacks (counterpart of
``advanced_objective/ila.py``).

ILA: the inherited momentum attack gives a direction at a mid layer
(``layer3.0``); a second run ascends the projection of the new feature
displacement on it, both flattened over the whole batch, as JAX and the
reference flatten them.  ILPD: a tap at ``layer2.3`` replaces the live
feature by γ of it plus 1 − γ of the σ-noised clean image's; the noise is
the seam :meth:`ILPD.feature_noise`.
"""
from __future__ import annotations

import torch

from ..attack import Attack, AttackState
from ..gradient.mifgsm import MIFGSM
from . import objective_loop


class ILA(Attack):
    """Official args: coeff=1.0, feature_layer='layer3.0'."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, coeff=1.0, feature_layer="layer3.0", targeted=False,
                 random_start=False, norm="linfty", loss="crossentropy",
                 attack="ILA", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.coeff = float(coeff)
        self.feature_layer = feature_layer

    def run(self, x, y, gen):
        # phase 1: the inherited momentum attack gives the direction
        init_delta = super().run(x, y, gen)
        B = x.shape[0]
        with torch.no_grad():
            mid_original = self.model.feature(x, self.feature_layer)[1]
            xdir = (self.model.feature(x + init_delta, self.feature_layer)[1]
                    - mid_original).reshape(B, -1)
            # the norm of the whole batch's displacement
            xnorm = self.batch_sum(xdir * xdir, axis=0).sqrt() + 1e-12
            xhat = xdir / xnorm

        def proj_loss(d, state):
            mid_new = self.model.feature(x + d, self.feature_layer)[1]
            return ((mid_new - mid_original).reshape(B, -1) * xhat).sum() / xnorm

        return objective_loop(self, x, y, gen, proj_loss)


class ILPD(MIFGSM):
    """Official args: sigma=0.05, coef=0.1, feature_layer='layer2.3'; the
    reference fixes alpha=1/255 and epoch=100."""

    def __init__(self, model_name="resnet50", epoch=100, eps=16 / 255, decay=1.0,
                 sigma=0.05, coef=0.1, feature_layer="layer2.3", targeted=False,
                 random_start=False, norm="linfty", loss="crossentropy",
                 attack="ILPD", **kwargs):
        kwargs.pop("alpha", None)
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=1 / 255, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.sigma = float(sigma)
        self.coef = float(coef)
        self.feature_layer = feature_layer

    def feature_noise(self, gen, x, state):
        """A standard normal draw the shape of the batch."""
        return self.draw_rows(gen, torch.randn, x.shape, device=x.device)

    def get_grad(self, x, y, state: AttackState, gen):
        noisy = x + self.sigma * self.feature_noise(gen, x, state)
        with torch.no_grad():
            ori_ilout = self.model.features(noisy, (self.feature_layer,))[1][self.feature_layer]
        taps = {self.feature_layer: lambda f: self.coef * f + (1 - self.coef) * ori_ilout}
        delta = state.delta.detach().requires_grad_(True)
        logits = self.model.apply(x + delta, tap_fns=taps)
        self.grad_evals += 1
        (grad,) = torch.autograd.grad(self.get_loss(logits.float()[None], y), delta)
        return grad, {}
