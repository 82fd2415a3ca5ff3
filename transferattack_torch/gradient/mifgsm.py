"""FGSM / I-FGSM / MI-FGSM / NI-FGSM (counterpart of ``gradient/mifgsm.py``).

Hyperparameter and hook specializations of the base engine.
"""
from __future__ import annotations

from ..attack import Attack, AttackState


class MIFGSM(Attack):
    """Momentum I-FGSM: decay=1, the base loop."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, targeted=False, random_start=False, norm="linfty",
                 loss="crossentropy", attack="MI-FGSM", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)


class FGSM(MIFGSM):
    """Single-step FGSM: epoch=1, alpha=eps."""

    def __init__(self, model_name="resnet50", eps=16 / 255, targeted=False,
                 random_start=False, norm="linfty", loss="crossentropy",
                 attack="FGSM", **kwargs):
        kwargs.pop("epoch", None), kwargs.pop("alpha", None), kwargs.pop("decay", None)
        super().__init__(model_name, epoch=1, eps=eps, alpha=eps, decay=0.0,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)


class IFGSM(MIFGSM):
    """Iterative FGSM: decay=0."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 targeted=False, random_start=False, norm="linfty",
                 loss="crossentropy", attack="I-FGSM", **kwargs):
        kwargs.pop("decay", None)
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=0.0,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)


class NIFGSM(MIFGSM):
    """Nesterov I-FGSM: lookahead transform ``x + alpha * decay * momentum``."""

    def __init__(self, *args, attack="NI-FGSM", **kwargs):
        kwargs["attack"] = attack
        super().__init__(*args, **kwargs)

    def transform(self, x, state: AttackState, gen):
        return (x + self.alpha * self.decay * state.momentum)[None]
