"""GI-FGSM, global momentum initialization (counterpart of
``gradient/gifgsm.py``).

Warms the momentum with ``pre_epoch`` iterations at step alpha·s, then resets
delta and runs the normal loop with the warm momentum.  The step size goes
to ``step`` explicitly, so the update kernel runs pre_epoch + epoch times.
"""
from __future__ import annotations

import dataclasses

from .mifgsm import MIFGSM


class GIFGSM(MIFGSM):
    """Official args: pre_epoch=5, s=10."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, pre_epoch=5, s=10, targeted=False, random_start=False,
                 norm="linfty", loss="crossentropy", attack="GI-FGSM", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.pre_epoch = int(pre_epoch)
        self.s = float(s)

    def run(self, x, y, gen):
        state = self.init_state(x, y, gen)
        for _ in range(self.pre_epoch):
            state = self.step(x, y, state, gen, alpha=self.alpha * self.s)
        # reset delta, keep the momentum
        state = dataclasses.replace(state, delta=self.init_delta(x, gen))
        for _ in range(self.epoch):
            state = self.step(x, y, state, gen)
        return self.finalize(state, x, y)
