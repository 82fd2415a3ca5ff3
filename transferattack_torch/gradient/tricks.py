"""'Bag of tricks' MI-FGSM variants (counterpart of ``gradient/tricks.py``):
RGMIFGSM (random global momentum init), DualMIFGSM (dual-example momentum)
and Ens_FGSM_MIFGSM (direction-averaged gradients driving a dual example).
Their random starts are the seam ``restart_delta``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..attack import Attack, AttackState, draw_rows
from ..utils import img_max, img_min


def uniform_start(gen, x, eps, split=None):
    """A uniform(-eps, eps) random start, box-clipped (``split``: an
    attack's ``data_split``, whose rows of the one-process draw it takes)."""
    delta = draw_rows(split, gen, torch.rand, x.shape, device=x.device) * (2 * eps) - eps
    return torch.clamp(x + delta, img_min, img_max) - x


class RGMIFGSM(Attack):
    """Random-start global momentum init: ``num_directions`` random restarts
    of a ``pre_epoch``-iteration warm-up at step alpha·s accumulate a shared
    momentum, then the main loop runs from zero.  The update kernel runs
    num_directions·pre_epoch + epoch times."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, pre_epoch=5, s=10, num_directions=5, targeted=False,
                 random_start=False, norm="linfty", loss="crossentropy",
                 attack="RGMIFGSM", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.pre_epoch = int(pre_epoch)
        self.s = float(s)
        self.num_directions = int(num_directions)

    def restart_delta(self, gen, x, idx):
        """The random start of direction ``idx``."""
        return uniform_start(gen, x, self.eps, self.data_split)

    def run(self, x, y, gen):
        state = self.init_state(x, y, gen)
        momentum = state.momentum
        for idx in range(self.num_directions):
            delta = self.restart_delta(gen, x, idx)
            for _ in range(self.pre_epoch):
                g = self.input_grad(x + delta, y,
                                    dataclasses.replace(state, momentum=momentum), gen)
                momentum = self.get_momentum(g, momentum)
                delta = self.update_delta(delta, x, momentum, alpha=self.alpha * self.s)
        state = dataclasses.replace(state, momentum=momentum / self.num_directions,
                                    delta=torch.zeros_like(x))
        for _ in range(self.epoch):
            state = self.step(x, y, state, gen)
        return self.finalize(state, x, y)


class DualMIFGSM(Attack):
    """Dual-example momentum: gradients taken at a fresh random start each
    iteration drive a separate dual adversary, which is what it returns."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, targeted=False, random_start=False, norm="linfty",
                 loss="crossentropy", attack="DualMIFGSM", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)

    def init_extra(self, x, y):
        return {"delta_dual": torch.zeros_like(x), "momentum_dual": torch.zeros_like(x)}

    def restart_delta(self, gen, x, state, idx=0):
        """This iteration's random start (``idx``: the direction)."""
        return uniform_start(gen, x, self.eps, self.data_split)

    def dual_step(self, x, state: AttackState, grad, delta) -> AttackState:
        momentum = self.get_momentum(grad, state.momentum)
        momentum_dual = self.get_momentum(grad, state.extra["momentum_dual"])
        delta_dual = self.update_delta(state.extra["delta_dual"], x, momentum_dual)
        return dataclasses.replace(
            state, delta=delta, momentum=momentum, step=state.step + 1,
            extra={"delta_dual": delta_dual, "momentum_dual": momentum_dual})

    def step(self, x, y, state: AttackState, gen):
        delta = self.restart_delta(gen, x, state)
        return self.dual_step(x, state, self.input_grad(x + delta, y, state, gen), delta)

    def finalize(self, state: AttackState, x, y):
        return torch.clamp(x + state.extra["delta_dual"], img_min, img_max) - x


class Ens_FGSM_MIFGSM(DualMIFGSM):
    """Direction-ensemble dual MI-FGSM: each iteration averages the
    gradients at ``num_d`` fresh random starts."""

    def __init__(self, *args, num_d=5, attack="Ens_DualMIFGSM", **kwargs):
        kwargs["attack"] = attack
        super().__init__(*args, **kwargs)
        self.num_directions = int(num_d)

    def step(self, x, y, state: AttackState, gen):
        grads = [self.input_grad(x + self.restart_delta(gen, x, state, idx), y, state, gen)
                 for idx in range(self.num_directions)]
        grad = torch.stack(grads).mean(0)
        return self.dual_step(x, state, grad, state.delta)
