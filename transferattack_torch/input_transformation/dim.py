"""DIM / DEM, diverse inputs and their ensemble (counterpart of
``input_transformation/dim.py``).

DIM: with probability ``diversity_prob``, shrink the image into a canvas
``resize_rate`` times its size at a random offset, viewed at the original
resolution: one :func:`~transferattack_torch.ops.image.scale_and_translate`,
antialiased as JAX's.  DEM: five canvas sizes, their logits averaged.

Each draw is split from its apply step (:func:`resize_pad_draws`,
:func:`resize_pad`), so that a test can feed the values JAX drew.
"""
from __future__ import annotations

import torch

from ..attack import AttackState, draw
from ..gradient.mifgsm import MIFGSM
from ..ops.image import scale_and_translate


def resize_pad_draws(gen, size: int, resize_rate: float, diversity_prob: float,
                     device=None) -> dict:
    """One DIM draw for an image of side ``size``: the shrunk side ``rnd``
    in ``[size, int(size·rate))``, the offsets, and whether to apply it."""
    large = float(int(size * resize_rate))
    lo, hi = min(size, int(large)), max(size, int(large))
    rnd = (draw(gen, torch.randint, lo, hi, (), device=device) if hi > lo
           else torch.tensor(lo, device=device)).float()
    top = draw(gen, torch.rand, (), device=device) * (large - rnd)
    left = draw(gen, torch.rand, (), device=device) * (large - rnd)
    apply = draw(gen, torch.rand, (), device=device) < diversity_prob
    return {"rnd": rnd, "top": top, "left": left, "apply": apply, "large": large}


def resize_pad(x, rnd, top, left, apply, large):
    """DIM's apply step: ``x`` shrunk by ``rnd / large`` to a canvas offset
    by (top, left) canvas pixels, or ``x`` itself where ``apply`` is false."""
    H, W = x.shape[1], x.shape[2]
    scale = rnd / large
    out = scale_and_translate(x, (H, W), (scale, scale), (top * H / large, left * W / large))
    return torch.where(torch.as_tensor(apply, device=x.device), out, x)


def random_resize_pad(x, gen, resize_rate: float, diversity_prob: float):
    return resize_pad(x, **resize_pad_draws(gen, x.shape[1], resize_rate,
                                            diversity_prob, x.device))


class DIM(MIFGSM):
    """Official args: resize_rate=1.1, diversity_prob=0.5."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, resize_rate=1.1, diversity_prob=0.5, targeted=False,
                 random_start=False, norm="linfty", loss="crossentropy",
                 attack="DIM", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        if resize_rate < 1:
            raise ValueError("resize rate should be larger than 1")
        self.resize_rate = float(resize_rate)
        self.diversity_prob = float(diversity_prob)

    def transform(self, x, state: AttackState, gen):
        return random_resize_pad(x, gen, self.resize_rate, self.diversity_prob)[None]


class DEM(MIFGSM):
    """Official args: resize_rates=(1.14, 1.27, 1.4, 1.53, 1.66),
    diversity_prob=1, alpha=eps.  The five copies go through the surrogate
    as one batch."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, decay=1.0,
                 resize_rates=(1.14, 1.27, 1.4, 1.53, 1.66), targeted=False,
                 random_start=False, norm="linfty", loss="crossentropy",
                 attack="DEM", **kwargs):
        kwargs.pop("alpha", None)
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=eps, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.resize_rates = tuple(resize_rates)

    def resize_draws(self, gen, x, state):
        """One DIM draw a rate, always applied (the port's seam; JAX draws
        them inline)."""
        return [resize_pad_draws(gen, x.shape[1], r, 1.0, x.device) for r in self.resize_rates]

    def get_grad(self, x, y, state: AttackState, gen):
        delta = state.delta.detach().requires_grad_(True)
        xadv = x + delta
        views = torch.stack([resize_pad(xadv, **d) for d in self.resize_draws(gen, x, state)])
        logits = self.get_logits(views).mean(0)
        self.grad_evals += views.shape[0]
        (grad,) = torch.autograd.grad(self.get_loss(logits[None], y), delta)
        return grad, {}
