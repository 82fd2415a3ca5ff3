"""SIM / Admix / US-MM, the scale-copy mixing family (counterpart of
``input_transformation/sim.py``).

Each attack puts its copies on the leading axis ``transform`` returns; the
engine takes them through the surrogate as one batch.
"""
from __future__ import annotations

import torch

from ..attack import AttackState
from ..gradient.mifgsm import MIFGSM


def scale_copies(x, num_scale: int):
    """``x / 2^i`` for i < num_scale, on a new leading axis."""
    scales = 1.0 / 2 ** torch.arange(num_scale, dtype=x.dtype, device=x.device)
    return scales.reshape((-1,) + (1,) * x.ndim) * x[None]


def admix(x, perms, strength: float, num_scale: int, partners=None):
    """Admix's apply step: ``x + strength·partners[perm]`` (the partner
    image detached; ``partners`` the whole batch, ``x`` by default) for each
    permutation, at each of ``num_scale`` scales, scale-major:
    (num_scale · len(perms), B, H, W, C)."""
    partners = x if partners is None else partners
    mixes = torch.stack([x + strength * partners[p].detach() for p in perms])
    return scale_copies(mixes, num_scale).reshape((-1,) + x.shape)


class SIM(MIFGSM):
    """Scale-invariant copies x/2^i, num_scale=5."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, num_scale=5, targeted=False, random_start=False,
                 norm="linfty", loss="crossentropy", attack="SIM", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.num_scale = int(num_scale)

    def num_copies(self):
        return self.num_scale

    def transform(self, x, state: AttackState, gen):
        return scale_copies(x, self.num_scale)


class Admix(MIFGSM):
    """Admix: admix_strength·(shuffled batch) mixed into x, num_admix=3
    mixes × num_scale=5 scales = 15 copies."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, num_scale=5, num_admix=3, admix_strength=0.2,
                 targeted=False, random_start=False, norm="linfty",
                 loss="crossentropy", attack="Admix", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.num_scale = int(num_scale)
        self.num_admix = int(num_admix)
        self.admix_strength = float(admix_strength)

    def num_copies(self):
        return self.num_scale * self.num_admix

    def transform(self, x, state: AttackState, gen):
        perms = [self.draw_rows(gen, torch.randperm, x.shape[0], device=x.device)
                 for _ in range(self.num_admix)]
        return admix(x, perms, self.admix_strength, self.num_scale, self.whole_batch(x))


class USMM(MIFGSM):
    """US-MM: uniform scales in [scale_low, scale_high] × mix masks made of
    shuffled-batch images.  The gradient is taken at the transformed points
    (detached leaves, as the reference does) and summed over the copies."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, scale_low=0.1, scale_high=0.75, num_scale=5, num_mix=3,
                 mix_range=0.5, targeted=False, random_start=False, norm="linfty",
                 loss="crossentropy", attack="USMM", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.scale_low = float(scale_low)
        self.scale_high = float(scale_high)
        self.num_scale = int(num_scale)
        self.num_mix = int(num_mix)
        self.mix_range = float(mix_range)

    def num_copies(self):
        return self.num_scale * self.num_mix

    def mix_perms(self, gen, B, state):
        """(num_mix, num_scale, B): a fresh shuffled-batch permutation for
        every (mix, scale) copy."""
        return torch.stack([self.draw_rows(gen, torch.randperm, B, device=state.delta.device)
                            for _ in range(self.num_mix * self.num_scale)]
                           ).reshape(self.num_mix, self.num_scale, B)

    def get_grad(self, x, y, state: AttackState, gen):
        xadv = x + state.delta
        n = self.num_copies()
        scales = torch.tensor(
            [self.scale_low + (self.scale_high - self.scale_low) * i / (self.num_scale - 1)
             for i in range(self.num_scale)], dtype=x.dtype, device=x.device)
        perms = self.mix_perms(gen, x.shape[0], state)
        masks = (1 - self.mix_range) + 2 * self.mix_range * self.whole_batch(xadv)[perms]
        pts = scales.reshape(1, -1, 1, 1, 1, 1) * (xadv[None, None] * masks)
        pts = torch.clamp(pts.reshape((-1,) + x.shape), 0.0, 1.0).requires_grad_(True)
        logits = self.get_logits(pts)
        self.grad_evals += n
        (g,) = torch.autograd.grad(self.get_loss(logits, y) * n, pts)
        return g.sum(0) / n, {}
