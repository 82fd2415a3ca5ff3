"""FIA, RPA, FMAA and BFA, feature importance attacks (counterpart of
``advanced_objective/fia.py``).

Phase 1 estimates a feature-importance weight: the gradient of the label's
softmax probability at a mid-layer feature, aggregated over ``num_ens``
perturbed copies (pixel dropout for FIA and FMAA, patch masks for RPA, at
an I-FGSM point for BFA).  Phase 2 runs the attack on
``Σ feature · weight``.  The feature gradient is ``torch.autograd.grad`` at
the hooked activation (:meth:`FIA.feature_grad`), the reference's backward
hook, where JAX differentiates a zero offset added there.  The copies are
drawn by the seams :meth:`FIA.perturb_input` and :meth:`RPA._patch_mask`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..attack import Attack, softmax_cross_entropy
from ..utils import img_max, img_min
from . import objective_loop


def l2_normalize(g):
    """Per-sample L2 normalization over all non-batch axes."""
    return g / (g.pow(2).sum(dim=tuple(range(1, g.ndim)), keepdim=True).sqrt() + 1e-12)


def label_prob_sum(logits, y):
    """Σ over the batch of the softmax probability of each image's label."""
    return F.softmax(logits.float(), dim=-1).gather(1, y[:, None]).sum()


def patch_mask(x, keep, noise, size: int):
    """RPA's apply step: each ``size``² patch (a cell of ``keep``/``noise``,
    (B, H // size, W // size, C)) kept, or else scaled by its noise; the
    pixels past the last whole patch kept."""
    H, W = x.shape[1], x.shape[2]
    cell = torch.where(keep, torch.ones_like(noise), noise)
    mask = cell.repeat_interleave(size, 1).repeat_interleave(size, 2)
    mask = F.pad(mask, (0, 0, 0, W - mask.shape[2], 0, H - mask.shape[1]), value=1.0)
    return x * mask.to(x.dtype)


class FIA(Attack):
    """Official args: num_ens=30, feature_layer='layer2', drop_rate=0.3.

    As in the reference, FIA and FMAA step with the raw negated gradient (no
    momentum), RPA with its negated momentum and BFA with its momentum:
    ``use_momentum`` and ``step_sign``."""

    use_momentum = False
    step_sign = -1.0

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, num_ens=30, feature_layer="layer2", drop_rate=0.3,
                 targeted=False, random_start=False, norm="linfty",
                 loss="crossentropy", attack="FIA", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.num_ens = int(num_ens)
        self.feature_layer = feature_layer
        self.drop_rate = float(drop_rate)

    # ---- the feature gradient ----

    def feature_grad(self, x, y, score=label_prob_sum):
        """d score(logits, y) / d(feature at the tap), fp32 NHWC."""
        logits, feats = self.model.features(x.detach(), (self.feature_layer,))
        f = feats[self.feature_layer]
        (g,) = torch.autograd.grad(score(logits, y), f)
        self.grad_evals += 1
        return g.float()

    def perturb_input(self, x, gen, i):
        """Copy ``i``: ``x`` with each pixel value dropped at ``drop_rate``."""
        keep = self.draw_rows(gen, torch.rand, x.shape, device=x.device) < 1.0 - self.drop_rate
        return x * keep.to(x.dtype)

    def aggregate_grad(self, x, y, gen):
        agg = sum(self.feature_grad(self.perturb_input(x, gen, i), y)
                  for i in range(self.num_ens))
        return l2_normalize(agg)

    # ---- the attack loop ----

    def feature_loss(self, x, delta, agg_grad, state, gen):
        xs = self.transform(x + delta, state, gen)
        feat = self.model.feature(xs.reshape((-1,) + x.shape[1:]), self.feature_layer)[1]
        return (feat * agg_grad).sum()

    def run(self, x, y, gen):
        agg_grad = self.aggregate_grad(x, y, gen)
        return objective_loop(self, x, y, gen,
                              lambda d, state: self.feature_loss(x, d, agg_grad, state, gen),
                              self.use_momentum, self.step_sign)


class RPA(FIA):
    """Random patch attack: FIA's weight from patch-masked copies, patch
    sizes 1, 3, 5, 7 in turn, a patch kept with probability ``patch_prob``
    or else scaled by U(0, 1).  Official args: num_ens=60."""

    use_momentum = True
    step_sign = -1.0

    def __init__(self, *args, patch_prob=0.7, attack="RPA", **kwargs):
        kwargs.setdefault("feature_layer", "layer2")
        kwargs.setdefault("num_ens", 60)
        kwargs["attack"] = attack
        super().__init__(*args, **kwargs)
        self.patch_prob = float(patch_prob)

    def perturb_input(self, x, gen, i):
        return self._patch_mask(x, gen, (1, 3, 5, 7)[i % 4])

    def _patch_mask(self, x, gen, size: int):
        B, H, W, C = x.shape
        cells = (B, H // size, W // size, C)
        keep = self.draw_rows(gen, torch.rand, cells, device=x.device) < self.patch_prob
        return patch_mask(x, keep, self.draw_rows(gen, torch.rand, cells, device=x.device), size)


class FMAA(FIA):
    """Feature momentum attack: the weight is a momentum over the dropout
    copies' L1-mean-normalized feature gradients."""

    def __init__(self, *args, fm_decay=1.0, attack="FMAA", **kwargs):
        kwargs.setdefault("feature_layer", "layer2")
        kwargs["attack"] = attack
        super().__init__(*args, **kwargs)
        self.fm_decay = float(fm_decay)

    def aggregate_grad(self, x, y, gen):
        mom = 0.0
        for i in range(self.num_ens):
            g = self.feature_grad(self.perturb_input(x, gen, i), y)
            g = g / (g.abs().mean(dim=tuple(range(1, g.ndim)), keepdim=True) + 1e-12)
            mom = self.fm_decay * mom + g
        return l2_normalize(mom)


class BFA(FIA):
    """Black-box feature attack: the weight is FIA's, estimated at the point
    ``warmup_epoch`` I-FGSM steps reach (steps with their own clip)."""

    use_momentum = True
    step_sign = 1.0

    def __init__(self, *args, warmup_epoch=5, attack="BFA", **kwargs):
        kwargs.setdefault("feature_layer", "layer2")
        kwargs["attack"] = attack
        super().__init__(*args, **kwargs)
        self.warmup_epoch = int(warmup_epoch)

    def aggregate_grad(self, x, y, gen):
        delta = torch.zeros_like(x)
        for _ in range(self.warmup_epoch):
            d = delta.requires_grad_(True)
            ce = softmax_cross_entropy(self.model.apply(x + d).float(), y).mean()
            (g,) = torch.autograd.grad(ce, d)
            self.grad_evals += 1
            d = torch.clamp(d.detach() + self.alpha * torch.sign(g), -self.eps, self.eps)
            delta = torch.clamp(x + d, img_min, img_max) - x
        return super().aggregate_grad(x + delta, y, gen)
