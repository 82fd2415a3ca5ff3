"""IR, P2FA and TRAP (counterpart of ``advanced_objective/ir.py``).

IR: a Shapley-interaction regularizer from five grid masks (the seam
:meth:`IR._grid_mask`), the eleven forwards that depend on delta as one
batch.  P2FA: a feature target pushed along an aggregate feature gradient,
matched by ``inner_steps`` pixel steps with their own clip.  TRAP: ILA-like
two phases with an EMA feature anchor under a strong random affine (the
port's exact bilinear ``affine_warp``; its draws are the seam
:meth:`TRAP.affine_draws`), the second phase with its own clip.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..attack import AttackState, draw, softmax_cross_entropy
from ..gradient.mifgsm import MIFGSM
from ..ops.image import affine_warp
from ..utils import img_max, img_min
from .fia import l2_normalize
from .logit import picked_logits


class IR(MIFGSM):
    """Official args: grid_scale=16, grid_num=32, sample_times=1, lam=1."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, grid_scale=16, grid_num=32, sample_times=1, lam=1.0,
                 targeted=False, random_start=False, norm="linfty",
                 loss="crossentropy", attack="ir", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.grid_scale = int(grid_scale)
        self.grid_num = int(grid_num)
        self.sample_times = int(sample_times)
        self.lam = float(lam)

    def _grid_mask(self, gen, shape):
        """A (1, H, W, 1) mask of ``grid_num`` random cells of a
        ``grid_scale``² grid (cells drawn with replacement)."""
        H, W = shape[1], shape[2]
        gs = self.grid_scale
        ids = draw(gen, torch.randint, 0, gs * gs, (self.grid_num,))
        cell = torch.zeros(gs * gs, device=ids.device)
        cell[ids] = 1.0
        cell = cell.reshape(gs, gs).repeat_interleave(H // gs, 0).repeat_interleave(W // gs, 1)
        return cell[None, :, :, None]

    def get_grad(self, x, y, state: AttackState, gen):
        masks = torch.stack([self._grid_mask(gen, x.shape) for _ in range(5)]).to(x)
        B = x.shape[0]
        with torch.no_grad():
            now, zero = self.model.apply(torch.cat([x + state.delta, x])).float().split(B)
            other_max = (now - 1e9 * F.one_hot(y, now.shape[-1])).argmax(-1)

        def pair_score(lg):  # (n, B, C) -> (n, B)
            return picked_logits(lg, other_max) - picked_logits(lg, y)

        delta = state.delta.detach().requires_grad_(True)
        # x + delta, then each mask's x + delta·mask and x + delta·(1 − mask)
        points = torch.cat([(x + delta)[None], x + delta * masks, x + delta * (1 - masks)])
        logits = self.get_logits(points)
        self.grad_evals += points.shape[0]
        outputs, only_add, leave_one = logits[:1], logits[1:6], logits[6:]
        interaction = (pair_score(outputs) - pair_score(leave_one) - pair_score(only_add)
                       + pair_score(zero[None])).mean(1).sum()
        loss = -softmax_cross_entropy(outputs[0], y).mean() - self.lam * interaction / 32.0
        (grad,) = torch.autograd.grad(loss, delta)
        # the reference steps along minus the momentum of this loss
        return -grad, {}


class P2FA(MIFGSM):
    """Official args: feature_layer='layer2', num_ens=30, eta=28,
    inner_steps=10."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, num_ens=30, feature_layer="layer2", eta=28.0,
                 targeted=False, random_start=False, norm="linfty",
                 loss="crossentropy", inner_steps=10, attack="P2FA", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.num_ens = int(num_ens)
        self.feature_layer = feature_layer
        self.eta = float(eta)
        self.inner_steps = int(inner_steps)

    def _aggregate_grad(self, x, y):
        """Walk ``num_ens`` steps along the L2-normalized CE input gradient,
        summing at each point the gradient of the mean label logit at the
        feature; the negated, per-sample normalized sum."""
        imgs, agg = x.detach(), 0.0
        for _ in range(self.num_ens):
            p = imgs.requires_grad_(True)
            (g,) = torch.autograd.grad(
                softmax_cross_entropy(self.model.apply(p).float(), y).mean(), p)
            imgs = (p + self.eta / 255.0 * l2_normalize(g)).detach()
            logits, feats = self.model.features(imgs, (self.feature_layer,))
            (fg,) = torch.autograd.grad(logits.float().gather(1, y[:, None]).mean(),
                                        feats[self.feature_layer])
            self.grad_evals += 2
            agg = agg + fg.float()
        return -l2_normalize(agg)

    def update_delta(self, delta, x, grad_dir, alpha=None):
        # the reference's inner step: a sign step with its own clip
        delta = torch.clamp(delta + self.alpha * torch.sign(grad_dir), -self.eps, self.eps)
        return torch.clamp(x + delta, img_min, img_max) - x

    def run(self, x, y, gen):
        state = self.init_state(x, y, gen)
        delta = state.delta
        g_feat = 0.0
        for _ in range(self.epoch):
            agg = self._aggregate_grad(x + delta, y)
            with torch.no_grad():
                feat_now = self.model.feature(x + delta, self.feature_layer)[1]
            g_feat = self.decay * g_feat + agg
            target_feat = feat_now + 1e5 * l2_normalize(g_feat)
            for _ in range(self.inner_steps):
                d = delta.detach().requires_grad_(True)
                f = self.model.feature(x + d, self.feature_layer)[1]
                match = (f - target_feat).pow(2).sum(dim=(1, 2, 3)).mean()
                (grad,) = torch.autograd.grad(match, d)
                self.grad_evals += 1
                delta = self.update_delta(delta, x, -grad)
        return torch.clamp(x + delta, img_min, img_max) - x


class TRAP(MIFGSM):
    """Official args: epoch=300 in all, the first baseline_epoch=150 of them
    MI-FGSM at alpha eps/150, then ``epoch − baseline_epoch`` at alpha
    eps/150 with their own clip; beta=0.8, probb=0.9, coeff=0.8,
    feature_layer='layer3'."""

    def __init__(self, model_name="resnet50", epoch=300, eps=16 / 255,
                 baseline_epoch=150, beta=0.8, probb=0.9, coeff=0.8,
                 feature_layer="layer3", decay=1.0, targeted=False,
                 random_start=False, norm="linfty", loss="crossentropy",
                 attack="TRAP", **kwargs):
        kwargs.pop("alpha", None)
        super().__init__(model_name, epoch=baseline_epoch, eps=eps,
                         alpha=eps / baseline_epoch, decay=decay, targeted=targeted,
                         random_start=random_start, norm=norm, loss=loss,
                         attack=attack, **kwargs)
        self.beta = float(beta)
        self.enhance_epoch = max(0, int(epoch) - int(baseline_epoch))
        self.probb = float(probb)
        self.coeff = float(coeff)
        self.feature_layer = feature_layer

    def affine_draws(self, gen, B, device=None):
        """One RandomAffine draw a step: per image an angle in ±90°, shears
        in ±30°, a scale in [0.5, 1.5] and a shift in ±0.2; and whether the
        warp applies at all (probability ``probb``, for the whole batch)."""
        def u(lo, hi):
            return lo + (hi - lo) * self.draw_rows(gen, torch.rand, (B,), device=device)

        return {"ang": u(-90.0, 90.0) * math.pi / 180, "sx": u(-30.0, 30.0) * math.pi / 180,
                "sy": u(-30.0, 30.0) * math.pi / 180, "sc": u(0.5, 1.5),
                "tx": u(-0.2, 0.2), "ty": u(-0.2, 0.2),
                "apply": draw(gen, torch.rand, (), device=device) < self.probb}

    @staticmethod
    def rand_affine(x, ang, sx, sy, sc, tx, ty, apply):
        """The inverse-map affine: rotation plus shear over the scale, plus
        the shift; ``x`` itself where ``apply`` is false."""
        cos, sin = torch.cos(ang), torch.sin(ang)
        theta = torch.stack([torch.stack([cos / sc, (-sin + torch.tan(sx)) / sc, tx], -1),
                             torch.stack([(sin + torch.tan(sy)) / sc, cos / sc, ty], -1)], 1)
        return torch.where(apply, affine_warp(x, theta), x)

    def run(self, x, y, gen):
        init_delta = super().run(x, y, gen)
        with torch.no_grad():
            h_x = self.model.feature(x, self.feature_layer)[1]
            h_star = self.model.feature(x + init_delta, self.feature_layer)[1]
        alpha_enh = self.eps / max(self.enhance_epoch, 1)
        state = self.init_state(x, y, gen)
        delta, momentum = state.delta, state.momentum
        for _ in range(self.enhance_epoch):
            d = delta.detach().requires_grad_(True)
            xt = self.rand_affine(x + d, **self.affine_draws(gen, x.shape[0], x.device))
            h_adv = self.model.feature(xt, self.feature_layer)[1]
            # the displacements flattened over the whole batch (its norms
            # and the dot product summed over every rank's rows)
            B = x.shape[0]
            xdir, ydir = (h_star - h_x).reshape(B, -1), (h_adv - h_x).reshape(B, -1)
            xn = self.batch_sum(xdir * xdir, axis=0).sqrt() + 1e-12
            yn = self.batch_sum(ydir * ydir, axis=0).sqrt() + 1e-12
            loss = self.batch_sum(xdir * ydir, axis=0) / (xn * yn) + (yn / xn) * self.coeff
            (grad,) = torch.autograd.grad(-loss if self.targeted else loss, d)
            self.grad_evals += 1
            momentum = self.get_momentum(grad, momentum)
            delta = torch.clamp(delta + alpha_enh * torch.sign(momentum), -self.eps, self.eps)
            delta = torch.clamp(x + delta, img_min, img_max) - x
            h_star = ((1 - self.beta) * h_adv + self.beta * h_star).detach()
        return torch.clamp(x + delta, img_min, img_max) - x
