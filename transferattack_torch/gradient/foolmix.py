"""Foolmix, dual blending and a direction update (counterpart of
``gradient/foolmix.py``).

Each iteration: (1) images whose true label fell out of the surrogate's
top-(k+1) get a direction-update correction built from class-vs-top-k logit
gradients; (2) n gaussian pixel blocks (the seam :meth:`Foolmix.pixel_blocks`)
blend with the adversary at m scale levels for the mixed gradient, and at z
scale levels under random other-class labels (the seam
:meth:`Foolmix.other_labels`) for the subtracted 'lens' gradient.  Every
forward goes through ``Surrogate.apply``, which takes the bf16 cast.  Its
own clip: the update kernel is not on this path.
"""
from __future__ import annotations

import dataclasses

import torch

from ..attack import Attack, AttackState, softmax_cross_entropy
from ..utils import img_max, img_min


class Foolmix(Attack):
    """Official args: m=5, n=3, z=1, k=5, zeta=0.2, beta=1.0, gamma=0.1."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, m=5, n=3, z=1, k=5, zeta=0.2, beta=1.0, gamma=0.1,
                 targeted=False, random_start=False, norm="linfty",
                 loss="crossentropy", attack="Foolmix", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.m, self.n, self.z, self.k = int(m), int(n), int(z), int(k)
        self.zeta, self.beta, self.gamma = float(zeta), float(beta), float(gamma)

    def _ce_grad_at(self, point, labels):
        """The CE input gradient at one point."""
        point = point.detach().requires_grad_(True)
        ce = softmax_cross_entropy(self.model.apply(point), labels).mean()
        (grad,) = torch.autograd.grad(-ce if self.targeted else ce, point)
        self.grad_evals += 1
        return grad

    def _direction_adjust(self, x, delta, y):
        """Direction update for the images out of the top-(k+1), applied to
        the batch under a mask."""
        xadv = (x + delta).requires_grad_(True)
        logits = self.model.apply(xadv)
        topk_idx = torch.topk(logits.detach(), self.k + 1, dim=1).indices  # (B, k+1)
        in_topk = (topk_idx == y[:, None]).any(dim=1)
        f_y = torch.gather(logits, 1, y[:, None].long())[:, 0]
        f_topk = torch.gather(logits, 1, topk_idx).mean(dim=1)
        (omega_y,) = torch.autograd.grad(f_y.sum(), xadv, retain_graph=True)
        (omega_topk,) = torch.autograd.grad(f_topk.sum(), xadv)
        self.grad_evals += 2
        xdir = omega_y - omega_topk
        numerator = (f_y - f_topk).detach().abs().reshape(-1, 1, 1, 1)
        denominator = xdir.abs().sum(dim=(1, 2, 3), keepdim=True)
        d_dir = numerator / (denominator + 1e-8) * torch.sign(xdir)
        d_mean = d_dir.abs().mean(dim=(1, 2, 3), keepdim=True)
        adjusted = delta - self.gamma * d_dir * (self.alpha / (d_mean + 1e-8))
        return torch.where((~in_topk).reshape(-1, 1, 1, 1), adjusted, delta)

    def pixel_blocks(self, gen, x, step):
        """N(0, 0.1²) pixel blocks, (n, B, H, W, C)."""
        return self.draw_rows(gen, torch.randn, (self.n,) + x.shape, batch_axis=1,
                              device=x.device) * 0.1

    def other_labels(self, gen, batch, step):
        """Uniform random class labels, (n, z, B)."""
        return self.draw_rows(gen, torch.randint, 0, self.model.num_classes,
                              (self.n, self.z, batch), batch_axis=2, device=gen.device)

    def step(self, x, y, state: AttackState, gen):
        delta = state.delta
        if not self.targeted:
            delta = self._direction_adjust(x, delta, y)
        P = self.pixel_blocks(gen, x, state.step)
        L = self.other_labels(gen, x.shape[0], state.step)
        xadv = x + delta
        # the 'lens' gradient: other-class labels at z scale levels
        g_lens = sum(self._ce_grad_at(2.0 ** -i * (xadv + self.zeta * P[j]), L[j, i])
                     for j in range(self.n) for i in range(self.z)) / (self.n * self.z)
        # the blended gradient: true labels at m scale levels
        g_mix = sum(self._ce_grad_at(2.0 ** -i * (xadv + self.zeta * P[j]), y)
                    for j in range(self.n) for i in range(self.m)) / (self.n * self.m)
        g_mix = g_mix - self.beta * g_lens
        g_norm = g_mix.abs().sum(dim=(1, 2, 3), keepdim=True)
        momentum = self.decay * state.momentum + g_mix / (g_norm + 1e-8)
        new_delta = torch.clamp(delta + self.alpha * torch.sign(momentum), -self.eps, self.eps)
        new_delta = torch.clamp(x + new_delta, img_min, img_max) - x
        return dataclasses.replace(state, delta=new_delta, momentum=momentum,
                                   step=state.step + 1)
