"""ANDA, asymptotic normal distribution attack (counterpart of
``gradient/anda.py``).

The gradients of ``n_ens`` translated views (a 5×5 grid of normalized
offsets in [-aug_max, aug_max]) are gathered across iterations into a
running mean kept in ``state.extra``, and each step moves by the sign of
that mean, with a clip of its own (the update kernel is not on this path).
The views go through the surrogate ``view_chunk`` at a time (1: one view a
batch, JAX's default).  With ``sample=True`` the final adversary adds one
gaussian sample from the learned low-rank covariance.
"""
from __future__ import annotations

import numpy as np
import torch

from ..attack import Attack, AttackState, draw, softmax_cross_entropy
from ..ops.image import translate
from ..utils import img_max, img_min


class ANDA(Attack):
    """Official args: n_ens=25, aug_max=0.3, decay=0."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 n_ens=25, aug_max=0.3, sample=False, view_chunk=None,
                 targeted=False, random_start=False, norm="linfty",
                 loss="crossentropy", attack="ANDA", **kwargs):
        kwargs.pop("decay", None)
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=0.0,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        n = int(np.sqrt(n_ens))
        if n * n != n_ens:
            raise ValueError("n_ens must be a square number")
        self.view_chunk = 1 if view_chunk is None else int(view_chunk)
        if n_ens % self.view_chunk:
            raise ValueError("view_chunk must divide n_ens")
        self.n_ens = int(n_ens)
        self.aug_max = float(aug_max)
        self.sample = bool(sample)
        r = np.linspace(-self.aug_max, self.aug_max, n)
        # (tx, ty) of each view, tx the outer loop
        self.offsets = [(float(i), float(j)) for i in r for j in r]

    def init_extra(self, x, y):
        extra = {"mean": torch.zeros_like(x), "count": 0.0}
        if self.sample:
            D = int(np.prod(x.shape[1:]))
            extra["dev_rows"] = torch.zeros((self.epoch * self.n_ens, x.shape[0], D),
                                            dtype=x.dtype, device=x.device)
            extra["prev_delta"] = torch.zeros_like(x)
        return extra

    def view_grads(self, xt, y, offsets):
        """(len(offsets), B, H, W, C): each view's gradient w.r.t. ``xt`` of
        its cross-entropy summed over the batch, the views as one batch."""
        points = xt.detach()[None].repeat(len(offsets), 1, 1, 1, 1).requires_grad_(True)
        views = torch.stack([translate(p, tx, ty) for p, (tx, ty) in zip(points, offsets)])
        logits = self.get_logits(views)
        self.grad_evals += len(offsets)
        ce = softmax_cross_entropy(logits, y).sum()
        (g,) = torch.autograd.grad(-ce if self.targeted else ce, points)
        return g

    def step(self, x, y, state: AttackState, gen):
        xt = x + state.delta
        c = self.view_chunk
        chunks = [self.view_grads(xt, y, self.offsets[i:i + c])
                  for i in range(0, self.n_ens, c)]
        if self.sample:
            grads = torch.cat(chunks)
            gsum = grads.sum(0)
        else:
            gsum = sum(g.sum(0) for g in chunks)
        n = state.extra["count"]
        mean = state.extra["mean"] * n / (n + self.n_ens) + gsum / (n + self.n_ens)
        extra = {"mean": mean, "count": n + self.n_ens}
        if self.sample:
            rows = state.extra["dev_rows"].clone()
            k0 = state.step * self.n_ens
            rows[k0:k0 + self.n_ens] = (grads - mean[None]).reshape(self.n_ens, x.shape[0], -1)
            extra["dev_rows"] = rows
            extra["prev_delta"] = state.delta
            if state.step + 1 == self.epoch:
                # the covariance sample's weights, drawn after the last
                # step (finalize takes no generator)
                extra["z"] = draw(gen, torch.randn, rows.shape[0], device=x.device)
        xt = torch.clamp(xt + self.alpha * torch.sign(mean), img_min, img_max)
        xt = torch.minimum(torch.maximum(xt, x - self.eps), x + self.eps)
        return AttackState(delta=xt - x, momentum=state.momentum, step=state.step + 1,
                           extra=extra)

    def finalize(self, state: AttackState, x, y):
        if not self.sample:
            return super().finalize(state, x, y)
        # one gaussian sample from the learned low-rank covariance:
        # mean + z @ dev_rows / sqrt(K - 1), stepped from the adversary
        # before the last update
        rows, z = state.extra["dev_rows"], state.extra["z"]
        K = rows.shape[0]
        noise = state.extra["mean"] + (torch.einsum("k,kbd->bd", z, rows)
                                       / np.sqrt(K - 1)).reshape(x.shape)
        xt = torch.clamp(x + state.extra["prev_delta"] + self.alpha * torch.sign(noise),
                         img_min, img_max)
        xt = torch.minimum(torch.maximum(xt, x - self.eps), x + self.eps)
        return xt - x
