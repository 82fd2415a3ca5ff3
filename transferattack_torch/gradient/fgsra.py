"""FGSRA, the frequency-guided sample relevance attack (counterpart of
``gradient/fgsra.py``).

Neighbours are drawn in DCT space (a random spectral mask on the DCT of a
noisy copy; the seam :meth:`FGSRA.spectral_draws`), their gradients are
weighted by input-space cosine relevance and summed, fused with the current
gradient by gradient-space cosine similarity, and stepped with a GRA-style
per-pixel decay indicator.  Its own clip: the update kernel is not on this
path.
"""
from __future__ import annotations

import dataclasses

import torch

from ..attack import Attack, AttackState, cosine_similarity
from ..ops.dct import dct_2d, idct_2d
from ..utils import img_max, img_min


class FGSRA(Attack):
    """Official args: rho=0.7, beta=2.0, max_iter=20, eta=0.94."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 rho=0.7, beta=2.0, max_iter=20, decay=1.0, targeted=False,
                 random_start=False, norm="linfty", loss="crossentropy",
                 attack="FGSRA", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.rho = float(rho)
        self.beta = float(beta)
        self.max_iter = int(max_iter)

    def init_extra(self, x, y):
        # the decay indicator starts at 10/9.4 = 1/0.94
        return {"m": torch.full_like(x, 10.0 / 9.4)}

    def spectral_draws(self, gen, x, state):
        """All ``max_iter`` (gauss, mask) draws of one iteration."""
        shape = (self.max_iter,) + x.shape
        r = self.eps * self.beta
        gauss = self.draw_rows(gen, torch.rand, shape, batch_axis=1, device=x.device) * (2 * r) - r
        mask = (self.draw_rows(gen, torch.rand, shape, batch_axis=1, device=x.device)
                * (2 * self.rho) + (1 - self.rho))
        return gauss, mask

    def relevance_grad(self, xadv, y, gauss, mask):
        """One neighbour's gradient at ``xadv``, weighted by the cosine
        relevance of its spectral copy to ``xadv``."""
        point = xadv.detach().requires_grad_(True)
        x_idct = idct_2d(dct_2d(point + gauss) * mask)
        loss = self.get_loss(self.model.apply(x_idct)[None], y)
        (grad,) = torch.autograd.grad(loss, point)
        self.grad_evals += 1
        return grad * cosine_similarity(xadv, x_idct.detach())

    def step(self, x, y, state: AttackState, gen):
        xadv = x + state.delta
        current_grad = self.input_grad(xadv, y, state, gen)
        # the relevance-weighted sum (not the mean) over the neighbours
        avg_grad = sum(self.relevance_grad(xadv, y, g, m)
                       for g, m in zip(*self.spectral_draws(gen, x, state)))
        s = cosine_similarity(current_grad, avg_grad)
        current = s * current_grad + (1 - s) * avg_grad
        momentum = self.get_momentum(current, state.momentum)
        eq = (torch.sign(momentum) == torch.sign(current)).to(x.dtype)
        m = state.extra["m"] * (eq + (1 - eq) * 0.94)
        delta = torch.clamp(state.delta + self.alpha * m * torch.sign(momentum),
                            -self.eps, self.eps)
        delta = torch.clamp(x + delta, img_min, img_max) - x
        return dataclasses.replace(state, delta=delta, momentum=momentum,
                                   step=state.step + 1, extra={"m": m})
