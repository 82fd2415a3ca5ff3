"""LLTA, learning to learn transferable attacks (counterpart of
``model_related/llta.py``, its LLTA; LL2S and ATA-ViT attack ViTs and wait
for the port's ViT surgery).

Per-image backward-decay factors γ on each non-first residual block
(DecayReLU, the ResNet's ``gammas``) are searched by importance-weighted
gaussian sampling, then gradients are averaged over sampled meta-tasks
(model augmentation: γ jitter; data augmentation: DIM's resize-pad).  The
draws go through the seams :meth:`LLTA.gamma_noise`,
:meth:`LLTA.model_task_draws`, :meth:`LLTA.data_task_draws` and
:meth:`LLTA.task_perm`.
"""
from __future__ import annotations

import math

import torch

from ..attack import AttackState, draw, softmax_cross_entropy
from ..gradient.mifgsm import MIFGSM
from ..input_transformation.dim import resize_pad, resize_pad_draws
from .sgm import surgery_model

GMIN, GMAX = 0.0, 1e5


class LLTA(MIFGSM):
    """Learning-to-learn transferable attack.  Per iteration:

    1. γ starts at 0.5 per image and decay block and is refined for
       ``inner_iters`` rounds of importance-weighted gaussian search that
       minimises the L2 norm of the input gradient (weights
       exp(−Δ)·1[Δ<0] / q);
    2. a support set of ``spt_size`` tasks (γ jitter, DI) and a query set
       of ``qry_size`` are drawn;
    3. for each of ``task_num`` meta-tasks, an FGSM step on a support
       batch drawn per image gives spt_delta, and the query loss's gradient
       at spt_delta adds to the gradient.

    The reference demands batchsize=1; per-image γ and support draws
    generalise it."""

    def __init__(self, model_name="resnet50", inner_iters=5, nsample=5,
                 task_num=5, sigma=0.05, spt_size=20, qry_size=10,
                 prob_m=0.5, region=0.1, prob_d=0.5, **kwargs):
        kwargs.setdefault("attack", "LLTA")
        super().__init__(surgery_model(model_name, kwargs), **kwargs)
        self.inner_iters = int(inner_iters)
        self.nsample = int(nsample)
        self.task_num = int(task_num)
        self.sigma = float(sigma)
        self.spt_size = int(spt_size)
        self.qry_size = int(qry_size)
        self.prob_m = float(prob_m)
        self.region = float(region)
        self.prob_d = float(prob_d)
        sizes = self.model.module.backbone.stage_sizes
        self.gamma_num = sum(n - 1 for n in sizes)

    # -- draws ---------------------------------------------------------

    def gamma_noise(self, gen, shape, rnd):
        """Round ``rnd``'s gaussian γ perturbations, (nsample, B, G)."""
        return draw(gen, torch.randn, shape, device=self.device) * self.sigma

    def model_task_draws(self, gen, size, shape, which):
        """The γ jitter of a task set (``which``: 'spt' or 'qry'): U(0, 1)
        of (size, B, G) for the offset, of (size, B, 1) against prob_m."""
        B, G = shape
        return (draw(gen, torch.rand, (size, B, G), device=self.device),
                draw(gen, torch.rand, (size, B, 1), device=self.device))

    def data_task_draws(self, gen, x, size, which):
        """Per task: DIM's draws at rate 1/0.875, always applied, and a
        U(0, 1) against prob_d for whether the task uses them."""
        return [(resize_pad_draws(gen, x.shape[1], 1.0 / 0.875, 1.0, x.device),
                 draw(gen, torch.rand, (), device=x.device)) for _ in range(size)]

    def task_perm(self, gen, B, task):
        """Each image's qry_size support entries, drawn without
        replacement: (B, qry_size)."""
        return torch.stack([draw(gen, torch.randperm, self.spt_size, device=self.device)
                            [: self.qry_size] for _ in range(B)])

    # -- the search and the tasks ----------------------------------------

    def _set_logits(self, xs, gammas):
        """(S, B, ...) set forward through the decay surrogate."""
        S, B = xs.shape[0], xs.shape[1]
        logits = self.model.apply(xs.reshape((S * B,) + xs.shape[2:]),
                                  gammas=gammas.reshape(S * B, -1))
        self.grad_evals += S
        return logits.float()

    def _set_ce(self, xs, gammas, y):
        ce = softmax_cross_entropy(self._set_logits(xs, gammas), y.repeat(xs.shape[0])).sum()
        return -ce if self.targeted else ce

    def _l2grads(self, point, y, gammas):
        """Per-image L2 norm of the input gradient under each of a stack of
        γ (S, B, G), the S settings as one batch: (S, B)."""
        pts = point.expand((gammas.shape[0],) + point.shape).detach().requires_grad_(True)
        ce = softmax_cross_entropy(self._set_logits(pts, gammas),
                                   y.repeat(gammas.shape[0])).sum()
        (g,) = torch.autograd.grad(ce, pts)
        return g.flatten(2).norm(dim=2)

    def _optimize_gammas(self, point, y, gen):
        B = point.shape[0]
        gammas = torch.full((B, self.gamma_num), 0.5, device=point.device)
        for rnd in range(self.inner_iters):
            gd = self.gamma_noise(gen, (self.nsample, B, self.gamma_num), rnd)
            norms = self._l2grads(point, y, torch.cat(
                [gammas[None], torch.clamp(gammas[None] + gd, GMIN, GMAX)]))
            diff = norms[1:] - norms[:1]                       # (n, B)
            prob_p = (torch.exp(-diff) * (diff < 0))[..., None]
            prob_q = (torch.exp(-0.5 * (gd / self.sigma) ** 2)
                      / (self.sigma * math.sqrt(2 * math.pi)))
            w = prob_p / prob_q                                # (n, B, G)
            opt = (w * gd).sum(0) / (w.sum(0) + 1e-12)
            gammas = torch.clamp(gammas + opt, GMIN, GMAX)
        return gammas

    def _model_task_set(self, gammas, gen, size, which):
        u, m = self.model_task_draws(gen, size, tuple(gammas.shape), which)
        jitter = (u - 0.5) * 2 * self.region
        mask = (m < self.prob_m).to(gammas.dtype)
        return torch.clamp(gammas[None] + mask * jitter, GMIN, GMAX)

    def _data_task_set(self, x, gen, size, which):
        return torch.stack([torch.where(use < self.prob_d, resize_pad(x, **d), x)
                            for d, use in self.data_task_draws(gen, x, size, which)])

    def get_grad(self, x, y, state: AttackState, gen):
        B = x.shape[0]
        point = (x + state.delta).detach()
        gammas = self._optimize_gammas(point, y, gen)
        spt_g = self._model_task_set(gammas, gen, self.spt_size, "spt")
        spt_x = self._data_task_set(point, gen, self.spt_size, "spt")
        qry_g = self._model_task_set(gammas, gen, self.qry_size, "qry")
        qry_x = self._data_task_set(point, gen, self.qry_size, "qry")
        rows = torch.arange(B, device=x.device)[:, None]
        grads = torch.zeros_like(x)
        for task in range(self.task_num):
            idx = self.task_perm(gen, B, task)                 # (B, q)
            sel_g = spt_g.transpose(0, 1)[rows, idx].transpose(0, 1)
            sel_x = spt_x.transpose(0, 1)[rows, idx].transpose(0, 1)
            # FGSM on the support batch
            d = torch.zeros_like(sel_x).requires_grad_(True)
            (g_spt,) = torch.autograd.grad(self._set_ce(sel_x + d, sel_g, y), d)
            spt_delta = torch.clamp(self.eps * torch.sign(g_spt), -self.eps, self.eps)
            spt_delta = torch.clamp(sel_x + spt_delta, 0.0, 1.0) - sel_x
            # the query gradient at spt_delta
            d = spt_delta.detach().requires_grad_(True)
            (g_qry,) = torch.autograd.grad(self._set_ce(qry_x + d, qry_g, y), d)
            grads = grads + g_qry.sum(0)
        return grads, {}
