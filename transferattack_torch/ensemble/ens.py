"""Ensemble attacks (counterpart of ``ensemble/ens.py``; the reference's
``ensemble/{ens,svre,cwa,adaea,smer}.py``).

The members run one after another on the card, as JAX runs them inside one
jit program; JAX's ``lax.switch`` over members is an index into
``Surrogate.members``.  JAX draws SVRE's members, SMER's schedule and
AdaEA's start inline from the step's key; here they are the seams
:meth:`SVRE.member_draws`, :meth:`SMER.member_schedule` and
:meth:`AdaEA.init_delta` (CWA's and SMER's random start is the base
``init_delta``).  ``grad_evals`` counts the backward passes of B images
through one member (an ensemble pass counts one a member) and
``forward_evals`` the forward-only member passes (AdaEA's scores, SMER's
weight objective).
"""
from __future__ import annotations

import torch

from ..attack import Attack, AttackState, draw, global_l1_normalize, softmax_cross_entropy
from ..models import Surrogate
from ..utils import cnn_model_paper, img_max, img_min


class _MultiModelAttack(Attack):
    """Base of the attacks that take gradients through one member at a
    time.  A ``model_name`` that is not a list is the reference's four
    ResNets, as in JAX (an ensemble surrogate already built is taken as it
    is)."""

    def __init__(self, model_name, **kwargs):
        if not isinstance(model_name, (list, tuple)) and not (
                isinstance(model_name, Surrogate) and model_name.members):
            model_name = ["resnet18", "resnet34", "resnet50", "resnet101"]
        super().__init__(model_name, **kwargs)
        self.members = self.model.members
        self.K = len(self.members)

    def member_loss(self, logits, y):
        ce = self.batch_share(softmax_cross_entropy(logits, y))
        return -ce if self.targeted else ce

    def member_grad(self, point, y, k: int):
        """The loss's input gradient at ``point`` through member ``k`` alone."""
        point = point.detach().requires_grad_(True)
        loss = self.member_loss(self.members[k].apply(point), y)
        self.grad_evals += 1
        return torch.autograd.grad(loss, point)[0]

    def member_ce(self, point, y, k: int):
        """Member ``k``'s mean CE over the whole batch at ``point``, forward
        only."""
        self.forward_evals += 1
        return self.batch_mean(softmax_cross_entropy(self.members[k].apply(point), y))


class ENS(Attack):
    """Logit-mean ensemble (``ens.py:6-37``): the engine on an ensemble
    surrogate; a ``model_name`` that is not a list or a surrogate is the
    paper's four CNNs."""

    def __init__(self, model_name=None, **kwargs):
        if model_name is None or isinstance(model_name, str):
            model_name = list(cnn_model_paper)
        kwargs.setdefault("attack", "ENS")
        super().__init__(model_name, **kwargs)


class SVRE(_MultiModelAttack):
    """Stochastic variance-reduced ensemble (``svre.py:28-95``): M = 4K inner
    steps, each on a random member with the control variate
    ``g_k(inner) − (g_k(adv) − g_ens(adv))``; the inner momentum is the
    outer gradient.  Each inner step takes member k's gradient at
    ``x + delta`` again, as JAX does."""

    def __init__(self, model_name=None, epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, targeted=False, random_start=False, norm="linfty",
                 loss="crossentropy", attack="SVRE", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.M = 4 * self.K

    def member_draws(self, gen, step: int):
        """The member of each of the M inner steps, uniform."""
        return draw(gen, torch.randint, 0, self.K, (self.M,))

    def get_grad(self, x, y, state: AttackState, gen):
        grad = self.input_grad(x + state.delta, y, state, gen)
        inner_delta, inner_G = state.delta, torch.zeros_like(x)
        for k in self.member_draws(gen, state.step).tolist():
            inner_k = self.member_grad(x + inner_delta, y, k)
            adv_k = self.member_grad(x + state.delta, y, k)
            inner_G = self.get_momentum(inner_k - (adv_k - grad), inner_G)
            inner_delta = self.update_delta(inner_delta, x, inner_G)
        return inner_G, {}


class CWA(_MultiModelAttack):
    """Common weakness attack (``cwa.py:20-96``): a reverse ``r_size`` step
    from the ensemble gradient, then one sweep over the members in order on
    the per-image L2-normalised inner momentum (kept across iterations),
    each step clipped here; the net inner displacement, over its global L1,
    is the outer gradient."""

    def __init__(self, model_name=None, epoch=10, eps=16 / 255, alpha=3.2 / 255,
                 decay=1.0, beta=50, r_size=16 / 255 / 15, inner_step_size=250.0,
                 targeted=False, random_start=True, norm="linfty",
                 loss="crossentropy", attack="CWA", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.r_size = float(r_size)
        self.inner_step_size = float(inner_step_size)

    def init_extra(self, x, y):
        return {"inner_momentum": torch.zeros_like(x)}

    def _project(self, x, delta):
        return torch.clamp(x + torch.clamp(delta, -self.eps, self.eps), img_min, img_max) - x

    def get_grad(self, x, y, state: AttackState, gen):
        grad = self.input_grad(x + state.delta, y, state, gen)
        inner_delta = self._project(x, state.delta - self.r_size * torch.sign(grad))
        momentum = state.extra["inner_momentum"]
        for k in range(self.K):
            g = self.member_grad(x + inner_delta, y, k)
            n2 = g.reshape(x.shape[0], -1).norm(dim=1).reshape((-1,) + (1,) * (x.ndim - 1))
            momentum = self.decay * momentum + g / (n2 + 1e-12)
            inner_delta = self._project(x, inner_delta + self.inner_step_size * momentum)
        fake_grad = inner_delta - state.delta
        return global_l1_normalize(fake_grad, self.data_split), {"inner_momentum": momentum}

    def get_momentum(self, grad, momentum):
        # fake_grad is normalised already (``cwa.py:66``)
        return momentum * self.decay + grad


class AdaEA(_MultiModelAttack):
    """Adaptive ensemble (``adaea.py:30-148``): member weights from how well
    each member's one-step example fools the others, the softmax of them on
    the logits, and the gradient masked where the members' per-pixel
    channel cosines disagree."""

    def __init__(self, model_name=None, epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, beta=10.0, threshold=-0.3, targeted=False,
                 random_start=False, norm="linfty", loss="crossentropy",
                 attack="AdaEA", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.beta = float(beta)
        self.threshold = float(threshold)

    def init_delta(self, x, gen):
        """Small Gaussian noise, unclipped (``adaea.py:50``)."""
        return 0.001 * self.draw_rows(gen, torch.randn, x.shape, device=x.device)

    def get_grad(self, x, y, state: AttackState, gen):
        K, xadv = self.K, x + state.delta
        grads = [self.member_grad(xadv, y, k) for k in range(K)]
        with torch.no_grad():
            # each member's one-alpha-step example, scored by every other
            # member and normalised by that member's CE on its own example
            adv = [torch.clamp(x + torch.clamp(xadv + self.alpha * torch.sign(g) - x,
                                               -self.eps, self.eps), img_min, img_max)
                   for g in grads]
            loss_self = [self.member_ce(adv[i], y, i) for i in range(K)]
            w = torch.zeros(K, device=x.device)
            for j in range(K):
                for i in range(K):
                    if i != j:
                        w[j] += self.member_ce(adv[j], y, i) / (loss_self[i] + 1e-12) * self.beta
            alpha_w = torch.softmax(w, 0)
            # the disparity filter: the mean pairwise cosine of the members'
            # gradients over channels, each pixel.  The reference guards the
            # row write with a stale index, so the last member's row stays
            # zero (``adaea.py:115-137``); JAX keeps it, and so does the port
            unit = [g / (g.norm(dim=-1, keepdim=True) + 1e-8) for g in grads]
            rows = [sum((unit[i] * unit[j]).sum(-1) for j in range(K) if j != i) / (K - 1)
                    for i in range(K - 1)] + [torch.zeros(x.shape[:-1], device=x.device)]
            mask = (torch.stack(rows).mean(0)[..., None] >= self.threshold).to(x.dtype)
        delta = state.delta.detach().requires_grad_(True)
        logits = sum(alpha_w[k] * self.members[k].apply(x + delta) for k in range(K))
        grad = torch.autograd.grad(self.member_loss(logits, y), delta)[0]
        self.grad_evals += K
        return grad * mask, {}


class SMER(_MultiModelAttack):
    """Reinforced member reweighting (``smer.py:28-138``): 4K inner steps,
    each on one member of a shuffled schedule with its logits scaled by its
    learned weight; after each, an SGD step on the weights against
    −log of the weighted ensemble's CE (weight decay 2e-3).  That objective
    is differentiated in the weights alone, on member logits taken without
    a graph."""

    def __init__(self, model_name=None, epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, lr=2e-2, weight_decay=2e-3, targeted=False,
                 random_start=True, norm="linfty", loss="crossentropy",
                 attack="SMER", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.m_smer = self.K * 4
        self.lr = float(lr)
        self.weight_decay = float(weight_decay)

    def init_extra(self, x, y):
        return {"weights": torch.ones(self.K, device=x.device)}

    def member_schedule(self, gen, step: int):
        """The members of the ``m_smer`` inner steps: K-member permutations,
        one after another."""
        return torch.cat([draw(gen, torch.randperm, self.K)
                          for _ in range(self.m_smer // self.K)])

    def get_grad(self, x, y, state: AttackState, gen):
        inner_delta, grad_inner = state.delta, torch.zeros_like(x)
        weights = state.extra["weights"]
        for k in self.member_schedule(gen, state.step).tolist():
            point = (x + inner_delta).detach().requires_grad_(True)
            loss = self.member_loss(self.members[k].apply(point) * weights[k], y)
            g = torch.autograd.grad(loss, point)[0]
            self.grad_evals += 1
            with torch.no_grad():
                logits = [self.members[i].apply(x + inner_delta) for i in range(self.K)]
            self.forward_evals += self.K
            # every row reads the weights: the whole batch's CE (rule 3)
            w = weights.detach().requires_grad_(True)
            wr = self.replicated(w)
            ce = self.batch_mean(softmax_cross_entropy(
                sum(lg * wr[i] / self.K for i, lg in enumerate(logits)), y))
            group = -ce if self.targeted else ce
            gw = torch.autograd.grad(-torch.log(group + 1e-12), w)[0]
            weights = weights - self.lr * (gw + self.weight_decay * weights)
            grad_inner = self.get_momentum(g, grad_inner)
            inner_delta = self.update_delta(inner_delta, x, grad_inner)
        return grad_inner, {"weights": weights}
