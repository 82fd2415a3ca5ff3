"""MetaSSA, meta-learning in the frequency domain (counterpart of
``model_related/metassa.py``).

The reference's inverse DWT drops the LL term, so its high-frequency part
is the Haar high-pass projection and ``x − high`` the LL reconstruction: a
2×2 block average (:func:`lowfreq`), whose backward is the same
projection.  Each meta-train step runs the surrogate on the low-frequency
part of the perturbed point, each meta-test step on the full point; both
mix the clean images' low- and high-frequency features into the live one at
a random residual stage (a·f_lo + b·f_hi + c·f, a + b + c = 1) through a
tap.  The draws go through the seams :meth:`MetaSSA.mix_coeffs` and
:meth:`MetaSSA.gauss_draw`.
"""
from __future__ import annotations

import torch

from ..attack import AttackState, draw, l1_normalize
from ..gradient.mifgsm import MIFGSM

STAGES = ("stage1", "stage2", "stage3", "stage4")


def lowfreq(x):
    """Haar LL-only reconstruction: the 2×2 block average, upsampled back."""
    B, H, W, C = x.shape
    avg = x.reshape(B, H // 2, 2, W // 2, 2, C).mean(dim=(2, 4))
    return avg.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class MetaSSA(MIFGSM):
    """Official args: n_sample=10."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, n_sample=10, targeted=False, random_start=False,
                 norm="linfty", loss="crossentropy", attack="MetaSSA", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.n_sample = int(n_sample)
        taps = self.model.tap_keys()
        self.stages = tuple(s for s in STAGES if s in taps) or ("stage1",)

    def mix_coeffs(self, gen, step, i, phase):
        """(a, b, stage index) of one mixed forward: a ~ U(0, 1),
        b ~ U(0, 1 − a), c = 1 − a − b, a uniform stage (``phase`` 0 is
        meta-train, 1 meta-test)."""
        a = float(draw(gen, torch.rand, ()))
        b = float(draw(gen, torch.rand, ())) * (1 - a)
        return a, b, int(draw(gen, torch.randint, 0, len(self.stages), ()))

    def gauss_draw(self, gen, x, step, i, phase):
        """N(0, eps²) exploration noise."""
        return self.draw_rows(gen, torch.randn, x.shape, device=x.device) * self.eps

    def _loss_grad(self, point_of, delta, f_lo, f_hi, coeffs, y):
        """Gradient in ``delta`` of the loss at ``point_of(delta)``, the
        clean features mixed in at the drawn stage."""
        a, b, sel = coeffs
        stage = self.stages[sel]

        def tap(feat):
            return a * f_lo[stage] + b * f_hi[stage] + (1 - a - b) * feat.float()

        d = delta.detach().requires_grad_(True)
        logits = self.model.apply(point_of(d), tap_fns={stage: tap}).float()
        self.grad_evals += 1
        return torch.autograd.grad(self.get_loss(logits[None], y), d)[0]

    def run(self, x, y, gen):
        lo = lowfreq(x)
        with torch.no_grad():
            f_lo = {k: v.float() for k, v in self.model.features(lo, self.stages)[1].items()}
            f_hi = {k: v.float() for k, v in self.model.features(x - lo, self.stages)[1].items()}
        state = self.init_state(x, y, gen)
        grad_pre_train = torch.zeros_like(x)
        grad_pre_test = torch.zeros_like(x)
        for t in range(self.epoch):
            # meta-train: n_sample inner updates on the low-frequency part,
            # recording the trajectory
            d, traj = state.delta, []
            for i in range(self.n_sample):
                gauss = self.gauss_draw(gen, x, t, i, 0)
                coeffs = self.mix_coeffs(gen, t, i, 0)
                g = self._loss_grad(lambda dd: lowfreq(x + dd + gauss), d, f_lo, f_hi,
                                    coeffs, y)
                grad_pre_train = self.get_momentum(g, grad_pre_train)
                d = self.update_delta(d, x, grad_pre_train)
                traj.append(d)
            # meta-test: normalised gradients at each trajectory point, on
            # the full perturbed point
            total = torch.zeros_like(x)
            for i, d in enumerate(traj):
                gauss = self.gauss_draw(gen, x, t, i, 1)
                coeffs = self.mix_coeffs(gen, t, i, 1)
                g = self._loss_grad(lambda dd: x + dd + gauss, d, f_lo, f_hi, coeffs, y)
                total = total + l1_normalize(g)
            grad_pre_test = total / self.n_sample + grad_pre_test
            delta = self.update_delta(state.delta, x, grad_pre_train + grad_pre_test)
            state = AttackState(delta=delta, momentum=state.momentum, step=t + 1)
        return self.finalize(state, x, y)
