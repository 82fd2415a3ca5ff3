"""LOGIT, Logit_Margin and POTRIP, the targeted logit-loss family
(counterpart of ``advanced_objective/logit.py``).

All three run the targeted protocol (300 iterations at alpha 2/255) with DI
(``random_resize_pad``, probability 0.7) as the transform, the gradient
smoothed by a 5×5 gaussian (TI), and raw momentum.  The DI draws are the
seam :meth:`LOGIT.transform`, as DIM's are.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..attack import Attack, AttackState, softmax_cross_entropy
from ..input_transformation.dim import random_resize_pad
from ..ops.kernels import gaussian_kernel, smooth_conv


def picked_logits(logits, y):
    """Each copy's logit of its image's label: (n, B, C) → (n, B)."""
    return logits.gather(-1, y[None, :, None].expand(logits.shape[0], -1, 1))[..., 0]


class LOGIT(Attack):
    """Loss = the sum of the target logits.  Official args: epoch=300,
    alpha=2/255, DI rate 1.1 with probability 0.7, TI kernel 5."""

    def __init__(self, model_name="resnet50", epoch=300, eps=16 / 255, alpha=2 / 255,
                 decay=1.0, resize_rate=1.1, diversity_prob=0.7, kernel_size=5,
                 targeted=True, random_start=False, norm="linfty",
                 loss="crossentropy", attack="LOGIT", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.resize_rate = float(resize_rate)
        self.diversity_prob = float(diversity_prob)
        self.kernel = gaussian_kernel(int(kernel_size))

    def transform(self, x, state: AttackState, gen):
        return random_resize_pad(x, gen, self.resize_rate, self.diversity_prob)[None]

    def get_loss(self, logits, y):
        total = picked_logits(logits, y).sum()
        return total if self.targeted else -total

    def post_grad(self, grad, state: AttackState):
        return smooth_conv(grad, self.kernel)

    def get_momentum(self, grad, momentum):
        # raw accumulation, no L1 normalization
        return grad + self.decay * momentum


class Logit_Margin(LOGIT):
    """Cross-entropy toward the target of the logits divided by a
    per-sample detached scale: top1 − top2 ('Margin-based', the reference's
    choice) or a constant ``temperature`` ('Temperature-based')."""

    def __init__(self, *args, temperature=5.0, loss_type="Margin-based",
                 attack="Logit_Margin", **kwargs):
        kwargs["attack"] = attack
        super().__init__(*args, **kwargs)
        self.temperature = float(temperature)
        if loss_type not in ("Margin-based", "Temperature-based"):
            raise ValueError(f"unsupported loss_type {loss_type!r}")
        self.loss_type = loss_type

    def get_loss(self, logits, y):
        lg = logits.reshape((-1,) + logits.shape[2:])
        yb = y.repeat(logits.shape[0])
        if self.loss_type == "Temperature-based":
            scaled = lg / self.temperature
        else:
            top2 = torch.topk(lg, 2, dim=-1).values
            scaled = lg / (top2[:, 0] - top2[:, 1]).detach()[:, None]
        ce = softmax_cross_entropy(scaled, yb).mean()
        return -ce if self.targeted else ce


class POTRIP(LOGIT):
    """Po+Trip: the Poincaré distance to the target one-hot plus a cosine
    triplet away from the source class.  ``prepare_labels`` keeps the
    (source, target) pair of each image."""

    def __init__(self, *args, lamb=0.01, gamma=0.007, attack="POTRIP", **kwargs):
        kwargs["attack"] = attack
        kwargs.setdefault("kernel_size", 5)
        super().__init__(*args, **kwargs)
        self.lamb = float(lamb)
        self.gamma = float(gamma)

    @staticmethod
    def poincare_dis(a, b):
        """Each row's Poincaré distance."""
        l2a = (a ** 2).sum(1)
        l2b = (b ** 2).sum(1)
        theta = 2 * ((a - b) ** 2).sum(1) / ((1 - l2a) * (1 - l2b))
        return torch.arccosh(1.0 + theta + 1e-12)

    @staticmethod
    def cos_dis(a, b):
        """Each row's |cosine|."""
        ab = (a * b).sum(1).abs()
        return ab / (torch.sqrt((a ** 2).sum(1) * (b ** 2).sum(1)) + 1e-8)

    def prepare_labels(self, label):
        y = torch.as_tensor(label, device=self.device).long()
        if y.ndim == 1:  # untargeted calls: the source doubles as the target
            y = torch.stack([y, y], dim=1)
        return y

    def get_loss(self, logits, y):
        lg = logits.reshape((-1,) + logits.shape[2:])
        n = lg.shape[0] // y.shape[0]
        y_tar = F.one_hot(y[:, 1].repeat(n), lg.shape[-1]).to(lg.dtype)
        y_src = F.one_hot(y[:, 0].repeat(n), lg.shape[-1]).to(lg.dtype)
        u = lg / lg.abs().sum(1, keepdim=True)
        v = torch.clamp(y_tar - 1e-5, 0.0, 1.0)
        # means over the copies of the whole batch: the triplet clamps one
        # (rule 3), so on a rank each is summed over every rank's rows

        def mean(rows):
            return self.batch_mean(rows.reshape(n, -1))

        loss_po = mean(self.poincare_dis(u, v))
        loss_trip = torch.clamp(mean(self.cos_dis(y_src, lg)) - mean(self.cos_dis(y_tar, lg))
                                + self.gamma, 0.0, 2.1)
        return -(loss_po + self.lamb * loss_trip)
