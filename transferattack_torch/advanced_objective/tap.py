"""TAP and Fuzziness_Tuned (counterpart of ``advanced_objective/tap.py``).

TAP: loss = CE + λ·Σ_stages ‖sign(f)|f|^α − sign(f′)|f′|^α‖² + η·|avgpool(x − x′)|
over the four stage features (JAX's stand-in for the reference's every
block), ascended with the raw gradient.  Fuzziness_Tuned: cross-entropy of
the logits with the label's logit scaled by K, at temperature T.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..attack import Attack, softmax_cross_entropy
from . import objective_loop


def powsign(f, a: float):
    return torch.sign(f) * f.abs() ** a


def avg_pool_nhwc(x, s: int):
    """Flax's ``avg_pool`` (window and stride ``s``, no padding) of NHWC ``x``."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), s, s).permute(0, 2, 3, 1)


class TAP(Attack):
    """Official args: lam=0.005, alpha_tap=0.5, s=3, yita=0.01, epoch=100."""

    def __init__(self, model_name="resnet50", epoch=100, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, lam=0.005, alpha_tap=0.5, s=3, yita=0.01, targeted=False,
                 random_start=False, norm="linfty", loss="crossentropy",
                 attack="TAP", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.lam = float(lam)
        self.alpha_tap = float(alpha_tap)
        self.s = int(s)
        self.yita = float(yita)

    def tap_loss(self, x, y, delta, orig_feats):
        xadv = x + delta
        logits, feats = self.model.apply_with_feats(xadv, "stage")
        total = self.batch_share(softmax_cross_entropy(logits, y))
        for k, fo in orig_feats.items():
            diff = powsign(fo, self.alpha_tap) - powsign(feats[k], self.alpha_tap)
            total = total + self.lam * (diff ** 2).sum()
        pooled = avg_pool_nhwc(x - xadv, self.s)
        # p·sign(p) = |p| with the reference's subgradient 0 at 0
        total = total + self.yita * (pooled * torch.sign(pooled)).sum()
        return -total if self.targeted else total

    def run(self, x, y, gen):
        with torch.no_grad():
            orig_feats = self.model.apply_with_feats(x, "stage")[1]
        return objective_loop(self, x, y, gen,
                              lambda d, state: self.tap_loss(x, y, d, orig_feats))


class Fuzziness_Tuned(Attack):
    """Official args: K=0.8, T=2."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, K=0.8, T=2.0, targeted=False, random_start=False,
                 norm="linfty", loss="crossentropy", attack="Fuzziness_Tuned",
                 **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.K = float(K)
        self.T = float(T)

    def get_loss(self, logits, y):
        onehot = F.one_hot(y, logits.shape[-1]).to(logits.dtype)
        scaled = logits * (1.0 + (self.K - 1.0) * onehot)
        return super().get_loss(scaled / self.T, y)
