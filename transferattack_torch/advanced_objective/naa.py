"""NAA and DANAA, neuron attribution attacks (counterpart of
``advanced_objective/naa.py``).

NAA: the feature gradient aggregated along the straight path from a black
image (N points), then the attack on the attribution
``(feature − feature of the black image) · weight``.  DANAA walks a noisy
adversarial path instead; its noise is the seam :meth:`DANAA.path_noise`.
"""
from __future__ import annotations

import torch

from . import objective_loop
from .fia import FIA, l2_normalize, label_prob_sum


class NAA(FIA):
    """Official args: feature_layer='layer1', N=30.  Steps with the raw
    negated gradient, as the reference does."""

    use_momentum = False
    step_sign = -1.0

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, N=30, feature_layer="layer1", targeted=False,
                 random_start=False, norm="linfty", loss="crossentropy",
                 attack="NAA", **kwargs):
        kwargs.pop("num_ens", None), kwargs.pop("drop_rate", None)
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         num_ens=N, feature_layer=feature_layer, targeted=targeted,
                         random_start=random_start, norm=norm, loss=loss,
                         attack=attack, **kwargs)
        self.N = int(N)

    def perturb_input(self, x, gen, i):
        # the straight path from the black image
        return x * (i / self.N)

    def aggregate_grad(self, x, y, gen):
        return sum(self.feature_grad(self.perturb_input(x, gen, i), y)
                   for i in range(self.N)) / self.N

    def baseline_and_agg(self, x, y, gen):
        """The path-aggregated weight and the black image's feature."""
        agg = self.aggregate_grad(x, y, gen)
        with torch.no_grad():
            y_prime = self.model.feature(torch.zeros_like(x), self.feature_layer)[1]
        return agg, y_prime

    def attribution_loss(self, feat, y_prime, agg_grad):
        return ((feat - y_prime) * agg_grad).sum()

    def run(self, x, y, gen):
        agg_grad, y_prime = self.baseline_and_agg(x, y, gen)

        def loss(d, state):
            feat = self.model.feature(x + d, self.feature_layer)[1]
            return self.attribution_loss(feat, y_prime, agg_grad)

        return objective_loop(self, x, y, gen, loss, self.use_momentum, self.step_sign)


class DANAA(NAA):
    """Adversarial non-linear path: each of the N probes takes the feature
    gradient at x_t + N(0, scale²) and walks x_t by lr·sign of the input
    gradient there; the weight is the negated, per-sample normalized sum,
    the baseline the feature at the walk's end.  Steps with its momentum
    over the balanced attribution mean (gamma=1)."""

    use_momentum = True
    step_sign = 1.0

    def __init__(self, *args, scale=0.25, lr=0.0025, gamma=1.0,
                 feature_layer="layer2", attack="DANAA", **kwargs):
        kwargs["attack"] = attack
        kwargs["feature_layer"] = feature_layer
        kwargs.pop("scale_inv", None)
        super().__init__(*args, **kwargs)
        self.scale = float(scale)
        self.lr = float(lr)
        self.gamma = float(gamma)

    def path_noise(self, gen, x, i):
        """Probe ``i``'s standard normal draw, the shape of the batch."""
        return self.draw_rows(gen, torch.randn, x.shape, device=x.device)

    def attribution_loss(self, feat, y_prime, agg_grad):
        attribution = (feat - y_prime) * agg_grad
        loss = torch.where(attribution >= 0, attribution, self.gamma * attribution).mean()
        return -loss if self.targeted else loss

    def baseline_and_agg(self, x, y, gen):
        agg, xt = 0.0, x
        for i in range(self.N):
            point = (xt + self.scale * self.path_noise(gen, x, i)).requires_grad_(True)
            # one backward gives both: the feature gradient and the input
            # gradient of the same score (JAX takes them in two passes)
            logits, feats = self.model.features(point, (self.feature_layer,))
            g_feat, g_in = torch.autograd.grad(label_prob_sum(logits, y),
                                               (feats[self.feature_layer], point))
            self.grad_evals += 1
            agg = agg + g_feat.float()
            xt = xt + self.lr * torch.sign(g_in)
        with torch.no_grad():
            y_base = self.model.feature(xt, self.feature_layer)[1]
        return -l2_normalize(agg), y_base
