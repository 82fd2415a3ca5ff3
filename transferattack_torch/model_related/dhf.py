"""DHF, diversifying high-level features (counterpart of
``model_related/dhf.py``).

A clean forward stores the features of the high-level blocks; during the
attack, on the images the surrogate already misclassifies, each such
block's output is mixed with its clean feature (weight U(0,
mixup_weight_max) an element) and, element by element with probability
1 − random_keep_prob, replaced by the image's mean.  The mixing is a tap
function (``Surrogate.apply(tap_fns=)``); the draws go through the seams
:meth:`DHFMixin.mixup_uniform` and :meth:`DHFMixin.keep_uniform`.  The
combinations with I-/MI-/NI-FGSM, DIM, TIM, SIM and Admix are mixin
subclasses.
"""
from __future__ import annotations

import torch

from ..attack import AttackState
from ..gradient.mifgsm import MIFGSM, NIFGSM
from ..input_transformation.dim import DIM
from ..input_transformation.sim import SIM, Admix
from ..input_transformation.tim import TIM


def _default_dhf_blocks(model) -> tuple:
    """High-level blocks to diversify, from the surrogate itself: every
    block of a ResNet's last two stages, Inception-v3's Mixed_6*/7* blocks,
    Inception-ResNet-v2's Block17/Block8 repeats, else ``stage2``."""
    backbone = model.module.backbone
    kind = type(backbone).__name__
    if kind == "InceptionV3":
        return ("Mixed_6a", "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                "Mixed_7a", "Mixed_7b", "Mixed_7c")
    if kind == "InceptionResNetV2":
        return tuple(f"repeat_1_{i}" for i in range(20)) + tuple(
            f"repeat_2_{i}" for i in range(9)) + ("block8", "conv2d_7b")
    sizes = getattr(backbone, "stage_sizes", None)
    if sizes is None:
        return ("stage2",)
    return tuple(f"layer{stage}_{j}" for stage in (3, 4) for j in range(sizes[stage - 1]))


class DHFMixin:
    """DHF's machinery, for any base whose ``transform`` makes the copies."""

    def _dhf_init(self, dhf_modules, mixup_weight_max, random_keep_prob):
        self.dhf_modules = (tuple(dhf_modules) if dhf_modules
                            else _default_dhf_blocks(self.model))
        self.mixup_weight_max = float(mixup_weight_max)
        self.random_keep_prob = float(random_keep_prob)

    def init_extra(self, x, y):
        n = self.num_copies() * x.shape[0]
        return {"correct": torch.ones((n,), dtype=x.dtype, device=x.device)}

    def mixup_uniform(self, gen, shape, dtype, step, i):
        """Elementwise U(0, mixup_weight_max) mix weight of module ``i``."""
        return (self.draw_copy_rows(gen, torch.rand, shape, device=self.device)
                * self.mixup_weight_max).to(dtype)

    def keep_uniform(self, gen, shape, step, i):
        """Elementwise U(0, 1), compared with random_keep_prob."""
        return self.draw_copy_rows(gen, torch.rand, shape, device=self.device)

    def _make_taps(self, mix_feats, indicator, gen, step):
        taps = {}
        for i, name in enumerate(self.dhf_modules):
            def tap(feat, mix=mix_feats[name], i=i):
                feat = feat.float()
                mixb = mix.repeat((feat.shape[0] // mix.shape[0],) + (1,) * (mix.ndim - 1))
                ind = indicator.reshape((-1,) + (1,) * (feat.ndim - 1))
                w = ind * self.mixup_uniform(gen, feat.shape, feat.dtype, step, i)
                feat = w * mixb + (1.0 - w) * feat
                mean = feat.mean(dim=tuple(range(1, feat.ndim)), keepdim=True)
                replace = (self.keep_uniform(gen, feat.shape, step, i)
                           >= self.random_keep_prob) & (ind > 0)
                return torch.where(replace, mean, feat)

            taps[name] = tap
        return taps

    def run(self, x, y, gen):
        with torch.no_grad():
            feats = self.model.features(x, self.dhf_modules)[1]
        self._mix_feats = {k: v.float() for k, v in feats.items()}
        return super().run(x, y, gen)

    def get_grad(self, x, y, state: AttackState, gen):
        delta = state.delta.detach().requires_grad_(True)
        xs = self.transform(x + delta, state, gen)
        # DHF applies to the images the surrogate currently misclassifies
        taps = self._make_taps(self._mix_feats, 1.0 - state.extra["correct"], gen,
                               state.step)
        n, b = xs.shape[0], xs.shape[1]
        logits = self.model.apply(xs.reshape((n * b,) + xs.shape[2:]), tap_fns=taps)
        self.grad_evals += n
        logits = logits.float().reshape((n, b) + logits.shape[1:])
        (grad,) = torch.autograd.grad(self.get_loss(logits, y), delta)
        correct = (logits.argmax(-1) == y[None]).to(x.dtype).reshape(-1)
        return grad, {"correct": correct}


def _dhf_class(base, name):
    class _DHF(DHFMixin, base):
        def __init__(self, model_name="resnet50", dhf_modules=None,
                     mixup_weight_max=0.2, random_keep_prob=0.9, **kwargs):
            kwargs.setdefault("attack", name)
            super().__init__(model_name, **kwargs)
            self._dhf_init(dhf_modules, mixup_weight_max, random_keep_prob)

    _DHF.__name__ = name
    _DHF.__qualname__ = name
    return _DHF


DHF_MIFGSM = _dhf_class(MIFGSM, "DHF_MIFGSM")
DHF_NIFGSM = _dhf_class(NIFGSM, "DHF_NIFGSM")
DHF_DIM = _dhf_class(DIM, "DHF_DIM")
DHF_TIM = _dhf_class(TIM, "DHF_TIM")
DHF_SIM = _dhf_class(SIM, "DHF_SIM")
DHF_Admix = _dhf_class(Admix, "DHF_Admix")


class DHF_IFGSM(DHF_MIFGSM):
    """I-FGSM variant: decay=0."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("attack", "DHF_IFGSM")
        super().__init__(*args, **kwargs)
        self.decay = 0.0
