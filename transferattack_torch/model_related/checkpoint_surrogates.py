"""Attacks on another checkpoint of the surrogate (counterpart of
``model_related/checkpoint_surrogates.py``).

Each is MI-FGSM (AGS: momentum-free steps on a feature loss; ANA: three
normalised gradients) against a specially trained surrogate, read from
``$TA_TPU_WEIGHTS_DIR/<ckpt_name>.npz`` in the JAX package's flat layout
through the weights bridge.  When the checkpoint is absent the attack warns,
records the fallback and runs on the base architecture's weights.

QAA attacks a quantized surrogate: symmetric per-output-channel fake
quantization of every conv and linear weight, with a straight-through
estimator (JAX's stand-in for the reference's APoT layers).
"""
from __future__ import annotations

import os
import warnings

import torch
from torch import nn

from ..attack import AttackState, softmax_cross_entropy
from ..gradient.mifgsm import MIFGSM
from ..models import init_weights, load_npz, record_fallback, tap_key, weights_root
from ..utils.bridge import load_flat_variables
from .sgm import surgery_model


def load_checkpoint(module: nn.Module, name: str, who: str, what: str) -> None:
    """Fill ``module`` from ``$TA_TPU_WEIGHTS_DIR/<name>.npz``; when it is
    absent, warn and record the fallback."""
    path = os.path.join(weights_root(), f"{name}.npz")
    if os.path.exists(path):
        load_flat_variables(module, load_npz(path))
    else:
        record_fallback(name)
        warnings.warn(f"{who}: checkpoint {path} not found; {what}")


class CheckpointSurrogateAttack(MIFGSM):
    """MI-FGSM against a fine-tuned surrogate checkpoint."""

    base_arch = "resnet50"
    ckpt_name = ""  # e.g. 'dra_resnet50'

    def __init__(self, model_name=None, **kwargs):
        kwargs.setdefault("attack", type(self).__name__)
        model = surgery_model(model_name or self.base_arch, kwargs)
        if self.ckpt_name:
            load_checkpoint(model.module, self.ckpt_name, type(self).__name__,
                            "running with the base weights")
        super().__init__(model, **kwargs)


class DRA(CheckpointSurrogateAttack):
    """Distribution-relevant fine-tuned ResNet-50."""

    ckpt_name = "dra_resnet50"


class MTA(CheckpointSurrogateAttack):
    """Meta-surrogate ResNet-18."""

    base_arch = "resnet18"
    ckpt_name = "mta_resnet18"


class DSM(CheckpointSurrogateAttack):
    """Dark-surrogate distilled ResNet-18."""

    base_arch = "resnet18"
    ckpt_name = "dsm_resnet18"


class AGS(MIFGSM):
    """Affordable and generalizable substitute training: the SSL ResNet-50
    trunk (checkpoints ags_coco / ags_comics / ags_paintings).  Labels are
    unused: the loss is the feature dissimilarity ``1 − cos(f(x), f(x+δ))``
    at layer2 against the clean image's feature, each step the raw
    gradient's sign (no momentum); random start, alpha=1/255, epoch=300."""

    def __init__(self, model_name="ags_coco", epoch=300, eps=16 / 255,
                 alpha=1.0 / 255, decay=1.0, feature_layer="layer2",
                 targeted=False, random_start=True, norm="linfty",
                 loss="crossentropy", attack="AGS", **kwargs):
        model = surgery_model(kwargs.pop("base_arch", "resnet50"), kwargs)
        load_checkpoint(model.module, model_name, "AGS", "running with the base weights")
        # decay=0: sign(momentum) is the sign of the raw gradient
        super().__init__(model, epoch=epoch, eps=eps, alpha=alpha, decay=0.0,
                         targeted=targeted, random_start=random_start,
                         norm=norm, loss=loss, attack=attack, **kwargs)
        self.feature_layer = feature_layer

    def init_extra(self, x, y):
        with torch.no_grad():
            return {"mid0": self.model.feature(x, self.feature_layer)[1]}

    def dissimilarity(self, point, mid0):
        """Per-image 1 − cos between the feature at ``point`` and ``mid0``."""
        mid = self.model.feature(point, self.feature_layer)[1].reshape(point.shape[0], -1)
        mid0 = mid0.reshape(point.shape[0], -1)
        cos = (mid * mid0).sum(-1) / (mid.norm(dim=-1) * mid0.norm(dim=-1) + 1e-12)
        return 1.0 - cos

    def get_grad(self, x, y, state: AttackState, gen):
        delta = state.delta.detach().requires_grad_(True)
        loss = self.dissimilarity(x + delta, state.extra["mid0"]).mean()
        self.grad_evals += 1
        (grad,) = torch.autograd.grad(loss, delta)
        return grad, {}


class MA(CheckpointSurrogateAttack):
    """KL-min fine-tuned witness model."""

    ckpt_name = "ma_resnet50"


class AlignmentNet(nn.Module):
    """Two same-padded 3×3 convs with ReLUs over the layer3 feature, named
    as the reference's ``Sequential`` (``net.0``, ``net.2``).  NHWC in and
    out, as a tap function sees a feature."""

    def __init__(self, channels: int):
        super().__init__()
        self.net = nn.Sequential(nn.Conv2d(channels, channels, 3, padding=1), nn.ReLU(),
                                 nn.Conv2d(channels, channels, 3, padding=1), nn.ReLU())

    def forward(self, f):
        return self.net(f.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ANA(MIFGSM):
    """Alignment-network attack.  The surrogate is a ResNet-50 with an
    alignment net grafted after layer3 (checkpoint ``ana_alignment``, from
    ``aligned_res50_v3.pth``).  Each iteration takes three gradients: the CE
    of the unaligned branch, and γ·(squared distance) of each branch's
    pooled pre-fc feature from its clean value; each is L2-normalised per
    image and they are summed.  ``eta`` and ``num_ens`` are unused, as in
    the reference's loop.  Without its checkpoint the alignment net is a
    seeded random init (JAX's Flax init cannot be reproduced here)."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255,
                 alpha=1.6 / 255, decay=1.0, gamma=2.0, eta=28.0, num_ens=30,
                 feature_layer="layer3", ckpt_name="ana_alignment",
                 targeted=False, random_start=False, norm="linfty",
                 loss="crossentropy", attack="ANA", **kwargs):
        kwargs.setdefault("attack", attack)
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha,
                         decay=decay, targeted=targeted,
                         random_start=random_start, norm=norm, loss=loss,
                         **kwargs)
        self.gamma = float(gamma)
        self.feature_layer = feature_layer
        self._tap = tap_key(feature_layer)
        channels = self.model.feature_shape((1, 32, 32, 3), self._tap)[-1]
        self.align = AlignmentNet(channels)
        init_weights(self.align, torch.Generator().manual_seed(7))
        load_checkpoint(self.align, ckpt_name, "ANA", "a random-init alignment net")
        self.align.eval().requires_grad_(False).to(self.device)
        stages = [k for k in self.model.tap_keys() if k.startswith("stage")]
        self._pooled = max(stages, key=lambda k: int(k[5:]))  # the pre-fc stage

    def _branches(self, x):
        """(logits, pooled, pooled with the aligned feature): the unaligned
        branch feeds the classifier; the aligned one replaces the layer3
        feature with AlignmentNet(feature); pooled = the pre-fc mean."""
        logits, feats = self.model.features(x, (self._pooled,))
        _, aligned = self.model.features(
            x, (self._pooled,), tap_fns={self._tap: lambda f: self.align(f.float())})
        return (logits.float(), feats[self._pooled].float().mean(dim=(1, 2)),
                aligned[self._pooled].float().mean(dim=(1, 2)))

    def init_extra(self, x, y):
        with torch.no_grad():
            _, pre, post = self._branches(x)
        return {"ref_pre": pre, "ref_post": post}

    def get_grad(self, x, y, state: AttackState, gen):
        delta = state.delta.detach().requires_grad_(True)
        logits, pre, post = self._branches(x + delta)
        ce = softmax_cross_entropy(logits, y).mean()
        parts = (-ce if self.targeted else ce,
                 self.gamma * ((pre - state.extra["ref_pre"]) ** 2).sum(),
                 self.gamma * ((post - state.extra["ref_post"]) ** 2).sum())
        grad = torch.zeros_like(x)
        for i, part in enumerate(parts):
            (g,) = torch.autograd.grad(part, delta, retain_graph=i < len(parts) - 1)
            norm = g.reshape(g.shape[0], -1).norm(dim=1).reshape(-1, 1, 1, 1)
            grad = grad + g / (norm + 1e-10)
        self.grad_evals += len(parts)
        return grad, {}


def quantize_per_channel(w, bits: int):
    """Symmetric per-output-channel fake quantization with a straight-through
    estimator.  The output channel is dim 0 of a PyTorch weight, conv (OIHW)
    and linear (out, in) alike; the scale is over every other dim."""
    levels = 2 ** (bits - 1) - 1
    dims = tuple(range(1, w.ndim))
    scale = w.abs().amax(dim=dims, keepdim=True) / levels + 1e-12
    q = torch.round(w / scale) * scale
    return w + (q - w).detach()


class QAA(CheckpointSurrogateAttack):
    """Quantization-aware attack: attack a quantized surrogate; low-bit
    surrogates transfer better."""

    ckpt_name = "qaa_resnet50"

    def __init__(self, model_name=None, bits=4, **kwargs):
        super().__init__(model_name, **kwargs)
        self.bits = int(bits)
        # quantize every conv and linear weight once (an inference-time
        # quantized network); the module is this attack's own
        with torch.no_grad():
            for name, p in self.model.module.named_parameters():
                if p.ndim >= 2 and name.endswith("weight"):
                    p.copy_(quantize_per_channel(p, self.bits))
