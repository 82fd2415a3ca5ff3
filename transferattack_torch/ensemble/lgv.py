"""Attacks on a collection of checkpoints (counterpart of ``ensemble/lgv.py``;
the reference's ``ensemble/{lgv,mba,sasd_ws}.py``).

LGV draws one weight set of a collection each iteration and takes the
gradient through it; MBA is LGV over another collection.  The sets load
from ``$TA_TPU_WEIGHTS_DIR/<prefix>_<i>.npz`` (i < 40) in the JAX package's
flat layout, through the weights bridge; only their ``params`` are taken,
the surrogate's BatchNorm statistics stay.  One module serves every set:
the drawn set goes in through ``Surrogate.apply(params=)``.  Without a
collection the attack warns, records the fallback and jitters the base
parameters ``n_models`` times, ``l + jitter_std·std(l)·N(0, 1)`` on every
parameter (BatchNorm's scale and bias included, its statistics not), from
its own generator seeded ``seed + 77`` (the seam :meth:`LGV.jitter_noise`).

Under a low-precision ``compute_dtype`` the two kinds of set run as JAX runs
them.  A jittered set is computed in that dtype's arithmetic from the
parameters rounded to it (each operation rounded, the standard deviation's
variance too) and runs in it.  A loaded collection stays fp32: the input is
lowered and preprocessed in the compute dtype, then the backbone runs in
fp32 on the set's parameters, with the surrogate's BatchNorm statistics
rounded (:class:`CollectionModel`).

SASD-WS attacks the sharpness-aware self-distilled checkpoint with every
conv kernel scaled once by p = 0.93, with DI and TI built in.
"""
from __future__ import annotations

import copy
import dataclasses
import os
import warnings

import torch
from torch import nn

from ..attack import AttackState, draw
from ..gradient.mifgsm import MIFGSM
from ..input_transformation.dim import random_resize_pad
from ..model_related.checkpoint_surrogates import load_checkpoint
from ..model_related.sgm import surgery_model
from ..models import (bf16_bn_multiplier, load_npz, record_fallback, unit_bn_denominator,
                      weights_root)
from ..ops.kernels import gaussian_kernel, smooth_conv
from ..utils.bridge import flat_to_state_dict


def load_weight_collection(prefix: str, max_sets: int = 40):
    """The flat variables of every ``<prefix>_<i>.npz`` there is, i < ``max_sets``."""
    paths = [os.path.join(weights_root(), f"{prefix}_{i}.npz") for i in range(max_sets)]
    return [load_npz(p) for p in paths if os.path.exists(p)]


def _like(value, ref: torch.Tensor) -> torch.Tensor:
    """``value`` in ``ref``'s dtype, device and memory format."""
    return torch.empty_like(ref).copy_(torch.as_tensor(value))


def jittered(leaf: torch.Tensor, jitter_std: float, noise: torch.Tensor) -> torch.Tensor:
    """``leaf + jitter_std·std(leaf)·noise`` in ``leaf``'s dtype, as JAX
    computes it on a leaf of that dtype: each operation in fp32 and rounded
    to the dtype (the scalar ``jitter_std`` too, a weak type), the variance
    summed in fp32 and rounded before its square root."""
    dt = leaf.dtype

    def rnd(t):
        return t.to(dt).float()

    lf = leaf.float()
    var = ((lf - lf.mean()) ** 2).sum() / lf.numel()
    std = rnd(rnd(var).sqrt())
    scale = rnd(rnd(torch.tensor(jitter_std)) * std)
    return rnd(lf + rnd(scale * noise.float())).to(dt)


class CollectionModel(nn.Module):
    """A surrogate's module as JAX runs a loaded fp32 weight set under a
    low-precision compute dtype: the surrogate's preprocessing in that dtype
    (shared, on the lowered input), then an fp32 copy of its backbone whose
    statistics are the surrogate's, rounded.  Flax promotes the bf16 input
    and statistics to the set's fp32 parameters, but computes BatchNorm's
    ``rsqrt(var + eps)`` from statistics alone, in bf16; here that
    multiplier (:func:`~transferattack_torch.models.bf16_bn_multiplier`) is
    folded into each set's BatchNorm scale by :meth:`fold`, and the
    denominator made 1 (:func:`~transferattack_torch.models.unit_bn_denominator`).
    Its parameter names are the surrogate module's."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.preprocess = module.preprocess
        self.backbone = copy.deepcopy(module.backbone).float()
        self.multipliers = {}
        with torch.no_grad():
            for name, m in self.backbone.named_modules():
                if isinstance(m, nn.BatchNorm2d):
                    self.multipliers[f"backbone.{name}.weight"] = bf16_bn_multiplier(m)
                    unit_bn_denominator(m)

    def fold(self, params: dict) -> dict:
        """``params`` with each BatchNorm scale times its multiplier."""
        return {k: v * self.multipliers[k] if k in self.multipliers else v
                for k, v in params.items()}

    def forward(self, x, **backbone_kwargs):
        h = self.preprocess(x).float()
        return self.backbone(h.permute(0, 3, 1, 2), **backbone_kwargs)


class LGV(MIFGSM):
    """Large geometric vicinity: each iteration the gradient of one weight
    set drawn uniformly from the collection (:meth:`model_index`)."""

    def __init__(self, model_name="resnet50", n_models=10, jitter_std=0.01,
                 ckpt_prefix="lgv_resnet50", **kwargs):
        kwargs.setdefault("attack", "LGV")
        super().__init__(model_name, **kwargs)
        # the surrogate a set runs on: the attack's own, or for a loaded
        # collection under a low-precision dtype an fp32 view of it
        self.set_model = self.model
        sets = load_weight_collection(ckpt_prefix)
        if sets:
            folded = None
            if self.compute_dtype is not None:
                view = CollectionModel(self.model.module)
                self.set_model = dataclasses.replace(self.model, module=view)
                folded = view.fold
            own = dict(self.set_model.module.named_parameters())
            self.param_sets = []
            for flat in sets:
                sd = flat_to_state_dict({k: v for k, v in flat.items()
                                         if k.startswith("params/")})
                params = {k: _like(sd[k], p) for k, p in own.items()}
                self.param_sets.append(folded(params) if folded else params)
        else:
            record_fallback(ckpt_prefix)
            warnings.warn(f"LGV: no {ckpt_prefix}_*.npz weight sets found; sampling "
                          "gaussian-jittered base weights instead")
            gen = torch.Generator().manual_seed(self.seed + 77)
            base = dict(self.model.module.named_parameters())
            self.param_sets = []
            for i in range(int(n_models)):
                self.param_sets.append({
                    k: _like(jittered(p.detach().cpu(), jitter_std,
                                      self.jitter_noise(gen, i, k, p)), p)
                    for k, p in base.items()})
        self.num_sets = len(self.param_sets)

    def jitter_noise(self, gen, index: int, name: str, param: torch.Tensor) -> torch.Tensor:
        """The N(0, 1) draws that jitter parameter ``name`` in set ``index``
        (JAX draws them in the parameter's dtype), on the CPU."""
        return torch.randn(param.shape, generator=gen).to(param.dtype)

    def model_index(self, gen, step: int) -> int:
        """The weight set of iteration ``step``, uniform."""
        return int(draw(gen, torch.randint, 0, self.num_sets, ()))

    def get_grad(self, x, y, state: AttackState, gen):
        params = self.param_sets[self.model_index(gen, state.step)]
        delta = state.delta.detach().requires_grad_(True)
        logits = self.set_model.apply(x + delta, params=params)
        self.grad_evals += 1
        (grad,) = torch.autograd.grad(self.get_loss(logits[None], y), delta)
        return grad, {}


class MBA(LGV):
    """Bayesian-optimized model set: LGV over the fine-tuned collection."""

    def __init__(self, model_name="resnet50", ckpt_prefix="mba_resnet50", **kwargs):
        kwargs.setdefault("attack", "MBA")
        super().__init__(model_name, ckpt_prefix=ckpt_prefix, **kwargs)


class SASD_WS(MIFGSM):
    """Sharpness-aware self-distillation with weight scaling: every conv
    kernel of the SASD checkpoint scaled once by ``p`` at load time (in
    fp32, before a low-precision cast), DI (resize 1.1, prob 0.7) on the
    input and TI (5×5 gaussian) on the gradient; targeted, T = 300,
    alpha = 2/255."""

    def __init__(self, model_name="resnet50", epoch=300, eps=16 / 255, alpha=2 / 255,
                 decay=1.0, p=0.93, resize_rate=1.1, diversity_prob=0.7,
                 kernel_size=5, ckpt_name="sasd_resnet50", targeted=True,
                 random_start=False, norm="linfty", loss="crossentropy",
                 attack="SASD_WS", **kwargs):
        model = surgery_model(model_name, kwargs)
        load_checkpoint(model.module, ckpt_name, "SASD_WS", "base weights used")
        with torch.no_grad():
            for w in model.module.parameters():
                if w.ndim == 4:  # the conv kernels, and nothing else
                    w.mul_(p)
        super().__init__(model, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.p = float(p)
        self.resize_rate = float(resize_rate)
        self.diversity_prob = float(diversity_prob)
        self.kernel = gaussian_kernel(int(kernel_size))

    def transform(self, x, state: AttackState, gen):
        return random_resize_pad(x, gen, self.resize_rate, self.diversity_prob)[None]

    def post_grad(self, grad, state: AttackState):
        return smooth_conv(grad, self.kernel)
