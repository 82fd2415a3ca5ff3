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
its own generator seeded ``seed + 77``.

SASD-WS attacks the sharpness-aware self-distilled checkpoint with every
conv kernel scaled once by p = 0.93, with DI and TI built in.
"""
from __future__ import annotations

import os
import warnings

import torch

from ..attack import AttackState, draw
from ..gradient.mifgsm import MIFGSM
from ..input_transformation.dim import random_resize_pad
from ..model_related.checkpoint_surrogates import load_checkpoint
from ..model_related.sgm import surgery_model
from ..models import load_npz, record_fallback, weights_root
from ..ops.kernels import gaussian_kernel, smooth_conv
from ..utils.bridge import flat_to_state_dict


def load_weight_collection(prefix: str, max_sets: int = 40):
    """The flat variables of every ``<prefix>_<i>.npz`` there is, i < ``max_sets``."""
    paths = [os.path.join(weights_root(), f"{prefix}_{i}.npz") for i in range(max_sets)]
    return [load_npz(p) for p in paths if os.path.exists(p)]


def _like(value, ref: torch.Tensor) -> torch.Tensor:
    """``value`` in ``ref``'s dtype, device and memory format."""
    return torch.empty_like(ref).copy_(torch.as_tensor(value))


class LGV(MIFGSM):
    """Large geometric vicinity: each iteration the gradient of one weight
    set drawn uniformly from the collection (:meth:`model_index`)."""

    def __init__(self, model_name="resnet50", n_models=10, jitter_std=0.01,
                 ckpt_prefix="lgv_resnet50", **kwargs):
        kwargs.setdefault("attack", "LGV")
        super().__init__(model_name, **kwargs)
        base = dict(self.model.module.named_parameters())
        sets = load_weight_collection(ckpt_prefix)
        if sets:
            self.param_sets = []
            for flat in sets:
                sd = flat_to_state_dict({k: v for k, v in flat.items()
                                         if k.startswith("params/")})
                self.param_sets.append({k: _like(sd[k], p) for k, p in base.items()})
        else:
            record_fallback(ckpt_prefix)
            warnings.warn(f"LGV: no {ckpt_prefix}_*.npz weight sets found; sampling "
                          "gaussian-jittered base weights instead")
            gen = torch.Generator().manual_seed(self.seed + 77)
            self.param_sets = []
            for _ in range(int(n_models)):
                jittered = {}
                for k, p in base.items():
                    # in fp32 from the parameters as the surrogate holds them
                    pf = p.detach().float().cpu()
                    noise = torch.randn(pf.shape, generator=gen)
                    jittered[k] = _like(pf + jitter_std * pf.std(correction=0) * noise, p)
                self.param_sets.append(jittered)
        self.num_sets = len(self.param_sets)

    def model_index(self, gen, step: int) -> int:
        """The weight set of iteration ``step``, uniform."""
        return int(draw(gen, torch.randint, 0, self.num_sets, ()))

    def get_grad(self, x, y, state: AttackState, gen):
        params = self.param_sets[self.model_index(gen, state.step)]
        delta = state.delta.detach().requires_grad_(True)
        logits = self.model.apply(x + delta, params=params)
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
