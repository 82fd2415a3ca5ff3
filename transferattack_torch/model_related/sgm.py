"""CNN gradient-surgery surrogates (counterpart of ``model_related/sgm.py``).

Each attack is MI-FGSM (or I-/NI-FGSM) on a surrogate built with a
:class:`~transferattack_torch.models.resnet.SurgeryConfig`: γ-scaled ReLU
gradients (SGM), a linear backward from a block on (LinBP), Softplus and
residual downweighting (IAA), SiLU-derivative ReLUs and a softmax-backward
max pool (BPA), and ghost networks, whose every forward scales the skips by
fresh draws (ResNet) or drops features out (Inception-v3).  The ghost draws
are made here, through the seam :meth:`GhostNetwork_MIFGSM.ghost_draw`, and
handed to the model's forward.
"""
from __future__ import annotations

import torch

from ..attack import AttackState, draw
from ..gradient.mifgsm import MIFGSM
from ..models import make_model
from ..models.resnet import SurgeryConfig

# per-architecture stage sizes for layer-spec → global block index
_STAGE_SIZES = {
    "resnet18": (2, 2, 2, 2),
    "resnet34": (3, 4, 6, 3),
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}


def _block_index(layer_spec: str, arch: str = "resnet50") -> int:
    """'3_1' → global block index 8 on ResNet-50."""
    stage, blk = (int(v) for v in layer_spec.split("_"))
    sizes = _STAGE_SIZES.get(arch, (3, 4, 6, 3))
    return sum(sizes[: stage - 1]) + blk


def surgery_model(model_name, kwargs, **model_kwargs):
    """The surrogate ``model_name`` built with ``model_kwargs`` (a surgery,
    a ghost keep rate) on the attack's device, taking ``pretrained`` and
    ``input_size`` out of the attack's ``kwargs``."""
    return make_model(model_name, pretrained=kwargs.pop("pretrained", True),
                      input_size=kwargs.pop("input_size", None),
                      device=kwargs.get("device", "cuda"), **model_kwargs)


class SGM(MIFGSM):
    """Skip gradient method: γ (γ^0.5 on Bottleneck and DenseNet archs)
    scales the backward of the inner ReLUs of every block but the first of
    each stage, and of the stem ReLU; every block output's gradient is
    divided by its std (the reference's hooks as PyTorch registers them)."""

    def __init__(self, model_name="resnet50", gamma=0.2, **kwargs):
        sqrt_archs = ("resnet50", "resnet101", "resnet152", "densenet")
        eff = gamma**0.5 if any(k in model_name for k in sqrt_archs) else gamma
        kwargs.setdefault("attack", "SGM")
        model = surgery_model(model_name, kwargs, surgery=SurgeryConfig(gamma=eff))
        super().__init__(model, **kwargs)


class LinBP(MIFGSM):
    """Linear backprop: identity ReLU backward from linbp_layer='3_1' on."""

    def __init__(self, model_name="resnet50", linbp_layer="3_1", **kwargs):
        kwargs.setdefault("attack", "LinBP")
        surgery = SurgeryConfig(linbp_start=_block_index(linbp_layer, model_name))
        super().__init__(surgery_model(model_name, kwargs, surgery=surgery), **kwargs)


class IAA(MIFGSM):
    """Intrinsic adversarial attack: ReLU → Softplus(β) and per-stage
    residual-branch downweighting λ."""

    BETAS = {"resnet18": 20, "resnet34": 20, "resnet50": 20, "resnet152": 32}
    LAMBDAS = {
        "resnet18": (0.98, 0.87, 0.73, 0.19),
        "resnet34": (0.98, 0.87, 0.73, 0.19),
        "resnet50": (0.98, 0.87, 0.73, 0.19),
        "resnet152": (0.89, 0.88, 0.70, 0.20),
    }

    def __init__(self, model_name="resnet50", **kwargs):
        kwargs.setdefault("attack", "IAA")
        if model_name not in self.BETAS:
            raise ValueError(f"IAA does not support {model_name}")
        surgery = SurgeryConfig(softplus_beta=float(self.BETAS[model_name]),
                                residual_scale=self.LAMBDAS[model_name])
        super().__init__(surgery_model(model_name, kwargs, surgery=surgery), **kwargs)


class BPA(MIFGSM):
    """Backward-pass alignment: softmax-temperature max-pool backward and
    SiLU-derivative ReLU backward from bpa_layer='3_1' on."""

    def __init__(self, model_name="resnet50", bpa_layer="3_1", **kwargs):
        if "resnet" not in model_name:
            raise ValueError("BPA currently supports ResNet only")
        kwargs.setdefault("attack", "BPA")
        surgery = SurgeryConfig(bpa_start=_block_index(bpa_layer, model_name),
                                bpa_maxpool=True)
        super().__init__(surgery_model(model_name, kwargs, surgery=surgery), **kwargs)


class GhostNetwork_MIFGSM(MIFGSM):
    """Ghost networks: every forward samples a network of the ghost family.
    ResNets and Inception-ResNet-v2 scale each residual skip per channel by
    U(1 ± ghost_random_range); Inception-v3 drops out (keep ghost_keep_prob)
    after every stem conv and Mixed block."""

    def __init__(self, model_name="resnet50", ghost_keep_prob=0.994,
                 ghost_random_range=0.16, **kwargs):
        kwargs.setdefault("attack", "GhostNetwork_MIFGSM")
        if "inc_res" in model_name or "inception_resnet" in model_name:
            model = surgery_model("inception_resnet_v2", kwargs,
                                  ghost_range=float(ghost_random_range))
        elif "inception" in model_name or model_name == "inc_v3":
            model = surgery_model("inception_v3", kwargs,
                                  ghost_keep_prob=float(ghost_keep_prob))
        else:
            model = surgery_model(model_name, kwargs, surgery=SurgeryConfig(
                ghost_range=float(ghost_random_range)))
        super().__init__(model, **kwargs)
        self.ghost_keep_prob = float(ghost_keep_prob)
        self.ghost_random_range = float(ghost_random_range)

    def ghost_draw(self, gen, kind: str, name: str, shape, step: int):
        """One draw of a ghost forward (JAX draws them inside the model):
        a skip's per-channel scales U(1 ± range), or a 0/1 dropout keep mask
        of an activation's NHWC shape.  The seam a test feeds JAX's draws
        through, by ``step`` and ``name``."""
        if kind == "ghost_range":  # a channel's scale, shared by the batch
            r = self.ghost_random_range
            return draw(gen, torch.rand, shape, device=self.device) * (2 * r) + (1.0 - r)
        # a mask's rows are those of the flattened (copies · batch) axis
        u = self.draw_copy_rows(gen, torch.rand, shape, device=self.device)
        return (u < self.ghost_keep_prob).float()

    def get_grad(self, x, y, state: AttackState, gen):
        delta = state.delta.detach().requires_grad_(True)
        xs = self.transform(x + delta, state, gen)
        n, b = xs.shape[0], xs.shape[1]

        def ghost(kind, name, shape):
            return self.ghost_draw(gen, kind, name, shape, state.step)

        logits = self.model.apply(xs.reshape((n * b,) + xs.shape[2:]), ghost=ghost)
        self.grad_evals += n
        logits = logits.float().reshape((n, b) + logits.shape[1:])
        (grad,) = torch.autograd.grad(self.get_loss(logits, y), delta)
        return grad, {}


class GhostNetwork_IFGSM(GhostNetwork_MIFGSM):
    def __init__(self, *args, **kwargs):
        kwargs.setdefault("attack", "GhostNetwork_IFGSM")
        kwargs["decay"] = 0.0
        super().__init__(*args, **kwargs)


class GhostNetwork_NIFGSM(GhostNetwork_MIFGSM):
    def __init__(self, *args, **kwargs):
        kwargs.setdefault("attack", "GhostNetwork_NIFGSM")
        super().__init__(*args, **kwargs)

    def transform(self, x, state: AttackState, gen):
        return (x + self.alpha * self.decay * state.momentum)[None]
