"""Surrogate-model zoo (counterpart of ``transferattack_tpu/models/__init__.py``).

Every surrogate is an ``nn.Module`` wrapped with its preprocessing (resize +
normalize), so attacks work in raw ``[0, 1]`` pixel space.  The public layout
is the JAX package's: ``(B, H, W, C)``.  Inside, the backbone takes
``x.permute(0, 3, 1, 2)`` of the contiguous NHWC tensor, which is an NCHW
tensor with ``channels_last`` strides, so cuDNN gets its preferred layout
without a copy.

Weights: ``$TA_TPU_WEIGHTS_DIR/<name>.npz`` in the JAX package's flat layout,
loaded through :mod:`transferattack_torch.utils.bridge`; absent that, a
seeded random init, recorded by :func:`record_fallback`.
"""
from __future__ import annotations

import dataclasses
import math
import os
import re
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.bridge import load_flat_variables
# one registry of fallbacks, the manifest's, and its weights root
from ..utils.weights_manifest import (_FALLBACKS, fallback_weights_used,  # noqa: F401
                                      record_fallback, weights_root)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
INCEPTION_MEAN = (0.5, 0.5, 0.5)
INCEPTION_STD = (0.5, 0.5, 0.5)

# name -> (builder() -> nn.Module, input_size, mean, std, sized)
_MODEL_REGISTRY: Dict[str, Tuple[Callable[..., nn.Module], int, tuple, tuple, bool]] = {}


def register_model(name, input_size=224, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                   sized=False):
    """Register ``builder`` under ``name``.  ``sized``: the builder takes
    ``img_size``, because its parameter shapes depend on the input size
    (a Flax module infers them from its first input; a torch module is
    built before it sees one)."""
    def deco(builder):
        _MODEL_REGISTRY[name] = (builder, input_size, mean, std, sized)
        return builder

    return deco


def list_models() -> List[str]:
    return sorted(_MODEL_REGISTRY)


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing CUDA when no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain path on the CPU")
    return dev


class Preprocess(nn.Module):
    """Resize + normalize on NHWC input (JAX ``Preprocess``)."""

    def __init__(self, size: int, mean: tuple, std: tuple):
        super().__init__()
        self.size = size
        self.register_buffer("mean", torch.tensor(mean, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("std", torch.tensor(std, dtype=torch.float32),
                             persistent=False)

    def forward(self, x):
        if x.shape[1] != self.size or x.shape[2] != self.size:
            # jax.image.resize antialiases when it shrinks; F.interpolate
            # does so only when asked (and antialiasing an enlargement
            # changes nothing)
            x = F.interpolate(x.permute(0, 3, 1, 2), size=(self.size, self.size),
                              mode="bilinear", align_corners=False,
                              antialias=x.shape[1] > self.size)
            x = x.permute(0, 2, 3, 1).contiguous()
        return (x - self.mean) / self.std


class WrappedModel(nn.Module):
    """Preprocessing + backbone; NHWC in, logits out."""

    def __init__(self, backbone: nn.Module, size: int, mean: tuple, std: tuple):
        super().__init__()
        self.preprocess = Preprocess(size, mean, std)
        self.backbone = backbone

    def forward(self, x, **backbone_kwargs):
        # a contiguous NHWC tensor permuted to NCHW is channels_last: no copy
        return self.backbone(self.preprocess(x).permute(0, 3, 1, 2), **backbone_kwargs)


@dataclasses.dataclass
class Surrogate:
    """A ready-to-attack model: module + metadata."""

    name: str
    module: nn.Module
    input_size: int
    num_classes: int = 1000
    # set by Attack.__init__ for a low-precision forward: apply() casts fp32
    # input to this dtype and returns fp32 logits
    compute_dtype: Optional[torch.dtype] = None
    # keywords every forward passes to the backbone (a ViT's ``surgery``:
    # ``models.vit.with_surgery`` makes such a view of a surrogate)
    forward_kwargs: Dict[str, object] = dataclasses.field(default_factory=dict)
    # an ensemble's members (:func:`make_ensemble`): one surrogate a
    # submodule of ``module``, sharing its parameters; empty for one model
    members: Tuple["Surrogate", ...] = ()

    def apply(self, x, tap_fns: Optional[Dict[str, Callable]] = None,
              params: Optional[Dict[str, torch.Tensor]] = None, **backbone_kwargs):
        """Logits of NHWC ``x``.  ``tap_fns`` maps a tap to a function that
        replaces that activation in the forward graph (JAX's ``tap_fns``):
        it sees and returns the activation in NHWC, in the compute dtype.
        ``params`` (names of :meth:`parameters`) stand in for the module's
        own, which stay frozen and untouched: ``torch.func.functional_call``,
        so that a loss is differentiable in them (MUP, AWT).  Other keywords
        go to the backbone's ``forward``: ResNet's LLTA ``gammas``, a ghost
        network's ``ghost`` draws, a ViT's ``surgery`` or ``extra_tokens``."""
        return self.features(x, (), tap_fns, params, **backbone_kwargs)[0]

    def parameters(self) -> Dict[str, torch.Tensor]:
        """The module's parameters by name, detached: a dict to edit and
        pass back to :meth:`apply` as ``params``."""
        return {k: v.detach() for k, v in self.module.named_parameters()}

    def features(self, x, layers: Sequence[str] = (),
                 tap_fns: Optional[Dict[str, Callable]] = None,
                 params: Optional[Dict[str, torch.Tensor]] = None, **backbone_kwargs):
        """(logits, {layer: activation}) in one forward.

        Each activation is the tensor the rest of the forward reads, in NHWC
        and in the compute dtype, after its tap function if it has one, so
        ``torch.autograd.grad(loss, feats[layer])`` is the feature gradient
        that JAX takes at a zero offset added there (the reference's
        backward hook).  Under grad mode it requires grad even where
        nothing before it does.  Forward hooks on the tapped modules do the
        work and are removed on the way out; each permutes a module's
        NCHW output (``channels_last``, so the NHWC view is a plain one) to
        NHWC and back, and takes a token sequence or an attention map as it
        is.  Logits come back in fp32.
        """
        tap_fns = tap_fns or {}
        taken: Dict[str, torch.Tensor] = {}

        def hook(name, fn, keep):
            def run(module, inputs, out):
                nchw = out.ndim == 4 and not getattr(module, "token_layout", False)
                f = out.permute(0, 2, 3, 1) if nchw else out
                if fn is not None:
                    f = fn(f).to(out.dtype)
                if keep:
                    if torch.is_grad_enabled() and not f.requires_grad:
                        f = f.detach().requires_grad_(True)
                    taken[name] = f
                return f.permute(0, 3, 1, 2) if nchw else f
            return run

        handles = []
        try:
            for name in dict.fromkeys([*tap_fns, *layers]):
                handles.append(self.tap_module(name).register_forward_hook(
                    hook(name, tap_fns.get(name), name in layers)))
            cd = self.compute_dtype
            lowered = cd is not None and x.dtype == torch.float32
            if lowered:
                x = x.to(cd)
            backbone_kwargs = {**self.forward_kwargs, **backbone_kwargs}
            if params is None:
                logits = self.module(x, **backbone_kwargs)
            else:
                logits = torch.func.functional_call(self.module, params, (x,),
                                                    backbone_kwargs, strict=False)
            if lowered:
                logits = logits.float()
        finally:
            for h in handles:
                h.remove()
        return logits, {name: taken[name] for name in layers}

    def feature(self, x, layer: str):
        """(logits, feature) at a tap named as the reference names it
        (``layer3``, ``layer2.3``) or as JAX keys it (``stage3``,
        ``layer2_3``), the feature in NHWC and fp32."""
        logits, feats = self.features(x, (layer,))
        return logits, feats[layer].float()

    def apply_with_feats(self, x, layer_filter: Union[str, Sequence[str]]):
        """(logits, {tap: feature}) for every tap whose JAX key contains
        ``layer_filter`` (or one of several), features in NHWC and fp32, as
        JAX's ``apply_with_feats`` returns them."""
        filters = (layer_filter,) if isinstance(layer_filter, str) else tuple(layer_filter)
        names = [k for k in self.tap_keys() if any(f in k for f in filters)]
        logits, feats = self.features(x, names)
        return logits, {k: v.float() for k, v in feats.items()}

    def feature_shape(self, x_shape, layer: str) -> Tuple[int, ...]:
        """Shape of a tap's activation for inputs of ``x_shape``, from one
        forward of a single image."""
        param = next(self.module.parameters())
        one = torch.zeros((1,) + tuple(x_shape[1:]), device=param.device)
        with torch.no_grad():
            shape = self.features(one, (layer,))[1][layer].shape
        return (x_shape[0],) + tuple(shape[1:])

    def _backbone(self) -> nn.Module:
        if self.members:
            raise ValueError(f"the ensemble {self.name!r} has no taps (nor has JAX's); "
                             "tap one of its members, surrogate.members[i]")
        return self.module.backbone

    def tap_keys(self) -> List[str]:
        """JAX's key of every tap of the backbone: the backbone's own
        ``tap_keys`` where it has them (a ViT's ``blocks_{i}``, Inception-
        ResNet-v2's ``repeat_*``, DenseNet's ``block{i}``), else the stem
        conv ``conv1``, each stage ``stage{i}`` and each block
        ``layer{i}_{j}``.  An ensemble raises ``ValueError``."""
        backbone = self._backbone()
        if hasattr(backbone, "tap_keys"):
            return backbone.tap_keys()
        keys = [tap_key(n) for n, _ in backbone.named_modules()]
        return [k for k in keys if k == "conv1" or re.fullmatch(r"stage\d+|layer\d+_\d+", k)]

    def tap_module(self, layer: str) -> nn.Module:
        """The module whose output is the tap ``layer``, in either naming
        (or as the backbone's ``tap_path`` maps a JAX key).  An ensemble
        raises ``ValueError``."""
        backbone = self._backbone()
        modules = dict(backbone.named_modules())
        name = layer.replace(" ", ".").strip()
        own = backbone.tap_path(name) if hasattr(backbone, "tap_path") else None
        for cand in (own, name, tap_key(name), reference_name(name)):
            if cand and cand in modules:
                return modules[cand]
        raise KeyError(f"No feature {layer!r} in {type(self.module.backbone).__name__}")


def find_feature(feats: Dict[str, torch.Tensor], key: str):
    """The feature ``key`` of an :meth:`Surrogate.apply_with_feats` dict, or
    None (JAX's ``find_feature`` over its intermediates tree)."""
    return feats.get(key)


def reference_name(key: str) -> str:
    """The reference's module path of a JAX tap key: ``stage2`` → ``layer2``,
    ``layer2_3`` → ``layer2.3``; anything else unchanged."""
    m = re.fullmatch(r"stage(\d+)", key)
    if m:
        return f"layer{m.group(1)}"
    m = re.fullmatch(r"(layer\d+)_(\d+)", key)
    return f"{m.group(1)}.{m.group(2)}" if m else key


def tap_key(reference_layer: str) -> str:
    """JAX's tap key of a reference layer name: ``layer2`` → ``stage2``,
    ``layer2.3`` → ``layer2_3``; anything else unchanged."""
    name = reference_layer.replace(" ", ".").strip()
    if "." in name:
        return name.replace(".", "_")
    if name.startswith("layer") and name[5:].isdigit():
        return "stage" + name[5:]
    return name


def round_variables_to_bf16(module: nn.Module) -> None:
    """Give ``module`` the numerics of the JAX CLI's ``--bf16`` eval, in place.

    JAX casts the variables (parameters and BN statistics) to bf16, and
    Flax's layers promote them back to the fp32 input, except eval-mode
    BatchNorm: its multiplier ``rsqrt(var + eps) * scale`` is made of
    variables alone, so it is bf16 arithmetic.  Jitted, XLA rounds the sum
    and the ``rsqrt`` to bf16 and keeps the product with the scale in fp32
    (it drops a rounding whose result is only widened again).  Here every
    variable is rounded to bf16, and each BatchNorm's weight becomes that
    multiplier, with a variance and an eps that sum to exactly 1
    (:func:`unit_bn_denominator`) so that it is applied as it is.
    Each step runs in fp32 and is rounded explicitly, as XLA does it: torch's
    own bf16 ``rsqrt`` on the CPU can miss the nearest bf16 by one step.
    """
    with torch.no_grad():
        for t in module.state_dict().values():
            if t.is_floating_point():
                t.copy_(t.to(torch.bfloat16))
        for m in module.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.weight.copy_(bf16_bn_multiplier(m) * m.weight)
                unit_bn_denominator(m)


# a BatchNorm eps whose complement to 1 is exact in fp32 (torch refuses eps 0)
_UNIT_EPS = 2.0 ** -12


def unit_bn_denominator(bn: nn.BatchNorm2d) -> None:
    """Make ``sqrt(var + eps)`` of eval-mode ``bn`` exactly 1: variance
    ``1 - 2^-12`` and eps ``2^-12``, whose fp32 sum is 1."""
    bn.running_var.fill_(1.0 - _UNIT_EPS)
    bn.eps = _UNIT_EPS


def _bf16(t) -> torch.Tensor:
    """``t`` rounded to bf16, kept in fp32."""
    return torch.as_tensor(t, dtype=torch.float32).to(torch.bfloat16).float()


def bf16_bn_multiplier(bn: nn.BatchNorm2d) -> torch.Tensor:
    """``rsqrt(var + eps)`` of eval-mode BatchNorm with bf16 statistics, as
    jitted Flax computes it (the sum and the ``rsqrt`` rounded to bf16, in
    fp32 arithmetic); its product with the scale stays fp32."""
    return _bf16(torch.rsqrt(_bf16(_bf16(bn.running_var) + _bf16(bn.eps))))


def aux_path(name: str) -> Optional[str]:
    """``<weights root>/<name>.npz`` if it exists, else None."""
    p = os.path.join(weights_root(), f"{name}.npz")
    return p if os.path.exists(p) else None


def load_aux(net: nn.Module, name: str, seed: int, device,
             fallback: Optional[str] = None) -> nn.Module:
    """``net`` filled from ``<name>.npz``, or warned about, recorded (as
    ``fallback``, by default ``name``) and given a seeded init, drawn on the
    device ``net`` was built on; frozen, in eval mode, on ``device``."""
    path = aux_path(name)
    if path is not None:
        load_flat_variables(net, load_npz(path))
    else:
        record_fallback(fallback or name)
        warnings.warn(f"{name}.npz not found under {weights_root()}; random-init "
                      f"{type(net).__name__} used.")
        built_on = next(net.parameters()).device
        init_weights(net, torch.Generator(device=built_on).manual_seed(seed))
    return net.eval().requires_grad_(False).to(device)


def nhwc(net, x, *args):
    """``net`` (NCHW in and out) on NHWC ``x``."""
    return net(x.permute(0, 3, 1, 2), *args).permute(0, 2, 3, 1)


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """Flat variables dict as ``save_npz_variables`` writes it."""
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


# parameters of no layer type, initialised as Flax does: position
# embeddings and Swin's relative position bias from a normal of std 0.02,
# CLIP's position embedding of std 0.01, class and distillation tokens zero
_NORMAL_002 = ("pos_embed", "pos_embed1", "pos_embed2", "pos_embed3",
               "relative_position_bias_table")
_NORMAL_001 = ("position_embedding",)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init at Flax's default scales: lecun-normal (truncated
    at two standard deviations) kernels and embedding tables (fan-in the
    width), zero biases, identity BatchNorm, LayerNorm and GroupNorm, the
    free parameters of ``_NORMAL_002`` drawn from a normal of std 0.02 and
    of ``_NORMAL_001`` of std 0.01, LayerScale's at its ``init_values``
    (others zero)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear,
                              nn.Embedding)):
                # a transposed conv's (in, out, kh, kw): out·kh·kw, as Flax's
                # transpose_kernel counts it; an embedding's (vocab, width): width
                fan_in = m.weight[0].numel()
                # the truncated normal's std is 0.8796 of the untruncated one
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm, nn.GroupNorm)):
                m.reset_parameters()
            else:
                for pname, p in m.named_parameters(recurse=False):
                    if pname in _NORMAL_002 + _NORMAL_001:
                        std = 0.02 if pname in _NORMAL_002 else 0.01
                        nn.init.normal_(p, 0.0, std, generator=generator)
                    elif pname in ("gamma_1", "gamma_2"):  # CaiT's LayerScale
                        p.fill_(m.init_values)
                    else:
                        p.zero_()


# the reference's short names (ghost networks, DHF)
_ALIASES = {"inc_v3": "inception_v3", "inc_res": "inception_resnet_v2",
            "inc_res_v2": "inception_resnet_v2"}


def build_module(name: str, input_size: Optional[int] = None, **kwargs) -> WrappedModel:
    """The registered model ``name`` with its preprocessing, on the CPU at
    PyTorch's default init (:func:`make_model` then loads or seeds it)."""
    if name not in _MODEL_REGISTRY:
        raise ValueError(f"Unknown model {name!r}; available: {list_models()}")
    builder, size, mean, std, sized = _MODEL_REGISTRY[name]
    if input_size is not None:
        size = input_size
    backbone = builder(img_size=size, **kwargs) if sized else builder(**kwargs)
    return WrappedModel(backbone, size, mean, std)


def make_model(
    name: str,
    pretrained: bool = True,
    seed: int = 42,
    input_size: Optional[int] = None,
    device="cuda",
    **kwargs,
) -> Surrogate:
    """Build a wrapped surrogate by registry name, in eval mode with every
    parameter frozen (the attack differentiates the input only).
    ``input_size`` overrides the registry's input size (the models whose
    parameter shapes depend on it are built for it).

    The weights are built on the CPU and then moved, so one ``seed`` gives
    the same model on every device.
    """
    dev = resolve_device(device)
    name = _ALIASES.get(name, name)
    module = build_module(name, input_size, **kwargs)
    size, backbone = module.preprocess.size, module.backbone
    wpath = aux_path(name) if pretrained else None
    if wpath is not None:
        load_flat_variables(module, load_npz(wpath))
    else:
        if pretrained:
            record_fallback(name)
        init_weights(module, torch.Generator().manual_seed(seed))
    module.eval().requires_grad_(False)
    module.to(device=dev, memory_format=torch.channels_last)
    return Surrogate(name=name, module=module, input_size=size,
                     num_classes=getattr(backbone, "num_classes", 1000))


class EnsembleModule(nn.Module):
    """Members in sequence on one input (JAX's ``_EnsembleModule``, the
    reference's ``EnsembleModel``): the mean of their logits (``mode``
    ``"mean"``) or their logits stacked on a leading axis (``"ind"``).  Each
    member is a :class:`WrappedModel` with its own preprocessing."""

    def __init__(self, members: Sequence[nn.Module], mode: str = "mean"):
        super().__init__()
        if mode not in ("mean", "ind"):
            raise NotImplementedError(mode)
        self.members = nn.ModuleList(members)
        self.mode = mode

    def forward(self, x, **backbone_kwargs):
        stacked = torch.stack([m(x, **backbone_kwargs) for m in self.members])
        return stacked.mean(0) if self.mode == "mean" else stacked


def make_ensemble(names: Sequence[str], mode: str = "mean", **kwargs) -> Surrogate:
    """An ensemble surrogate of the registered ``names`` (JAX's
    ``make_ensemble``), each built by :func:`make_model` with ``kwargs``.
    Its ``input_size`` is its largest member's; its ``members`` are one
    surrogate a member, on the same modules."""
    subs = [make_model(n, **kwargs) for n in names]
    module = EnsembleModule([s.module for s in subs], mode=mode)
    return Surrogate(name="+".join(names), module=module,
                     input_size=max(s.input_size for s in subs),
                     num_classes=subs[0].num_classes, members=tuple(subs))


def resolve_model(spec, **kwargs) -> Surrogate:
    """A surrogate as it is, a registry name, or a list of names (an
    ensemble)."""
    if isinstance(spec, Surrogate):
        return spec
    if isinstance(spec, str):
        return make_model(spec, **kwargs)
    if isinstance(spec, (list, tuple)):
        return make_ensemble(spec, **kwargs)
    raise TypeError(f"Cannot resolve model spec {spec!r}")


# model definition modules register themselves on import
from . import toy  # noqa: E402,F401
from . import resnet  # noqa: E402,F401
from . import vgg  # noqa: E402,F401
from . import mobilenet  # noqa: E402,F401
from . import inception  # noqa: E402,F401
from . import vit  # noqa: E402,F401
from . import pit  # noqa: E402,F401
from . import swin  # noqa: E402,F401
from . import visformer  # noqa: E402,F401
from . import cait  # noqa: E402,F401
from . import inception_resnet  # noqa: E402,F401
from . import densenet  # noqa: E402,F401
