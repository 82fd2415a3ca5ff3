"""ResNet / ResNeXt family (counterpart of ``models/resnet.py``).

Module names are torchvision's (``layer1.0.downsample.0``), so a PyTorch
``state_dict`` loads natively and the JAX package's weights load through
:mod:`transferattack_torch.utils.bridge`.  BatchNorm runs in eval mode;
:func:`fold_bn` folds it into the convs, in place and exactly.  The
JAX ResNet's taps (``conv1``, ``stage{i}``, ``layer{i}_{j}``) are these
modules' outputs, read or replaced by forward hooks
(:meth:`~transferattack_torch.models.Surrogate.features`).

Gradient surgery (the model-related attacks) is a :class:`SurgeryConfig`
given to the model's constructor, as in JAX, and each backward rewrite is a
``torch.autograd.Function``, the reference's own mechanism:

* ``gamma`` — SGM: the inner ReLUs' backward scaled by γ (the first block of
  each stage excepted), each block's output gradient divided by its std;
* ``softplus_beta``, ``residual_scale`` — IAA: Softplus(β) for every ReLU,
  the residual branch scaled per stage;
* ``linbp_start`` — LinBP: from this block on, the main branch's backward
  is linear, rescaled per image to the norm of the masked one;
* ``bpa_start``, ``bpa_maxpool`` — BPA: SiLU-derivative ReLU backward from
  this block on, and a stem max pool whose backward is a softmax;
* ``ghost_range``, ``skip_drop`` — ghost networks: the skip scaled per
  channel, or the residual dropped per image, by draws the attack makes and
  passes to ``forward`` (``ghost``);
* LLTA's per-image DecayReLU factors are ``forward``'s ``gammas``.

With the default ``SurgeryConfig()`` and neither ``gammas`` nor ``ghost``,
every choice below falls to the plain op: ``F.relu``, ``nn.MaxPool2d`` and a
residual add, with no ``autograd.Function``.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from . import register_model

# ghost(kind, block, shape) -> tensor: the draws of one forward of a ghost
# network.  ``kind`` "ghost_range": per-channel skip scales, shape (C,);
# "skip_drop": per-image 0/1 keep draws, shape (B,).
GhostDraws = Callable[[str, str, tuple], torch.Tensor]


class SurgeryConfig:
    """Immutable bag of gradient-surgery settings shared by the blocks
    (JAX's ``SurgeryConfig``, field for field)."""

    def __init__(
        self,
        gamma: float = 1.0,
        softplus_beta: Optional[float] = None,
        residual_scale=1.0,
        skip_drop: float = 0.0,
        linbp_start: int = 10**9,
        ghost_range: float = 0.0,
        bpa_start: int = 10**9,
        bpa_maxpool: bool = False,
        bpa_temperature: float = 10.0,
    ):
        self.gamma = gamma
        self.softplus_beta = softplus_beta
        # scalar, or a 4-tuple of per-stage scales (IAA)
        self.residual_scale = residual_scale
        self.skip_drop = skip_drop
        self.linbp_start = linbp_start
        # ghost networks: identity scaled per channel by U(1 ± range)
        self.ghost_range = ghost_range
        self.bpa_start = bpa_start
        self.bpa_maxpool = bpa_maxpool
        self.bpa_temperature = bpa_temperature

    def stage_scale(self, stage_index: int) -> float:
        if isinstance(self.residual_scale, (tuple, list)):
            return self.residual_scale[stage_index]
        return self.residual_scale

    def key(self):
        rs = self.residual_scale
        return (
            self.gamma,
            self.softplus_beta,
            tuple(rs) if isinstance(rs, (tuple, list)) else rs,
            self.skip_drop,
            self.linbp_start,
            self.ghost_range,
            self.bpa_start,
            self.bpa_maxpool,
            self.bpa_temperature,
        )

    def __eq__(self, other):
        return isinstance(other, SurgeryConfig) and self.key() == other.key()

    def __hash__(self):
        return hash(self.key())


DEFAULT_SURGERY = SurgeryConfig()


class _ScaledGradReLU(torch.autograd.Function):
    """ReLU whose backward mask is scaled by γ (SGM)."""

    @staticmethod
    def forward(ctx, x, gamma):
        ctx.save_for_backward(x)
        ctx.gamma = gamma
        return F.relu(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (x > 0).to(g.dtype) * ctx.gamma, None


class _LinBPReLU(torch.autograd.Function):
    """ReLU forward, identity backward (LinBP's ``x + relu(-x).detach()``)."""

    @staticmethod
    def forward(ctx, x):
        return F.relu(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _StdNormReLU(torch.autograd.Function):
    """ReLU whose backward divides the masked gradient by its std: the
    reference's SGM block hook, which PyTorch's legacy module hooks put on
    the block's output ReLU.  ``torch.std`` is unbiased over every element,
    batch included, so the images of a batch share the divisor; it is
    computed in fp32 whatever the gradient's dtype."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return F.relu(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        v = g * (x > 0).to(g.dtype)
        v32 = v.float()
        var = ((v32 - v32.mean()) ** 2).sum() / max(v.numel() - 1, 1)
        return (v32 / torch.sqrt(var + 1e-30)).to(g.dtype)


class _ReLUSiLU(torch.autograd.Function):
    """ReLU forward, SiLU-derivative backward (BPA)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return F.relu(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        s = torch.sigmoid(x)
        return g * (x * s * (1 - s) + s)


class _SoftmaxMaxPool(torch.autograd.Function):
    """3×3/2 max pool (padding 1) whose backward spreads each output's
    gradient over its window by a softmax at ``temperature`` (BPA).  The
    backward's windows are zero-padded (``F.unfold``, as JAX's patch
    extraction), while the forward pads with −inf: an out-of-image slot has
    weight exp(0) in the softmax.  NCHW; the softmax runs in fp32."""

    @staticmethod
    def forward(ctx, x, temperature):
        ctx.save_for_backward(x)
        ctx.temperature = temperature
        return F.max_pool2d(x, 3, 2, 1)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        B, C, H, W = x.shape
        cols = F.unfold(x.float(), 3, padding=1, stride=2).reshape(B, C, 9, -1)
        w = torch.softmax(ctx.temperature * cols, dim=2)
        gi = (w * g.float().reshape(B, C, 1, -1)).reshape(B, C * 9, -1)
        out = F.fold(gi, (H, W), 3, padding=1, stride=2)
        return out.to(x.dtype).contiguous(memory_format=torch.channels_last), None


def scaled_grad_relu(x, gamma: float):
    return _ScaledGradReLU.apply(x, gamma)


def linbp_relu(x):
    return _LinBPReLU.apply(x)


def std_norm_relu(x):
    return _StdNormReLU.apply(x)


def relu_silu(x):
    return _ReLUSiLU.apply(x)


def softmax_maxpool(x, temperature: float):
    return _SoftmaxMaxPool.apply(x, temperature)


def softplus(x, beta: float):
    """``jax.nn.softplus(β·x) / β``: ``logaddexp(β·x, 0)``, whose gradient is
    ``sigmoid(β·x)`` everywhere (``F.softplus`` switches to the identity
    above its threshold)."""
    z = beta * x
    return torch.logaddexp(z, torch.zeros((), dtype=z.dtype, device=z.device)) / beta


def decay_relu(x, gamma):
    """LLTA's DecayReLU: ReLU forward, backward scaled per image by ``gamma``
    (B,), the straight-through ``r·γ + sg(r·(1 − γ))``."""
    r = F.relu(x)
    g = gamma.to(r.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
    return r * g + (r * (1.0 - g)).detach()


def _inner_act(x, s: SurgeryConfig, block_index: int, stage_first: bool,
               mode: str = "surgery"):
    """Activation on the residual main branch (the reference's inner ReLUs)."""
    if mode == "masked":
        return F.relu(x)
    if mode == "linear":
        return linbp_relu(x)
    if block_index >= s.bpa_start:
        return relu_silu(x)
    if s.softplus_beta is not None:
        return softplus(x, s.softplus_beta)
    if s.gamma != 1.0 and not stage_first:
        # SGM hooks every 'relu' module but those named '*0.relu': the first
        # block of each stage keeps the plain backward
        return scaled_grad_relu(x, s.gamma)
    return F.relu(x)


def _final_act(x, s: SurgeryConfig, block_index: int):
    """Activation after the residual add (the block's output ReLU)."""
    if block_index >= s.linbp_start:
        return F.relu(x)  # LinBP keeps the post-add ReLU masked
    if block_index >= s.bpa_start:
        return relu_silu(x)
    if s.softplus_beta is not None:
        return softplus(x, s.softplus_beta)
    if s.gamma != 1.0:
        return std_norm_relu(x)
    return F.relu(x)


class _LinBPMain(torch.autograd.Function):
    """A LinBP block's main branch: the masked forward, and in the backward
    the linear (identity-ReLU) input gradient rescaled per image to the L2
    norm of the masked one.  The block's parameters are frozen, so only the
    input gradient is formed: the backward runs the branch twice more, once
    a mode, under ``enable_grad``."""

    @staticmethod
    def forward(ctx, x, block):
        ctx.save_for_backward(x)
        ctx.block = block
        return block._main(x, "masked")

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        grads = []
        with torch.enable_grad():
            for mode in ("masked", "linear"):
                xi = x.detach().requires_grad_(True)
                (gi,) = torch.autograd.grad(ctx.block._main(xi, mode), xi, g)
                grads.append(gi)
        gm, gl = grads
        nm = gm.float().flatten(1).norm(dim=1)
        nl = gl.float().flatten(1).norm(dim=1)
        scale = (nm / (nl + 1e-20)).reshape(-1, 1, 1, 1)
        return (gl.float() * scale).to(gl.dtype), None


def conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1, groups: int = 1):
    # the JAX ResNet pads kernel//2 on both sides, which is PyTorch's padding
    return nn.Conv2d(in_ch, out_ch, kernel, stride, kernel // 2, groups=groups,
                     bias=False)


def bn(ch: int):
    return nn.BatchNorm2d(ch, eps=1e-5)


class _Block(nn.Module):
    """What the two block types share: their place in the net (set by
    :class:`ResNet`), the surgery path and the residual merge."""

    surgery = DEFAULT_SURGERY
    block_index = 0
    stage_index = 0
    stage_first = False
    decay_index: Optional[int] = None  # its column of LLTA's gammas
    key = ""  # JAX's name, ``layer{i}_{j}``

    def forward(self, x, gammas=None, ghost: Optional[GhostDraws] = None):
        s = self.surgery
        gamma = (gammas[:, self.decay_index]
                 if gammas is not None and self.decay_index is not None else None)
        if self.block_index >= s.linbp_start:
            out = _LinBPMain.apply(x, self)
        else:
            out = self._main(x, gamma=gamma)
        identity = x if self.downsample is None else self.downsample(x)
        return _final_act(self._merge(out, identity, ghost), s, self.block_index)

    def _act(self, x, mode: str, gamma):
        if gamma is not None:
            return decay_relu(x, gamma)
        return _inner_act(x, self.surgery, self.block_index, self.stage_first, mode)

    def _merge(self, out, identity, ghost):
        """Residual add, with ghost skip scaling or dropping (none without
        ``ghost`` draws: the ghost family's centre) and IAA's residual
        scale."""
        s = self.surgery
        if ghost is not None and s.skip_drop > 0.0:
            keep = 1.0 - s.skip_drop
            mask = ghost("skip_drop", self.key, (out.shape[0],)).to(out.dtype)
            out = out * mask.reshape(-1, 1, 1, 1) / keep
        if ghost is not None and s.ghost_range > 0.0:
            scale = ghost("ghost_range", self.key, (out.shape[1],)).to(out.dtype)
            identity = identity * scale.reshape(1, -1, 1, 1)
        scale = s.stage_scale(self.stage_index)
        return (out * scale if scale != 1.0 else out) + identity


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 3, stride)
        self.bn1 = bn(planes)
        self.conv2 = conv(planes, planes, 3)
        self.bn2 = bn(planes)
        self.downsample = (nn.Sequential(conv(inplanes, planes, 1, stride), bn(planes))
                           if downsample else None)

    def _main(self, x, mode: str = "surgery", gamma=None):
        out = self._act(self.bn1(self.conv1(x)), mode, gamma)
        return self.bn2(self.conv2(out))


class Bottleneck(_Block):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1, base_width: int = 64):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = conv(inplanes, width, 1)
        self.bn1 = bn(width)
        self.conv2 = conv(width, width, 3, stride, groups=groups)
        self.bn2 = bn(width)
        self.conv3 = conv(width, planes * 4, 1)
        self.bn3 = bn(planes * 4)
        self.downsample = (
            nn.Sequential(conv(inplanes, planes * 4, 1, stride), bn(planes * 4))
            if downsample else None)

    def _main(self, x, mode: str = "surgery", gamma=None):
        out = self._act(self.bn1(self.conv1(x)), mode, gamma)
        out = self._act(self.bn2(self.conv2(out)), mode, gamma)
        return self.bn3(self.conv3(out))


class Stage(nn.Sequential):
    """A stage's blocks, handing each the surgery draws of a forward."""

    def forward(self, x, gammas=None, ghost: Optional[GhostDraws] = None):
        for block in self:
            x = block(x, gammas=gammas, ghost=ghost)
        return x


class ResNet(nn.Module):
    """torchvision-layout ResNet on NCHW input."""

    def __init__(self, stage_sizes: Sequence[int], block_cls, num_classes: int = 1000,
                 groups: int = 1, base_width: int = 64,
                 surgery: SurgeryConfig = DEFAULT_SURGERY):
        super().__init__()
        self.num_classes = num_classes
        self.surgery = surgery
        # the JAX ResNet computes this stem as a 4×4 conv on 2×2
        # space-to-depth blocks when the size is even; both are this conv
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = bn(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        exp = block_cls.expansion
        extra = ({"groups": groups, "base_width": base_width}
                 if block_cls is Bottleneck else {})
        inplanes, block_index, decay_index = 64, 0, 0
        for i, n_blocks in enumerate(stage_sizes):
            planes = 64 * 2 ** i
            blocks = []
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                down = j == 0 and (stride != 1 or i == 0 and exp != 1)
                block = block_cls(inplanes, planes, stride, down, **extra)
                block.surgery, block.block_index, block.stage_index = surgery, block_index, i
                block.stage_first, block.key = j == 0, f"layer{i + 1}_{j}"
                if j > 0:  # LLTA decays every block but the first of a stage
                    block.decay_index = decay_index
                    decay_index += 1
                blocks.append(block)
                inplanes = planes * exp
                block_index += 1
            setattr(self, f"layer{i + 1}", Stage(*blocks))
        self.stage_sizes = tuple(stage_sizes)
        self.fc = nn.Linear(inplanes, num_classes)

    def forward(self, x, gammas=None, ghost: Optional[GhostDraws] = None):
        """``gammas``: optional (B, G) per-image DecayReLU backward scales
        for LLTA, one column a non-first block, stage-major (G = Σ(stage
        size − 1)).  ``ghost``: the draws of a ghost forward (see
        ``GhostDraws``)."""
        s = self.surgery
        # the stem ReLU ('1.relu') does get SGM's γ hook
        x = _inner_act(self.bn1(self.conv1(x)), s, -1, False)
        x = softmax_maxpool(x, s.bpa_temperature) if s.bpa_maxpool else self.maxpool(x)
        for i in range(len(self.stage_sizes)):
            x = getattr(self, f"layer{i + 1}")(x, gammas=gammas, ghost=ghost)
        return self.fc(x.mean(dim=(2, 3)))


@torch.no_grad()
def fold_bn(module: nn.Module) -> nn.Module:
    """Fold every conv→BatchNorm pair's scale into the conv weight, in place
    (counterpart of ``fold_bn_variables``, an exact rewrite).

    ``weight *= γ/√(var+eps)`` per output channel, ``β ← β − mean·γ/√(var+eps)``,
    and the BN statistics neutralised (γ = 1, mean = 0, var = 1 − eps), so
    the stock ``nn.BatchNorm2d`` stays in place and adds only the bias.  Pairs
    are matched by torchvision's names: ``convN`` ↔ ``bnN`` and
    ``downsample.0`` ↔ ``downsample.1``.  Returns ``module``.
    """
    mods = dict(module.named_modules())
    for name, norm in mods.items():
        if not isinstance(norm, nn.BatchNorm2d):
            continue
        prefix, _, leaf = name.rpartition(".")
        if leaf.startswith("bn"):
            conv_name = prefix + ("." if prefix else "") + "conv" + leaf[2:]
        elif name.endswith("downsample.1"):
            conv_name = name[:-1] + "0"
        else:
            continue
        conv_mod = mods.get(conv_name)
        if not isinstance(conv_mod, nn.Conv2d):
            continue
        mult = norm.weight / torch.sqrt(norm.running_var + norm.eps)
        conv_mod.weight.mul_(mult.reshape(-1, 1, 1, 1))
        norm.bias.sub_(norm.running_mean * mult)
        norm.weight.fill_(1.0)
        norm.running_mean.zero_()
        norm.running_var.fill_(1.0 - norm.eps)
    return module


def _make(stage_sizes, block_cls, **defaults):
    def builder(**kwargs):
        return ResNet(stage_sizes, block_cls, **{**defaults, **kwargs})

    return builder


register_model("resnet18")(_make([2, 2, 2, 2], BasicBlock))
register_model("resnet34")(_make([3, 4, 6, 3], BasicBlock))
register_model("resnet50")(_make([3, 4, 6, 3], Bottleneck))
register_model("resnet101")(_make([3, 4, 23, 3], Bottleneck))
register_model("resnet152")(_make([3, 8, 36, 3], Bottleneck))
register_model("resnext50_32x4d")(
    _make([3, 4, 6, 3], Bottleneck, groups=32, base_width=4)
)
register_model("resnext101_32x4d")(
    _make([3, 4, 23, 3], Bottleneck, groups=32, base_width=4)
)
