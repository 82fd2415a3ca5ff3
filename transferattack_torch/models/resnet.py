"""ResNet / ResNeXt family (counterpart of ``models/resnet.py``, plain path).

Module names are torchvision's (``layer1.0.downsample.0``), so a PyTorch
``state_dict`` loads natively and the JAX package's weights load through
:mod:`transferattack_torch.utils.bridge`.  BatchNorm runs in eval mode;
:func:`fold_bn` folds it into the convs, in place and exactly.  The
JAX ResNet's taps (``conv1``, ``stage{i}``, ``layer{i}_{j}``) are these
modules' outputs, read or replaced by forward hooks
(:meth:`~transferattack_torch.models.Surrogate.features`); its
gradient-surgery options (``SurgeryConfig``, LLTA gammas) belong to attacks
that are not ported yet.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from . import register_model


def conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1, groups: int = 1):
    # the JAX ResNet pads kernel//2 on both sides, which is PyTorch's padding
    return nn.Conv2d(in_ch, out_ch, kernel, stride, kernel // 2, groups=groups,
                     bias=False)


def bn(ch: int):
    return nn.BatchNorm2d(ch, eps=1e-5)


class BasicBlock(nn.Module):
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

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
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

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """torchvision-layout ResNet on NCHW input."""

    def __init__(self, stage_sizes: Sequence[int], block_cls, num_classes: int = 1000,
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        self.num_classes = num_classes
        # the JAX ResNet computes this stem as a 4×4 conv on 2×2
        # space-to-depth blocks when the size is even; both are this conv
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = bn(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        exp = block_cls.expansion
        extra = ({"groups": groups, "base_width": base_width}
                 if block_cls is Bottleneck else {})
        inplanes = 64
        for i, n_blocks in enumerate(stage_sizes):
            planes = 64 * 2 ** i
            blocks = []
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                down = j == 0 and (stride != 1 or i == 0 and exp != 1)
                blocks.append(block_cls(inplanes, planes, stride, down, **extra))
                inplanes = planes * exp
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.stage_sizes = tuple(stage_sizes)
        self.fc = nn.Linear(inplanes, num_classes)

    def forward(self, x):
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        for i in range(len(self.stage_sizes)):
            x = getattr(self, f"layer{i + 1}")(x)
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
