"""Inception-ResNet-v2 (counterpart of ``models/inception_resnet.py``): timm's
module names, 299² input, Inception mean and std.

Ghost networks: with ``ghost_range`` > 0 every residual join scales its skip
per channel by U(1 ± ghost_range), fresh each forward.  The attack makes the
draws and passes them to ``forward`` as ``ghost("ghost_range", name, (C,))``,
``name`` the block's JAX name (``repeat_3``, ``repeat_1_0``, ``block8``).
DHF's taps are the blocks' outputs, by JAX's names (``repeat_{i}``,
``repeat_1_{i}``, ``repeat_2_{i}``, ``block8``, ``conv2d_7b``), read or
replaced by forward hooks
(:meth:`~transferattack_torch.models.Surrogate.features`).
"""
from __future__ import annotations

import re
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import INCEPTION_MEAN, INCEPTION_STD, register_model
from .inception import BasicConv2d, avgpool3
from .resnet import GhostDraws


class _AvgPool3(nn.Module):
    """3×3/1 average pool, pad 1, padding not counted (timm's Mixed_5b)."""

    def forward(self, x):
        return avgpool3(x, count_include_pad=False)


class _MaxPool3(nn.Module):
    def forward(self, x):
        return F.max_pool2d(x, 3, 2)


class Mixed5b(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = BasicConv2d(192, 96, 1)
        self.branch1 = nn.Sequential(BasicConv2d(192, 48, 1), BasicConv2d(48, 64, 5, padding=2))
        self.branch2 = nn.Sequential(BasicConv2d(192, 64, 1), BasicConv2d(64, 96, 3, padding=1),
                                     BasicConv2d(96, 96, 3, padding=1))
        self.branch3 = nn.Sequential(_AvgPool3(), BasicConv2d(192, 64, 1))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x), self.branch3(x)], 1)


class _Residual(nn.Module):
    """A residual block: ``out·scale + skip`` (the skip ghost-scaled per
    channel), then ReLU unless ``no_relu``."""

    def __init__(self, key: str, scale: float, ghost_range: float, no_relu: bool = False):
        super().__init__()
        self.key, self.scale, self.ghost_range, self.no_relu = key, scale, ghost_range, no_relu

    def join(self, out, x, ghost: Optional[GhostDraws]):
        if ghost is not None and self.ghost_range > 0.0:
            x = x * ghost("ghost_range", self.key, (x.shape[1],)).to(x.dtype).reshape(1, -1, 1, 1)
        out = out * self.scale + x
        return out if self.no_relu else F.relu(out)


class Block35(_Residual):
    def __init__(self, key: str, scale: float = 0.17, ghost_range: float = 0.0):
        super().__init__(key, scale, ghost_range)
        self.branch0 = BasicConv2d(320, 32, 1)
        self.branch1 = nn.Sequential(BasicConv2d(320, 32, 1), BasicConv2d(32, 32, 3, padding=1))
        self.branch2 = nn.Sequential(BasicConv2d(320, 32, 1), BasicConv2d(32, 48, 3, padding=1),
                                     BasicConv2d(48, 64, 3, padding=1))
        self.conv2d = nn.Conv2d(128, 320, 1)

    def forward(self, x, ghost: Optional[GhostDraws] = None):
        out = torch.cat([self.branch0(x), self.branch1(x), self.branch2(x)], 1)
        return self.join(self.conv2d(out), x, ghost)


class Mixed6a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = BasicConv2d(320, 384, 3, stride=2)
        self.branch1 = nn.Sequential(BasicConv2d(320, 256, 1),
                                     BasicConv2d(256, 256, 3, padding=1),
                                     BasicConv2d(256, 384, 3, stride=2))
        self.branch2 = _MaxPool3()

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x)], 1)


class Block17(_Residual):
    def __init__(self, key: str, scale: float = 0.10, ghost_range: float = 0.0):
        super().__init__(key, scale, ghost_range)
        self.branch0 = BasicConv2d(1088, 192, 1)
        self.branch1 = nn.Sequential(BasicConv2d(1088, 128, 1),
                                     BasicConv2d(128, 160, (1, 7), padding=(0, 3)),
                                     BasicConv2d(160, 192, (7, 1), padding=(3, 0)))
        self.conv2d = nn.Conv2d(384, 1088, 1)

    def forward(self, x, ghost: Optional[GhostDraws] = None):
        out = torch.cat([self.branch0(x), self.branch1(x)], 1)
        return self.join(self.conv2d(out), x, ghost)


class Mixed7a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = nn.Sequential(BasicConv2d(1088, 256, 1), BasicConv2d(256, 384, 3, stride=2))
        self.branch1 = nn.Sequential(BasicConv2d(1088, 256, 1), BasicConv2d(256, 288, 3, stride=2))
        self.branch2 = nn.Sequential(BasicConv2d(1088, 256, 1),
                                     BasicConv2d(256, 288, 3, padding=1),
                                     BasicConv2d(288, 320, 3, stride=2))
        self.branch3 = _MaxPool3()

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x), self.branch3(x)], 1)


class Block8(_Residual):
    def __init__(self, key: str, scale: float = 0.20, no_relu: bool = False,
                 ghost_range: float = 0.0):
        super().__init__(key, scale, ghost_range, no_relu)
        self.branch0 = BasicConv2d(2080, 192, 1)
        self.branch1 = nn.Sequential(BasicConv2d(2080, 192, 1),
                                     BasicConv2d(192, 224, (1, 3), padding=(0, 1)),
                                     BasicConv2d(224, 256, (3, 1), padding=(1, 0)))
        self.conv2d = nn.Conv2d(448, 2080, 1)

    def forward(self, x, ghost: Optional[GhostDraws] = None):
        out = torch.cat([self.branch0(x), self.branch1(x)], 1)
        return self.join(self.conv2d(out), x, ghost)


_REPEAT_TAP = re.compile(r"repeat_(?:(\d+)|([12])_(\d+))")


class InceptionResNetV2(nn.Module):
    def __init__(self, num_classes: int = 1000, ghost_range: float = 0.0):
        super().__init__()
        self.num_classes = num_classes
        g = float(ghost_range)
        self.conv2d_1a = BasicConv2d(3, 32, 3, stride=2)
        self.conv2d_2a = BasicConv2d(32, 32, 3)
        self.conv2d_2b = BasicConv2d(32, 64, 3, padding=1)
        self.conv2d_3b = BasicConv2d(64, 80, 1)
        self.conv2d_4a = BasicConv2d(80, 192, 3)
        self.mixed_5b = Mixed5b()
        self.repeat = nn.ModuleList([Block35(f"repeat_{i}", ghost_range=g) for i in range(10)])
        self.mixed_6a = Mixed6a()
        self.repeat_1 = nn.ModuleList([Block17(f"repeat_1_{i}", ghost_range=g)
                                       for i in range(20)])
        self.mixed_7a = Mixed7a()
        self.repeat_2 = nn.ModuleList([Block8(f"repeat_2_{i}", ghost_range=g) for i in range(9)])
        self.block8 = Block8("block8", scale=1.0, no_relu=True, ghost_range=g)
        self.conv2d_7b = BasicConv2d(2080, 1536, 1)
        self.classif = nn.Linear(1536, num_classes)

    def forward(self, x, features_only: bool = False, ghost: Optional[GhostDraws] = None):
        x = self.conv2d_2b(self.conv2d_2a(self.conv2d_1a(x)))
        x = self.conv2d_4a(self.conv2d_3b(F.max_pool2d(x, 3, 2)))
        x = self.mixed_5b(F.max_pool2d(x, 3, 2))
        for blk in self.repeat:
            x = blk(x, ghost)
        x = self.mixed_6a(x)
        for blk in self.repeat_1:
            x = blk(x, ghost)
        x = self.mixed_7a(x)
        for blk in self.repeat_2:
            x = blk(x, ghost)
        x = self.conv2d_7b(self.block8(x, ghost)).mean(dim=(2, 3))
        return x if features_only else self.classif(x)

    def tap_keys(self):
        return ([f"repeat_{i}" for i in range(10)] + [f"repeat_1_{i}" for i in range(20)]
                + [f"repeat_2_{i}" for i in range(9)] + ["block8", "conv2d_7b"])

    def tap_path(self, key: str) -> Optional[str]:
        """The module of JAX's block key ``repeat_3`` (``repeat.3``),
        ``repeat_1_0`` (``repeat_1.0``), ``repeat_2_8``."""
        m = _REPEAT_TAP.fullmatch(key)
        if m is None:
            return None
        return f"repeat.{m.group(1)}" if m.group(1) else f"repeat_{m.group(2)}.{m.group(3)}"


register_model("inception_resnet_v2", input_size=299, mean=INCEPTION_MEAN,
               std=INCEPTION_STD)(InceptionResNetV2)
