"""Inception-v3 (counterpart of ``models/inception.py``): torchvision's module
names, 299² input, Inception mean and std.

No auxiliary head: the JAX model has none, and torchvision's runs only in
training, so a torchvision ``state_dict`` loads once its ``AuxLogits.*``
keys are dropped.  The JAX model's ``tap_fns`` are forward hooks on these
modules (:meth:`~transferattack_torch.models.Surrogate.features`).

Ghost networks: with ``ghost_keep_prob`` < 1, every stem conv and Mixed
block's output is dropped out at that keep rate, at inference too (the
reference's functional dropout ignores eval mode).  The attack makes the
0/1 keep draws and passes them to ``forward`` as ``ghost("dropout", name,
shape)``, shape NHWC as JAX draws them.  A tap hook on such a module sees
the output before its dropout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import INCEPTION_MEAN, INCEPTION_STD, register_model


class BasicConv2d(nn.Module):
    def __init__(self, inp: int, out: int, kernel=3, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(inp, out, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(out, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def avgpool3(x, count_include_pad: bool = True):
    """3×3/1 average pool, pad 1, taken in the NCHW-contiguous layout: on a
    ``channels_last`` CUDA tensor ``avg_pool2d``'s backward with padding is
    wrong (torch 2.11+cu128 on an H100: the input gradient off by about its
    own max), while NCHW's is right and both forwards are."""
    return F.avg_pool2d(x.contiguous(), 3, 1, 1, count_include_pad=count_include_pad)


class InceptionA(nn.Module):
    def __init__(self, inp: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(inp, 64, 1)
        self.branch5x5_1 = BasicConv2d(inp, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(inp, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(inp, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(avgpool3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, inp: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(inp, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(inp, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, inp: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(inp, 192, 1)
        self.branch7x7_1 = BasicConv2d(inp, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(inp, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(inp, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(avgpool3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, inp: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(inp, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(inp, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, inp: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(inp, 320, 1)
        self.branch3x3_1 = BasicConv2d(inp, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(inp, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(inp, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(avgpool3(x))], 1)


_GHOST_SITES = ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "Conv2d_3b_1x1",
                "Conv2d_4a_3x3", "Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b",
                "Mixed_7c")


class InceptionV3(nn.Module):
    def __init__(self, num_classes: int = 1000, ghost_keep_prob: float = 1.0):
        super().__init__()
        self.num_classes = num_classes
        self.ghost_keep_prob = float(ghost_keep_prob)
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x, ghost=None):
        for name in _GHOST_SITES:
            x = getattr(self, name)(x)
            if ghost is not None and self.ghost_keep_prob < 1.0:
                B, C, H, W = x.shape
                mask = ghost("dropout", name, (B, H, W, C)).to(x.dtype).permute(0, 3, 1, 2)
                x = x * mask / self.ghost_keep_prob
            if name in ("Conv2d_2b_3x3", "Conv2d_4a_3x3"):
                x = F.max_pool2d(x, 3, 2)
        return self.fc(x.mean(dim=(2, 3)))


register_model("inception_v3", input_size=299, mean=INCEPTION_MEAN, std=INCEPTION_STD)(
    InceptionV3
)
