"""Tiny surrogates for fast CPU tests (counterpart of ``models/toy.py``)."""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from . import register_model


def same_pad(x, kernel: int, stride: int):
    """Flax's ``'SAME'`` padding, done before a ``padding=0`` conv.

    Flax puts the odd pixel of the padding after the image: a 3×3 stride-2
    conv on 32² pads (0, 1), where PyTorch's ``padding=1`` would pad (1, 1).
    """
    pads = []
    for n in (x.shape[-1], x.shape[-2]):  # F.pad lists the last dim first
        out = -(-n // stride)
        total = max((out - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


class ToyCNN(nn.Module):
    def __init__(self, num_classes: int = 10, width: int = 16):
        super().__init__()
        self.num_classes = num_classes
        self.conv1 = nn.Conv2d(3, width, 3, stride=2)
        self.conv2 = nn.Conv2d(width, width * 2, 3, stride=2)
        self.fc = nn.Linear(width * 2, num_classes)
        # the stage outputs JAX sows, as modules a forward hook can tap
        self.stage1 = nn.Identity()
        self.stage2 = nn.Identity()

    def forward(self, x):
        x = self.stage1(F.relu(self.conv1(same_pad(x, 3, 2))))
        x = self.stage2(F.relu(self.conv2(same_pad(x, 3, 2))))
        return self.fc(x.mean(dim=(2, 3)))


register_model("toy_cnn", input_size=32, mean=(0.5,) * 3, std=(0.5,) * 3)(ToyCNN)
register_model("toy_cnn2", input_size=32, mean=(0.5,) * 3, std=(0.5,) * 3)(
    lambda **kw: ToyCNN(width=24, **kw)
)
