"""MobileNet-v2 (counterpart of ``models/mobilenet.py``), torchvision's module
names: ``features.N`` holds the stem ``ConvBNReLU`` (``.0`` conv, ``.1``
BN), the inverted residuals (``features.N.conv.K``) and the last 1×1."""
from __future__ import annotations

from torch import nn

from . import register_model

# (expand_ratio, channels, num_blocks, stride), torchvision's mobilenet_v2
MBV2_CFG = [
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
]


class ConvBNReLU(nn.Sequential):
    def __init__(self, inp: int, out: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1):
        super().__init__(
            nn.Conv2d(inp, out, kernel, stride, (kernel - 1) // 2, groups=groups,
                      bias=False),
            nn.BatchNorm2d(out, eps=1e-5),
            nn.ReLU6(),
        )


class InvertedResidual(nn.Module):
    def __init__(self, inp: int, oup: int, stride: int, expand_ratio: int):
        super().__init__()
        hidden = inp * expand_ratio
        layers = [ConvBNReLU(inp, hidden, 1)] if expand_ratio != 1 else []
        layers += [ConvBNReLU(hidden, hidden, 3, stride, groups=hidden),
                   nn.Conv2d(hidden, oup, 1, bias=False),
                   nn.BatchNorm2d(oup, eps=1e-5)]
        self.conv = nn.Sequential(*layers)
        self.use_res = stride == 1 and inp == oup

    def forward(self, x):
        return x + self.conv(x) if self.use_res else self.conv(x)


class MobileNetV2(nn.Module):
    def __init__(self, num_classes: int = 1000):
        super().__init__()
        self.num_classes = num_classes
        feats, inp = [ConvBNReLU(3, 32, 3, 2)], 32
        for t, c, n, s in MBV2_CFG:
            for i in range(n):
                feats.append(InvertedResidual(inp, c, s if i == 0 else 1, t))
                inp = c
        feats.append(ConvBNReLU(inp, 1280, 1))
        self.features = nn.Sequential(*feats)
        self.classifier = nn.Sequential(nn.Dropout(0.2), nn.Linear(1280, num_classes))

    def forward(self, x):
        return self.classifier(self.features(x).mean(dim=(2, 3)))


register_model("mobilenet_v2")(MobileNetV2)
