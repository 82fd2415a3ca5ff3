"""VGG-16/19 (counterpart of ``models/vgg.py``), torchvision's module names.

Like the JAX model, the classifier reads the flattened (NCHW order)
feature map of whatever size the input gives, with no adaptive pooling:
at 224² that is torchvision's 7 × 7 × 512, so a torchvision ``state_dict``
loads as it is.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from . import register_model

CFG16 = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"]
CFG19 = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]


class VGG(nn.Module):
    def __init__(self, cfg: Sequence, num_classes: int = 1000, img_size: int = 224):
        super().__init__()
        self.num_classes = num_classes
        layers, inp, side = [], 3, img_size
        for v in cfg:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
                side //= 2
            else:
                layers += [nn.Conv2d(inp, v, 3, padding=1), nn.ReLU()]
                inp = v
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(
            nn.Linear(inp * side * side, 4096), nn.ReLU(), nn.Dropout(),
            nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(),
            nn.Linear(4096, num_classes),
        )

    def forward(self, x):
        return self.classifier(torch.flatten(self.features(x), 1))


register_model("vgg16", sized=True)(lambda **kw: VGG(CFG16, **kw))
register_model("vgg19", sized=True)(lambda **kw: VGG(CFG19, **kw))
