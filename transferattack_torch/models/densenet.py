"""DenseNet-121/201 (counterpart of ``models/densenet.py``), torchvision's
module names.

``features`` holds ``conv0``, ``norm0``, the stem pool, ``denseblock{i}``
(each of ``denselayer{j}``: ``norm1``, ``conv1``, ``norm2``, ``conv2``),
``transition{i}`` (``norm``, ``conv``, a 2×2/2 average pool) and ``norm5``,
so a torchvision ``state_dict`` loads as it is and the JAX package's weights
load through :mod:`transferattack_torch.utils.bridge`.  Each dense layer
returns its input with its new channels concatenated, as JAX's does (the
same tensor torchvision's block builds from its list of features).

The taps are JAX's sows: ``block{i}`` is the output of dense block ``i``
after its transition (the last block has none), read or replaced by forward
hooks (:meth:`~transferattack_torch.models.Surrogate.features`).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from . import register_model


class DenseLayer(nn.Module):
    def __init__(self, in_features: int, growth_rate: int, bn_size: int = 4):
        super().__init__()
        self.norm1 = nn.BatchNorm2d(in_features)
        self.conv1 = nn.Conv2d(in_features, bn_size * growth_rate, 1, bias=False)
        self.norm2 = nn.BatchNorm2d(bn_size * growth_rate)
        self.conv2 = nn.Conv2d(bn_size * growth_rate, growth_rate, 3, padding=1, bias=False)

    def forward(self, x):
        out = self.conv1(F.relu(self.norm1(x)))
        out = self.conv2(F.relu(self.norm2(out)))
        return torch.cat([x, out], 1)


class Transition(nn.Module):
    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.norm = nn.BatchNorm2d(in_features)
        self.conv = nn.Conv2d(in_features, out_features, 1, bias=False)

    def forward(self, x):
        # unpadded, so the channels_last backward of avg_pool2d is right on
        # the card (ROADMAP queue 3's fault is the padded pool's)
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2, 2)


class DenseNet(nn.Module):
    def __init__(self, block_config: Sequence[int] = (6, 12, 24, 16), growth_rate: int = 32,
                 num_init_features: int = 64, num_classes: int = 1000):
        super().__init__()
        self.num_classes = num_classes
        layers = OrderedDict([
            ("conv0", nn.Conv2d(3, num_init_features, 7, stride=2, padding=3, bias=False)),
            ("norm0", nn.BatchNorm2d(num_init_features)),
            ("relu0", nn.ReLU()),
            # JAX pads with -inf and pools VALID: max_pool2d's own padding
            ("pool0", nn.MaxPool2d(3, 2, padding=1)),
        ])
        feats = num_init_features
        self._taps = {}
        for i, n_layers in enumerate(block_config):
            block = nn.Sequential(OrderedDict(
                (f"denselayer{j + 1}", DenseLayer(feats + j * growth_rate, growth_rate))
                for j in range(n_layers)))
            layers[f"denseblock{i + 1}"] = block
            feats += n_layers * growth_rate
            last = f"features.denseblock{i + 1}"
            if i != len(block_config) - 1:
                layers[f"transition{i + 1}"] = Transition(feats, feats // 2)
                feats //= 2
                last = f"features.transition{i + 1}"
            self._taps[f"block{i + 1}"] = last
        layers["norm5"] = nn.BatchNorm2d(feats)
        self.features = nn.Sequential(layers)
        self.classifier = nn.Linear(feats, num_classes)

    def forward(self, x):
        x = F.relu(self.features(x))
        return self.classifier(x.mean(dim=(2, 3)))

    def tap_keys(self) -> List[str]:
        return list(self._taps)

    def tap_path(self, key: str) -> Optional[str]:
        """The module of JAX's sow ``block{i}``: the block's transition, or
        the last dense block."""
        return self._taps.get(key)


register_model("densenet121")(lambda **kw: DenseNet(block_config=(6, 12, 24, 16), **kw))
register_model("densenet201")(lambda **kw: DenseNet(block_config=(6, 12, 48, 32), **kw))
