"""Tiny surrogates for fast CPU tests (counterpart of ``models/toy.py``)."""
from __future__ import annotations

import torch
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


class ToySelfAttention(nn.Module):
    """Flax's ``nn.SelfAttention``: per-head query, key and value projections
    (the bridge maps their (dim, heads, head_dim) kernels), softmax(q kᵀ/√dh)
    v, and an output projection over the heads."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, d = x.shape
        q, k, v = (p(x).reshape(b, n, self.heads, -1).transpose(1, 2)
                   for p in (self.query, self.key, self.value))
        return self.out(F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, n, d))


class ToyViT(nn.Module):
    """The JAX package's minimal ViT (an 8×8 patch embedding and ``depth``
    blocks of Flax ``SelfAttention`` and a tanh-GELU MLP), JAX's names."""

    def __init__(self, num_classes: int = 10, dim: int = 32, depth: int = 2, heads: int = 2,
                 img_size: int = 32):
        super().__init__()
        self.num_classes, self.dim, self.depth, self.heads = num_classes, dim, depth, heads
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, dim, 8, 8)
        self.cls = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, (-(-img_size // 8)) ** 2 + 1, dim))
        for i in range(depth):
            setattr(self, f"norm1_{i}", nn.LayerNorm(dim, eps=1e-6))
            setattr(self, f"attn_{i}", ToySelfAttention(dim, heads))
            setattr(self, f"norm2_{i}", nn.LayerNorm(dim, eps=1e-6))
            setattr(self, f"mlp1_{i}", nn.Linear(dim, dim * 2))
            setattr(self, f"mlp2_{i}", nn.Linear(dim * 2, dim))
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.head = nn.Linear(dim, num_classes)

    def forward(self, x, features_only: bool = False):
        x = self.patch_embed.proj(same_pad(x, 8, 8)).flatten(2).transpose(1, 2)
        x = torch.cat([self.cls.expand(x.shape[0], -1, -1), x], dim=1) + self.pos_embed
        for i in range(self.depth):
            x = x + getattr(self, f"attn_{i}")(getattr(self, f"norm1_{i}")(x))
            h = getattr(self, f"mlp1_{i}")(getattr(self, f"norm2_{i}")(x))
            x = x + getattr(self, f"mlp2_{i}")(F.gelu(h, approximate="tanh"))
        feats = self.norm(x)[:, 0]
        return feats if features_only else self.head(feats)


register_model("toy_cnn", input_size=32, mean=(0.5,) * 3, std=(0.5,) * 3)(ToyCNN)
register_model("toy_cnn2", input_size=32, mean=(0.5,) * 3, std=(0.5,) * 3)(
    lambda **kw: ToyCNN(width=24, **kw)
)
register_model("toy_vit", input_size=32, mean=(0.5,) * 3, std=(0.5,) * 3, sized=True)(ToyViT)
