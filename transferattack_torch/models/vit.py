"""ViT and DeiT (counterpart of ``models/vit.py``), timm's module names.

Forward only: the JAX model's ``ViTSurgery`` hooks, ``extra_tokens`` and
``token_drop`` serve the ViT-specific attacks, which are not ported yet.
The JAX ``PatchEmbed`` (a reshape and a matmul) is the stride-P convolution
``patch_embed.proj`` here.  ``img_size`` sets the length of ``pos_embed``,
which the Flax model infers from its first input.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import register_model


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, d = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.num_heads, -1).permute(2, 0, 3, 1, 4)
        out = F.scaled_dot_product_attention(q, k, v)  # softmax(q kᵀ / √dh) v
        return self.proj(out.transpose(1, 2).reshape(b, n, d))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, patch)

    def forward(self, x):  # (B, 3, H, W) -> (B, tokens, dim)
        return self.proj(x).flatten(2).transpose(1, 2)


class VisionTransformer(nn.Module):
    def __init__(self, patch_size: int = 16, dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0, num_classes: int = 1000,
                 distilled: bool = False, img_size: int = 224):
        super().__init__()
        self.num_classes = num_classes
        self.distilled = distilled
        self.patch_embed = PatchEmbed(dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        prefix = 1
        if distilled:
            self.dist_token = nn.Parameter(torch.zeros(1, 1, dim))
            prefix = 2
        self.pos_embed = nn.Parameter(
            torch.zeros(1, (img_size // patch_size) ** 2 + prefix, dim))
        self.blocks = nn.Sequential(*[Block(dim, num_heads, mlp_ratio)
                                      for _ in range(depth)])
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.head = nn.Linear(dim, num_classes)
        if distilled:
            self.head_dist = nn.Linear(dim, num_classes)

    def forward(self, x):
        x = self.patch_embed(x)
        b = x.shape[0]
        prefix = [self.cls_token.expand(b, -1, -1)]
        if self.distilled:
            prefix.append(self.dist_token.expand(b, -1, -1))
        x = self.norm(self.blocks(torch.cat(prefix + [x], dim=1) + self.pos_embed))
        logits = self.head(x[:, 0])
        if self.distilled:
            # timm's DeiT in eval: the mean of the class and distillation heads
            logits = (logits + self.head_dist(x[:, 1])) / 2.0
        return logits


register_model("vit_base_patch16_224", sized=True)(VisionTransformer)
register_model("vit_small_patch16_224", sized=True)(
    lambda **kw: VisionTransformer(dim=384, depth=12, num_heads=6, **kw)
)
register_model("deit_base_distilled_patch16_224", sized=True)(
    lambda **kw: VisionTransformer(distilled=True, **kw)
)
