"""PiT (counterpart of ``models/pit.py``): ViT blocks in stages of growing
width, pooled by a depthwise stride-2 convolution between stages.  Module
names are the ones the JAX converter maps (``patch_embed.proj``,
``transformers.i.blocks.j``, ``transformers.i.pool.{conv,fc}``);
``pos_embed`` is (1, C, H, W), sized by ``img_size``.  Its ViT blocks take
a :class:`~transferattack_torch.models.vit.ViTSurgery` (the module's own
``surgery``, or ``forward``'s), each with its running block index."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import register_model
from .vit import DEFAULT_VIT_SURGERY, Block, ViTSurgery


class ConvHeadPooling(nn.Module):
    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, out_dim, 3, 2, 1, groups=dim)
        self.fc = nn.Linear(dim, out_dim)

    def forward(self, tokens, cls, hw):
        b, _, c = tokens.shape
        x = self.conv(tokens.transpose(1, 2).reshape(b, c, *hw))
        return x.flatten(2).transpose(1, 2), self.fc(cls), tuple(x.shape[2:])


class Stage(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, mlp_ratio: float, next_dim,
                 first_block: int = 0):
        super().__init__()
        self.blocks = nn.ModuleList([Block(dim, heads, mlp_ratio, first_block + j)
                                     for j in range(depth)])
        if next_dim is not None:
            self.pool = ConvHeadPooling(dim, next_dim)


class PiT(nn.Module):
    def __init__(self, patch_size: int = 14, stride: int = 7, base_dims=(64, 64, 64),
                 depth=(3, 6, 4), heads=(4, 8, 16), mlp_ratio: float = 4.0,
                 num_classes: int = 1000, img_size: int = 224,
                 surgery: ViTSurgery = DEFAULT_VIT_SURGERY):
        super().__init__()
        self.num_classes = num_classes
        self.surgery = surgery
        dims = [bd * h for bd, h in zip(base_dims, heads)]
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, dims[0], patch_size, stride)  # unpadded
        side = (img_size - patch_size) // stride + 1
        self.pos_embed = nn.Parameter(torch.zeros(1, dims[0], side, side))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dims[0]))
        self.transformers = nn.ModuleList([
            Stage(d, dp, h, mlp_ratio, dims[i + 1] if i + 1 < len(dims) else None,
                  sum(depth[:i]))
            for i, (d, dp, h) in enumerate(zip(dims, depth, heads))])
        self.norm = nn.LayerNorm(dims[-1], eps=1e-6)
        self.head = nn.Linear(dims[-1], num_classes)

    def forward(self, x, surgery: Optional[ViTSurgery] = None, generator=None):
        s = self.surgery if surgery is None else surgery
        x = self.patch_embed.proj(x) + self.pos_embed
        b, hw = x.shape[0], tuple(x.shape[2:])
        tokens = x.flatten(2).transpose(1, 2)
        cls = self.cls_token.expand(b, -1, -1)
        for stage in self.transformers:
            seq = torch.cat([cls, tokens], dim=1)
            for blk in stage.blocks:
                seq = blk(seq, s, generator)
            cls, tokens = seq[:, :1], seq[:, 1:]
            if hasattr(stage, "pool"):
                tokens, cls, hw = stage.pool(tokens, cls, hw)
        return self.head(self.norm(cls)[:, 0])


register_model("pit_b_224", sized=True)(PiT)
register_model("pit_s_224", sized=True)(
    lambda **kw: PiT(base_dims=(48, 48, 48), depth=(2, 6, 4), heads=(3, 6, 12), **kw)
)
