"""CaiT-S24 (counterpart of ``models/cait.py``), timm's module names, with the
JAX model's gradient-surgery hook points.

24 LayerScale blocks of talking-heads attention over the patch tokens, then
2 class-attention blocks in which a class token attends to [class,
patches].  ``surgery`` (a :class:`~transferattack_torch.models.vit.ViTSurgery`)
hooks the 24 main blocks as in the ViT, with ``scores_bwd`` between
``proj_l`` and the softmax; ``cls_surgery`` hooks the class-attention
blocks: ``scores_bwd``/``attn_bwd`` see the (B, h, 1, N) map, ``q_bwd`` the
class token's query projection, ``qkv_bwd`` the separate k and v
projections.  Either is the module's own or ``forward``'s.

Names: ``blocks.i.attn.{qkv,proj_l,proj_w,proj}``, ``blocks.i.gamma_{1,2}``,
``blocks_token_only.i.attn.{q,k,v,proj}``, ``cls_token``, ``pos_embed``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import register_model
from .vit import (DEFAULT_VIT_SURGERY, Mlp, PatchEmbed, Tap, ViTSurgery,
                  apply_bwd_hook)


class TalkingHeadAttn(nn.Module):
    """Attention with head mixing before and after the softmax."""

    def __init__(self, dim: int, num_heads: int, block_index: int = 0):
        super().__init__()
        self.num_heads = num_heads
        self.block_index = block_index
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj_l = nn.Linear(num_heads, num_heads)
        self.proj_w = nn.Linear(num_heads, num_heads)
        self.proj = nn.Linear(dim, dim)
        self.attn_map = Tap()

    def forward(self, x, s: ViTSurgery = DEFAULT_VIT_SURGERY):
        b, n, d = x.shape
        h = self.num_heads
        meta = {"block": self.block_index, "num_heads": h, "tokens": n}
        qkv = self.qkv(x)
        if s.qkv_post is not None:
            qkv = s.qkv_post(qkv, meta)
        qkv = apply_bwd_hook(qkv, s.qkv_bwd, meta)
        q, k, v = qkv.reshape(b, n, 3, h, d // h).permute(2, 0, 3, 1, 4)
        attn = (q * (d // h) ** -0.5) @ k.transpose(-2, -1)  # (B, h, N, N)
        attn = self.proj_l(attn.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        attn = apply_bwd_hook(attn, s.scores_bwd, meta).softmax(dim=-1)
        attn = self.proj_w(attn.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        if s.attn_post is not None:
            attn = s.attn_post(attn, meta)
        attn = attn.detach() if s.skip_attn_grad else apply_bwd_hook(attn, s.attn_bwd, meta)
        out = (self.attn_map(attn) @ v).transpose(1, 2).reshape(b, n, d)
        return self.proj(out)


class ClassAttn(nn.Module):
    """The class token attends to [class, patches]; separate q, k, v."""

    def __init__(self, dim: int, num_heads: int, block_index: int = 0):
        super().__init__()
        self.num_heads = num_heads
        self.block_index = block_index
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, s: ViTSurgery = DEFAULT_VIT_SURGERY):
        b, n, d = x.shape
        h = self.num_heads
        meta = {"block": self.block_index, "num_heads": h, "tokens": n}
        q = apply_bwd_hook(self.q(x[:, :1]), s.q_bwd, meta)
        k = apply_bwd_hook(self.k(x), s.qkv_bwd, meta)
        v = apply_bwd_hook(self.v(x), s.qkv_bwd, meta)
        q = q.reshape(b, 1, h, d // h).transpose(1, 2) * (d // h) ** -0.5
        k = k.reshape(b, n, h, d // h).transpose(1, 2)
        v = v.reshape(b, n, h, d // h).transpose(1, 2)
        attn = apply_bwd_hook(q @ k.transpose(-2, -1), s.scores_bwd, meta).softmax(dim=-1)
        attn = attn.detach() if s.skip_attn_grad else apply_bwd_hook(attn, s.attn_bwd, meta)
        return self.proj((attn @ v).transpose(1, 2).reshape(b, 1, d))


class LayerScaleBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 init_values: float = 1e-5, block_index: int = 0):
        super().__init__()
        self.block_index = block_index
        self.init_values = init_values
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = TalkingHeadAttn(dim, num_heads, block_index)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), block_index)
        self.gamma_1 = nn.Parameter(torch.full((dim,), init_values))
        self.gamma_2 = nn.Parameter(torch.full((dim,), init_values))

    def forward(self, x, s: ViTSurgery = DEFAULT_VIT_SURGERY):
        x = x + self.gamma_1 * self.attn(self.norm1(x), s)
        h = apply_bwd_hook(self.norm2(x), s.mlp_in_bwd, {"block": self.block_index})
        return x + self.gamma_2 * self.mlp(h, s)


class LayerScaleBlockClassAttn(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 init_values: float = 1e-5, block_index: int = 0):
        super().__init__()
        self.block_index = block_index
        self.init_values = init_values
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = ClassAttn(dim, num_heads, block_index)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), block_index)
        self.gamma_1 = nn.Parameter(torch.full((dim,), init_values))
        self.gamma_2 = nn.Parameter(torch.full((dim,), init_values))

    def forward(self, x, cls, s: ViTSurgery = DEFAULT_VIT_SURGERY):
        u = torch.cat([cls, x], dim=1)
        cls = cls + self.gamma_1 * self.attn(self.norm1(u), s)
        h = apply_bwd_hook(self.norm2(cls), s.mlp_in_bwd, {"block": self.block_index})
        return cls + self.gamma_2 * self.mlp(h, s)


class Cait(nn.Module):
    def __init__(self, patch_size: int = 16, dim: int = 384, depth: int = 24,
                 depth_token_only: int = 2, num_heads: int = 8, mlp_ratio: float = 4.0,
                 init_values: float = 1e-5, num_classes: int = 1000, img_size: int = 224,
                 surgery: ViTSurgery = DEFAULT_VIT_SURGERY,
                 cls_surgery: ViTSurgery = DEFAULT_VIT_SURGERY):
        super().__init__()
        self.num_classes = num_classes
        self.patch_size, self.dim, self.depth, self.num_heads = patch_size, dim, depth, num_heads
        self.surgery, self.cls_surgery = surgery, cls_surgery
        self.patch_embed = PatchEmbed(dim, patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, (img_size // patch_size) ** 2, dim))
        self.blocks = nn.ModuleList([LayerScaleBlock(dim, num_heads, mlp_ratio, init_values, i)
                                     for i in range(depth)])
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.blocks_token_only = nn.ModuleList([
            LayerScaleBlockClassAttn(dim, num_heads, mlp_ratio, init_values, i)
            for i in range(depth_token_only)])
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.head = nn.Linear(dim, num_classes)

    def forward(self, x, features_only: bool = False, surgery: Optional[ViTSurgery] = None,
                cls_surgery: Optional[ViTSurgery] = None):
        s = self.surgery if surgery is None else surgery
        cs = self.cls_surgery if cls_surgery is None else cls_surgery
        x = self.patch_embed(x) + self.pos_embed
        for blk in self.blocks:
            x = blk(x, s)
        cls = self.cls_token.expand(x.shape[0], -1, -1)
        for blk in self.blocks_token_only:
            cls = blk(x, cls, cs)
        feats = self.norm(torch.cat([cls, x], dim=1))[:, 0]
        return feats if features_only else self.head(feats)


register_model("cait_s24_224", sized=True)(Cait)
