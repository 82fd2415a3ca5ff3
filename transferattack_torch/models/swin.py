"""Swin (counterpart of ``models/swin.py``), timm's module names.

Windowed attention with cyclic shifts, relative position bias and patch
merging, on (B, H, W, C) tensors as in JAX.  The window size of a stage is
clamped to its feature map and the shift dropped when one window covers
it, as in JAX (and timm), so the blocks are built for ``img_size``.  The
relative position index and the shift mask are non-persistent buffers,
computed here; the JAX converter skips timm's copies of them, and the
bridge expects none.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import register_model
from .vit import Mlp


def window_partition(x, ws: int):
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(wins, ws: int, h: int, w: int):
    b = wins.shape[0] // ((h // ws) * (w // ws))
    x = wins.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def relative_position_index(ws: int) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0) + (ws - 1)
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


def shift_attn_mask(h: int, w: int, ws: int, shift: int) -> torch.Tensor:
    """Additive mask (-100 between tokens of different regions), one
    (N, N) slice per window."""
    img = torch.zeros(1, h, w, 1)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    wins = window_partition(img, ws).squeeze(-1)
    mask = wins[:, None, :] - wins[:, :, None]
    return torch.where(mask != 0, -100.0, 0.0)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, ws: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             relative_position_index(ws).reshape(-1), persistent=False)

    def forward(self, x, mask=None):
        bw, n, c = x.shape
        h = self.num_heads
        q, k, v = self.qkv(x).reshape(bw, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        attn = (q @ k.transpose(-2, -1)) * (c // h) ** -0.5
        bias = self.relative_position_bias_table[self.relative_position_index]
        attn = attn + bias.reshape(n, n, h).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(bw // nw, nw, h, n, n) + mask[None, :, None]).reshape(
                bw, h, n, n)
        out = (attn.softmax(dim=-1) @ v).transpose(1, 2).reshape(bw, n, c)
        return self.proj(out)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, hw: int, window_size: int = 7,
                 shift: int = 0, mlp_ratio: float = 4.0):
        super().__init__()
        self.ws = min(window_size, hw)
        self.shift = shift if self.ws < hw else 0
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, self.ws)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.register_buffer(
            "attn_mask", shift_attn_mask(hw, hw, self.ws, self.shift) if self.shift
            else None, persistent=False)

    def forward(self, x):
        _, h, w, _ = x.shape
        ws, shift = self.ws, self.shift
        y = self.norm1(x)
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        y = window_reverse(self.attn(window_partition(y, ws), self.attn_mask), ws, h, w)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c)
        # timm's order: (0::2, 0::2), (1::2, 0::2), (0::2, 1::2), (1::2, 1::2)
        x = torch.cat([x[:, :, 0, :, 0], x[:, :, 1, :, 0], x[:, :, 0, :, 1],
                       x[:, :, 1, :, 1]], dim=-1)
        return self.reduction(self.norm(x))


class Stage(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, hw: int, window_size: int,
                 last: bool):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, heads, hw, window_size, 0 if j % 2 == 0 else window_size // 2)
            for j in range(depth)])
        if not last:
            self.downsample = PatchMerging(dim)

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return self.downsample(x) if hasattr(self, "downsample") else x


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, patch)
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x):  # (B, 3, H, W) -> (B, H/P, W/P, dim)
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class SwinTransformer(nn.Module):
    def __init__(self, patch_size: int = 4, embed_dim: int = 96, depths=(2, 2, 6, 2),
                 num_heads=(3, 6, 12, 24), window_size: int = 7, num_classes: int = 1000,
                 img_size: int = 224):
        super().__init__()
        self.num_classes = num_classes
        self.patch_embed = PatchEmbed(embed_dim, patch_size)
        hw, dim, stages = img_size // patch_size, embed_dim, []
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            last = i == len(depths) - 1
            stages.append(Stage(dim, depth, heads, hw, window_size, last))
            if not last:
                hw, dim = hw // 2, dim * 2
        self.layers = nn.ModuleList(stages)
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.head = nn.Linear(dim, num_classes)

    def forward(self, x):
        x = self.patch_embed(x)
        for stage in self.layers:
            x = stage(x)
        return self.head(self.norm(x).mean(dim=(1, 2)))


register_model("swin_tiny_patch4_window7_224", sized=True)(SwinTransformer)
register_model("swin_small_patch4_window7_224", sized=True)(
    lambda **kw: SwinTransformer(depths=(2, 2, 18, 2), **kw)
)
