"""Visformer-S (counterpart of ``models/visformer.py``): a conv stem, a stage
of grouped-conv MLP blocks, two stages of attention blocks, BatchNorm
throughout, and a global-pool head.

The JAX model departs from timm's ``visformer_small`` (its convolutions
carry biases and its MLP ratio is 4), so its names are its own, not
timm's.  The module names here (``stem_conv``, ``patch_embed1``,
``stage1.0.mlp.conv1``, ``pos_embed1`` as (1, C, H, W), ...) are the ones
the JAX converter maps onto the JAX model; the position embeddings are
sized by ``img_size``.

Surgery, as JAX's Visformer takes it: a
:class:`~transferattack_torch.models.vit.ViTSurgery` whose ``qkv_bwd`` sees the
qkv cotangent flattened to (B, HW, 3C), whose ``attn_post``,
``skip_attn_grad`` and ``attn_bwd`` edit the attention map, and whose
``mlp_in_bwd`` sees the MLP input's as (B, HW, C).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from typing import Optional

from . import register_model
from .toy import same_pad
from .vit import DEFAULT_VIT_SURGERY, Tap, ViTSurgery, apply_bwd_hook, attention


def _bn(ch: int):
    return nn.BatchNorm2d(ch, eps=1e-5)


class SpatialMlp(nn.Module):
    def __init__(self, dim: int, hidden: int, group: int = 8, spatial_conv: bool = True):
        super().__init__()
        self.conv1 = nn.Conv2d(dim, hidden, 1)
        self.conv2 = (nn.Conv2d(hidden, hidden, 3, padding=1, groups=group)
                      if spatial_conv else None)
        self.conv3 = nn.Conv2d(hidden, dim, 1)

    def forward(self, x):
        x = F.gelu(self.conv1(x))
        if self.conv2 is not None:
            x = F.gelu(self.conv2(x))
        return self.conv3(x)


def _tokens_hook(x, hook, meta):
    """``hook`` on the cotangent of NCHW ``x`` seen as (B, HW, C) tokens."""
    if hook is None:
        return x
    b, c, h, w = x.shape
    t = apply_bwd_hook(x.flatten(2).transpose(1, 2), hook, meta)
    return t.transpose(1, 2).reshape(b, c, h, w)


class ConvAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, block_index: int = 0):
        super().__init__()
        self.num_heads = num_heads
        self.block_index = block_index
        self.qkv = nn.Conv2d(dim, dim * 3, 1)
        self.proj = nn.Conv2d(dim, dim, 1)
        self.attn_map = Tap()

    def forward(self, x, s: ViTSurgery = DEFAULT_VIT_SURGERY):
        b, c, h, w = x.shape
        meta = {"block": self.block_index, "num_heads": self.num_heads, "tokens": h * w}
        qkv = _tokens_hook(self.qkv(x), s.qkv_bwd, meta)
        # channel k of qkv is (which of q/k/v, head, head channel), as in JAX
        q, k, v = qkv.reshape(b, 3, self.num_heads, c // self.num_heads,
                              h * w).permute(1, 0, 2, 4, 3)
        # JAX's Visformer has no score hooks: only the map's are passed on
        s = ViTSurgery(attn_post=s.attn_post, attn_bwd=s.attn_bwd,
                       skip_attn_grad=s.skip_attn_grad)
        out = attention(q, k, v, s, meta, self.attn_map)  # (B, heads, HW, dh)
        return self.proj(out.transpose(2, 3).reshape(b, c, h, w))


class VisformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int = 6, mlp_ratio: float = 4.0,
                 group: int = 8, use_attn: bool = True, spatial_conv: bool = False,
                 block_index: int = 0):
        super().__init__()
        self.block_index = block_index
        if use_attn:
            self.norm1 = _bn(dim)
            self.attn = ConvAttention(dim, num_heads, block_index)
        self.norm2 = _bn(dim)
        self.mlp = SpatialMlp(dim, int(dim * mlp_ratio), group, spatial_conv)

    def forward(self, x, s: ViTSurgery = DEFAULT_VIT_SURGERY):
        if hasattr(self, "attn"):
            x = x + self.attn(self.norm1(x), s)
        h = _tokens_hook(self.norm2(x), s.mlp_in_bwd, {"block": self.block_index})
        return x + self.mlp(h)


class Visformer(nn.Module):
    def __init__(self, init_channels: int = 32, embed_dim: int = 384, depths=(7, 4, 4),
                 num_heads: int = 6, group: int = 8, num_classes: int = 1000,
                 img_size: int = 224, surgery: ViTSurgery = DEFAULT_VIT_SURGERY):
        super().__init__()
        self.num_classes = num_classes
        self.surgery = surgery
        self.stem_conv = nn.Conv2d(3, init_channels, 7, 2, 3, bias=False)
        self.stem_norm = _bn(init_channels)
        side = -(-img_size // 2)
        dims, patches, inp = (embed_dim // 2, embed_dim, embed_dim * 2), (4, 2, 2), init_channels
        first = 0
        for i, (dim, patch, depth) in enumerate(zip(dims, patches, depths), start=1):
            side = -(-side // patch)  # Flax's 'SAME' padding: ceil(side / stride)
            setattr(self, f"patch_embed{i}", nn.Conv2d(inp, dim, patch, patch))
            setattr(self, f"embed_norm{i}", _bn(dim))
            setattr(self, f"pos_embed{i}", nn.Parameter(torch.zeros(1, dim, side, side)))
            setattr(self, f"stage{i}", nn.ModuleList([
                VisformerBlock(dim, num_heads, group=group, use_attn=i > 1,
                               spatial_conv=i == 1, block_index=first + j)
                for j in range(depth)]))
            inp, first = dim, first + depth
        self.norm = _bn(inp)
        self.head = nn.Linear(inp, num_classes)

    def forward(self, x, surgery: Optional[ViTSurgery] = None):
        s = self.surgery if surgery is None else surgery
        x = F.relu(self.stem_norm(self.stem_conv(x)))
        for i, patch in enumerate((4, 2, 2), start=1):
            x = getattr(self, f"patch_embed{i}")(same_pad(x, patch, patch))
            x = getattr(self, f"embed_norm{i}")(x) + getattr(self, f"pos_embed{i}")
            for blk in getattr(self, f"stage{i}"):
                x = blk(x, s)
        return self.head(self.norm(x).mean(dim=(2, 3)))


register_model("visformer_small", sized=True)(Visformer)
