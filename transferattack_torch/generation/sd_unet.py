"""Stable Diffusion 1.5's conditional UNet (counterpart of
``transferattack_tpu/generation/sd_unet.py``; diffusers'
``UNet2DConditionModel`` at the ``runwayml/stable-diffusion-v1-5``
configuration: block_out_channels (320, 640, 1280, 1280), 2 layers a block,
8 heads, cross_attention_dim 768, 32 groups; CrossAttnDownBlock2D ×3 and
DownBlock2D down, UNetMidBlock2DCrossAttn, UpBlock2D and
CrossAttnUpBlock2D ×3 up).

NCHW modules with diffusers' names (``down_blocks.0.resnets.0.norm1``,
``...attentions.0.transformer_blocks.0.attn1.to_out.0``, ``ff.net.0.proj``,
``downsamplers.0.conv``), so a diffusers ``state_dict`` loads with
``load_state_dict`` and JAX's flat npz through the weights bridge.
GroupNorm and LayerNorm take JAX's eps, 1e-5; the timestep embedding is
``[cos, sin]``; GEGLU's GELU is the exact one.

With a ``maps`` dict passed to ``forward``, every attention computes its
softmax explicitly and appends it, (B, heads, N, M), to ``maps["attn"]``
(self-attention, attn1) or ``maps["cross_attn"]`` (the text, attn2), in
call order, which is the order of JAX's walk over Flax's intermediates:
DiffAttack's AttentionStore.  Without it, attention is
``scaled_dot_product_attention``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

Maps = Optional[Dict[str, List[torch.Tensor]]]


def sd_timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0):
    """diffusers ``Timesteps`` with flip_sin_to_cos=True, shift 0:
    ``[cos, sin]`` over ``exp(−ln(P)·i/half)``, in fp32."""
    half = dim // 2
    log_p = torch.log(torch.tensor(max_period, dtype=torch.float32, device=t.device))
    freqs = torch.exp(-log_p * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def group_norm(groups: int, channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(groups, channels, eps=1e-5)


class SDTimeEmbedding(nn.Module):
    """``TimestepEmbedding``: linear_1, SiLU, linear_2."""

    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(cin, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, emb):
        return self.linear_2(F.silu(self.linear_1(emb)))


class SDResnetBlock(nn.Module):
    """``ResnetBlock2D``: GroupNorm, SiLU, 3×3 conv twice, the time embedding
    added between (``temb_channels`` 0: none, the VAE's), a 1×1 shortcut
    where the channels change."""

    def __init__(self, cin: int, cout: int, temb_channels: int, groups: int):
        super().__init__()
        self.norm1 = group_norm(groups, cin)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        if temb_channels:
            self.time_emb_proj = nn.Linear(temb_channels, cout)
        self.norm2 = group_norm(groups, cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


def attention(q, k, v, heads: int, maps: Optional[List[torch.Tensor]]):
    """Multi-head attention of (B, N, C) ``q`` over (B, M, C) ``k``, ``v``;
    the softmax appended to ``maps`` when it is a list."""
    B, N, C = q.shape
    M = k.shape[1]
    q = q.reshape(B, N, heads, C // heads).transpose(1, 2)
    k = k.reshape(B, M, heads, C // heads).transpose(1, 2)
    v = v.reshape(B, M, heads, C // heads).transpose(1, 2)
    if maps is None:
        a = F.scaled_dot_product_attention(q, k, v)
    else:
        w = torch.softmax(q @ k.transpose(-1, -2) * (C // heads) ** -0.5, dim=-1)
        maps.append(w)
        a = w @ v
    return a.transpose(1, 2).reshape(B, N, C)


class SDCrossAttention(nn.Module):
    """diffusers ``Attention``: to_q, to_k, to_v without bias, to_out.0 with.
    Self-attention when ``context`` is None.  ``kind``: the ``maps`` list it
    appends to, ``"attn"`` or ``"cross_attn"``."""

    def __init__(self, dim: int, ctx_dim: int, heads: int, kind: str):
        super().__init__()
        self.heads, self.kind = heads, kind
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(ctx_dim, dim, bias=False)
        self.to_v = nn.Linear(ctx_dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x, context=None, maps: Maps = None):
        ctx = x if context is None else context
        a = attention(self.to_q(x), self.to_k(ctx), self.to_v(ctx), self.heads,
                      None if maps is None else maps[self.kind])
        return self.to_out[0](a)


class GEGLU(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Linear(dim, dim * 8)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class SDFeedForward(nn.Module):
    """GEGLU feed-forward: ``net.0.proj``, ``net.1`` (dropout, off), ``net.2``."""

    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim), nn.Dropout(0.0), nn.Linear(dim * 4, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class SDTransformerBlock(nn.Module):
    """``BasicTransformerBlock``: self-attention, text cross-attention, FF."""

    def __init__(self, dim: int, ctx_dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = SDCrossAttention(dim, dim, heads, "attn")
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = SDCrossAttention(dim, ctx_dim, heads, "cross_attn")
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = SDFeedForward(dim)

    def forward(self, x, context, maps: Maps = None):
        x = x + self.attn1(self.norm1(x), maps=maps)
        x = x + self.attn2(self.norm2(x), context, maps=maps)
        return x + self.ff(self.norm3(x))


class SDTransformer2D(nn.Module):
    """``Transformer2DModel`` (1×1-conv projections), depth 1."""

    def __init__(self, dim: int, ctx_dim: int, heads: int, groups: int):
        super().__init__()
        self.norm = group_norm(groups, dim)
        self.proj_in = nn.Conv2d(dim, dim, 1)
        self.transformer_blocks = nn.ModuleList([SDTransformerBlock(dim, ctx_dim, heads)])
        self.proj_out = nn.Conv2d(dim, dim, 1)

    def forward(self, x, context, maps: Maps = None):
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x)).permute(0, 2, 3, 1).reshape(B, H * W, C)
        h = self.transformer_blocks[0](h, context, maps)
        return self.proj_out(h.reshape(B, H, W, C).permute(0, 3, 1, 2)) + x


class Sampler(nn.Module):
    """A ``downsamplers.0``/``upsamplers.0`` entry: its one ``conv``."""

    def __init__(self, conv: nn.Conv2d):
        super().__init__()
        self.conv = conv


class SDDownBlock(nn.Module):
    """CrossAttnDownBlock2D (``with_attn``) or DownBlock2D: the running
    feature and each layer's skip state."""

    def __init__(self, cin, cout, temb, ctx_dim, heads, layers, groups, with_attn, downsample):
        super().__init__()
        self.resnets = nn.ModuleList(SDResnetBlock(cin if i == 0 else cout, cout, temb, groups)
                                     for i in range(layers))
        if with_attn:
            self.attentions = nn.ModuleList(SDTransformer2D(cout, ctx_dim, heads, groups)
                                            for _ in range(layers))
        if downsample:
            self.downsamplers = nn.ModuleList([Sampler(nn.Conv2d(cout, cout, 3, stride=2,
                                                                 padding=1))])

    def forward(self, h, temb, context, maps: Maps = None):
        skips = []
        for i, res in enumerate(self.resnets):
            h = res(h, temb)
            if hasattr(self, "attentions"):
                h = self.attentions[i](h, context, maps)
            skips.append(h)
        if hasattr(self, "downsamplers"):
            h = self.downsamplers[0].conv(h)
            skips.append(h)
        return h, skips


class SDUpBlock(nn.Module):
    """CrossAttnUpBlock2D (``with_attn``) or UpBlock2D; takes the skips from
    the end of the list.  ``cins``: each resnet's input channels."""

    def __init__(self, cins: Sequence[int], cout, temb, ctx_dim, heads, groups, with_attn,
                 upsample):
        super().__init__()
        self.resnets = nn.ModuleList(SDResnetBlock(c, cout, temb, groups) for c in cins)
        if with_attn:
            self.attentions = nn.ModuleList(SDTransformer2D(cout, ctx_dim, heads, groups)
                                            for _ in cins)
        if upsample:
            self.upsamplers = nn.ModuleList([Sampler(nn.Conv2d(cout, cout, 3, padding=1))])

    def forward(self, h, skips, temb, context, maps: Maps = None):
        for i, res in enumerate(self.resnets):
            h = res(torch.cat([h, skips.pop()], dim=1), temb)
            if hasattr(self, "attentions"):
                h = self.attentions[i](h, context, maps)
        if hasattr(self, "upsamplers"):
            h = self.upsamplers[0].conv(F.interpolate(h, scale_factor=2, mode="nearest"))
        return h


class SDMidBlock(nn.Module):
    """UNetMidBlock2DCrossAttn: resnet, transformer, resnet."""

    def __init__(self, ch, temb, ctx_dim, heads, groups):
        super().__init__()
        self.resnets = nn.ModuleList(SDResnetBlock(ch, ch, temb, groups) for _ in range(2))
        self.attentions = nn.ModuleList([SDTransformer2D(ch, ctx_dim, heads, groups)])

    def forward(self, h, temb, context, maps: Maps = None):
        h = self.resnets[0](h, temb)
        h = self.attentions[0](h, context, maps)
        return self.resnets[1](h, temb)


class SDUNet(nn.Module):
    """``UNet2DConditionModel``: ``forward(latent (B, 4, h, w), t (B,),
    context (B, 77, cross_attention_dim), maps=None) → ε (B, 4, h, w)``."""

    def __init__(self, in_channels: int = 4, out_channels: int = 4,
                 block_out_channels: Sequence[int] = (320, 640, 1280, 1280),
                 layers_per_block: int = 2, heads: int = 8, cross_attention_dim: int = 768,
                 norm_groups: int = 32):
        super().__init__()
        ch0, n, layers = block_out_channels[0], len(block_out_channels), layers_per_block
        self.block_out_channels = tuple(block_out_channels)
        self.cross_attention_dim = cross_attention_dim
        temb = ch0 * 4
        kw = dict(ctx_dim=cross_attention_dim, heads=heads, groups=norm_groups)
        self.time_embedding = SDTimeEmbedding(ch0, temb)
        self.conv_in = nn.Conv2d(in_channels, ch0, 3, padding=1)
        self.down_blocks = nn.ModuleList()
        skip_chs, ch = [ch0], ch0
        for bi, co in enumerate(block_out_channels):
            self.down_blocks.append(SDDownBlock(ch, co, temb, layers=layers, with_attn=bi < n - 1,
                                                downsample=bi < n - 1, **kw))
            skip_chs += [co] * (layers + (bi < n - 1))
            ch = co
        self.mid_block = SDMidBlock(ch, temb, **kw)
        self.up_blocks = nn.ModuleList()
        for bi, co in enumerate(reversed(block_out_channels)):
            cins = []
            for _ in range(layers + 1):
                cins.append(ch + skip_chs.pop())
                ch = co
            self.up_blocks.append(SDUpBlock(cins, co, temb, with_attn=bi > 0,
                                            upsample=bi < n - 1, **kw))
        self.conv_norm_out = group_norm(norm_groups, ch0)
        self.conv_out = nn.Conv2d(ch0, out_channels, 3, padding=1)

    def forward(self, x, timesteps, context, maps: Maps = None):
        temb = self.time_embedding(sd_timestep_embedding(timesteps, self.block_out_channels[0]))
        h = self.conv_in(x)
        skips = [h]
        for block in self.down_blocks:
            h, s = block(h, temb, context, maps)
            skips.extend(s)
        h = self.mid_block(h, temb, context, maps)
        for block in self.up_blocks:
            h = block(h, skips, temb, context, maps)
        return self.conv_out(F.silu(self.conv_norm_out(h)))

