"""Stable Diffusion's VAE (counterpart of
``transferattack_tpu/generation/sd_vae.py``; diffusers' ``AutoencoderKL``
at the SD-1.5 configuration: block_out_channels (128, 256, 512, 512), 2
layers a block, a single-head attention in each mid-block, latent scale
0.18215).

NCHW modules with diffusers' names (``encoder.down_blocks.0.resnets.0``,
``decoder.mid_block.attentions.0.to_q``, ``quant_conv``).  GroupNorm's eps
is JAX's 1e-5 (diffusers' VAE has 1e-6).  The encoder's down-sampling pads
one row and column at the bottom and right and runs an unpadded stride-2
conv, as diffusers does.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .sd_unet import Sampler, SDResnetBlock, group_norm

SD_VAE_SCALE = 0.18215


class VAEAttention(nn.Module):
    """The mid-block ``Attention``: GroupNorm, then single-head to_q, to_k,
    to_v, to_out.0 (all with bias), and the residual."""

    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = group_norm(groups, ch)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        a = F.scaled_dot_product_attention(self.to_q(h)[:, None], self.to_k(h)[:, None],
                                           self.to_v(h)[:, None])[:, 0]
        return x + self.to_out[0](a).reshape(B, H, W, C).permute(0, 3, 1, 2)


class VAEMidBlock(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList(SDResnetBlock(ch, ch, 0, groups) for _ in range(2))
        self.attentions = nn.ModuleList([VAEAttention(ch, groups)])

    def forward(self, h):
        return self.resnets[1](self.attentions[0](self.resnets[0](h)))


class VAEBlock(nn.Module):
    """``DownEncoderBlock2D`` or ``UpDecoderBlock2D``: resnets, then a
    ``downsamplers.0`` (bottom-right pad, unpadded stride-2 conv) or an
    ``upsamplers.0`` (nearest ×2, 3×3 conv)."""

    def __init__(self, cin: int, cout: int, layers: int, groups: int, sample: str = ""):
        super().__init__()
        self.resnets = nn.ModuleList(SDResnetBlock(cin if i == 0 else cout, cout, 0, groups)
                                     for i in range(layers))
        if sample == "down":
            self.downsamplers = nn.ModuleList([Sampler(nn.Conv2d(cout, cout, 3, stride=2))])
        elif sample == "up":
            self.upsamplers = nn.ModuleList([Sampler(nn.Conv2d(cout, cout, 3, padding=1))])

    def forward(self, h):
        for res in self.resnets:
            h = res(h)
        if hasattr(self, "downsamplers"):
            h = self.downsamplers[0].conv(F.pad(h, (0, 1, 0, 1)))
        if hasattr(self, "upsamplers"):
            h = self.upsamplers[0].conv(F.interpolate(h, scale_factor=2, mode="nearest"))
        return h


class VAEEncoder(nn.Module):
    def __init__(self, block_out_channels, layers_per_block, latent_channels, groups):
        super().__init__()
        n, ch = len(block_out_channels), block_out_channels[0]
        self.conv_in = nn.Conv2d(3, ch, 3, padding=1)
        self.down_blocks = nn.ModuleList()
        for bi, co in enumerate(block_out_channels):
            self.down_blocks.append(VAEBlock(ch, co, layers_per_block, groups,
                                             "down" if bi < n - 1 else ""))
            ch = co
        self.mid_block = VAEMidBlock(ch, groups)
        self.conv_norm_out = group_norm(groups, ch)
        self.conv_out = nn.Conv2d(ch, 2 * latent_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            h = block(h)
        return self.conv_out(F.silu(self.conv_norm_out(self.mid_block(h))))


class VAEDecoder(nn.Module):
    def __init__(self, block_out_channels, layers_per_block, latent_channels, groups):
        super().__init__()
        rev = list(reversed(block_out_channels))
        n, ch = len(rev), rev[0]
        self.conv_in = nn.Conv2d(latent_channels, ch, 3, padding=1)
        self.mid_block = VAEMidBlock(ch, groups)
        self.up_blocks = nn.ModuleList()
        for bi, co in enumerate(rev):
            self.up_blocks.append(VAEBlock(ch, co, layers_per_block + 1, groups,
                                           "up" if bi < n - 1 else ""))
            ch = co
        self.conv_norm_out = group_norm(groups, ch)
        self.conv_out = nn.Conv2d(ch, 3, 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            h = block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class SDVAE(nn.Module):
    """``AutoencoderKL``: :meth:`encode` (B, 3, H, W) in [-1, 1] → the mean of
    the latent distribution, (B, 4, H/8, W/8) at SD-1.5 (DiffAttack uses the
    deterministic latent); :meth:`decode` a latent → an image in [-1, 1]."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4, groups: int = 32):
        super().__init__()
        self.block_out_channels = tuple(block_out_channels)
        args = (block_out_channels, layers_per_block, latent_channels, groups)
        self.encoder = VAEEncoder(*args)
        self.decoder = VAEDecoder(*args)
        self.quant_conv = nn.Conv2d(2 * latent_channels, 2 * latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(latent_channels, latent_channels, 1)

    def encode(self, x):
        return self.quant_conv(self.encoder(x)).chunk(2, dim=1)[0]

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x):
        return self.decode(self.encode(x))
