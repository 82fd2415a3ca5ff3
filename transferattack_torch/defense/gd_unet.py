"""The guided-diffusion UNet (counterpart of
``transferattack_tpu/defense/gd_unet.py``; the reference's vendored
``guided_diffusion/unet.py:404-672``, the 256×256 unconditional ImageNet
model whose ``256x256_diffusion_uncond.pt`` DiffPure loads).

NCHW, with the reference's module names (``input_blocks.N.M``,
``middle_block.K``, ``output_blocks.N.M``, ``time_embed.0/2``, ``out.0/2``,
a ResBlock's ``in_layers.0/2``, ``emb_layers.1``, ``out_layers.0/3`` and
``skip_connection``, an attention block's ``norm``, ``qkv``, ``proj_out``,
the last two ``Conv1d``s), so the official ``state_dict`` loads with
``load_state_dict`` and JAX's flat variables through the weights bridge.
GroupNorm(32) runs in fp32 with eps 1e-5; attention uses the legacy qkv
layout (head-major, ``[q|k|v]`` inside each head) with q and k each scaled
by ch^-1/4 and an fp32 softmax.  Each attention map (B, heads, T, T) is
appended, in call order, to the ``maps`` list a caller passes to
:meth:`GuidedDiffusionUNet.forward` (DiffAttack's AttentionStore).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..models import init_weights

GN_GROUPS, GN_EPS = 32, 1e-5
IN_CHANNELS, OUT_CHANNELS = 3, 6  # RGB in; ε and the learned-range variance out


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding (``guided_diffusion/nn.py``): cos and sin halves
    over exp(-ln(P)·i/half) frequencies, in fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def _norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(GN_GROUPS, channels, eps=GN_EPS)


class ResBlock(nn.Module):
    """``unet.py:151-264`` with scale-shift norm; ``up``/``down`` resample
    both ``h`` (between the first norm and conv) and the skip: nearest ×2,
    or a 2×2 average pool.  A 1×1 skip conv where the channels change."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int,
                 up: bool = False, down: bool = False):
        super().__init__()
        self.up, self.down = up, down
        self.in_layers = nn.Sequential(_norm(channels), nn.SiLU(),
                                       nn.Conv2d(channels, out_channels, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_channels, 2 * out_channels))
        self.out_layers = nn.Sequential(_norm(out_channels), nn.SiLU(), nn.Dropout(0.0),
                                        nn.Conv2d(out_channels, out_channels, 3, padding=1))
        self.skip_connection = (nn.Identity() if channels == out_channels
                                else nn.Conv2d(channels, out_channels, 1))

    def _resample(self, x):
        if self.up:
            return F.interpolate(x, scale_factor=2, mode="nearest")
        if self.down:
            return F.avg_pool2d(x, 2)
        return x

    def forward(self, x, emb):
        h = self._resample(self.in_layers[1](self.in_layers[0](x)))
        x = self._resample(x)
        h = self.in_layers[2](h)
        scale, shift = self.emb_layers(emb)[:, :, None, None].chunk(2, dim=1)
        h = self.out_layers[0](h) * (1 + scale) + shift
        h = self.out_layers[3](self.out_layers[1](h))  # Dropout(0) is the identity
        return self.skip_connection(x) + h


class AttentionBlock(nn.Module):
    """``unet.py:267-334`` spatial self-attention, QKVAttentionLegacy."""

    def __init__(self, channels: int, num_head_channels: int):
        super().__init__()
        self.heads = channels // num_head_channels
        self.norm = _norm(channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)

    def forward(self, x, maps: Optional[List[torch.Tensor]] = None):
        B, C, H, W = x.shape
        T, heads = H * W, self.heads
        ch = C // heads
        # a 1×1 Conv1d over (B, C, T) is a product over the channels of the
        # (B, T, C) tokens, which a channels_last x gives without a copy
        h = self.norm(x).permute(0, 2, 3, 1).reshape(B, T, C)
        qkv = F.linear(h, self.qkv.weight[:, :, 0], self.qkv.bias)
        q, k, v = qkv.view(B, T, heads, 3, ch).unbind(3)
        scale = 1.0 / math.sqrt(math.sqrt(ch))
        w = torch.softmax(torch.einsum("bthc,bshc->bhts", q * scale, k * scale).float(), dim=-1)
        if maps is not None:
            maps.append(w)
        a = torch.einsum("bhts,bshc->bthc", w.to(v.dtype), v).reshape(B, T, C)
        a = F.linear(a, self.proj_out.weight[:, :, 0], self.proj_out.bias)
        return x + a.view(B, H, W, C).permute(0, 3, 1, 2)


class TimestepSequential(nn.Sequential):
    """Layers in sequence; a ResBlock also takes the embedding, an
    attention block the ``maps`` list."""

    def forward(self, x, emb, maps=None):
        for layer in self:
            if isinstance(layer, ResBlock):
                x = layer(x, emb)
            elif isinstance(layer, AttentionBlock):
                x = layer(x, maps)
            else:
                x = layer(x)
        return x


class GuidedDiffusionUNet(nn.Module):
    """``unet.py:404-672`` UNetModel with JAX's fields and the ImageNet-256
    unconditional defaults: 256 channels, ``channel_mult (1, 1, 2, 2, 4,
    4)``, two ResBlocks a level, attention at downsample rates 8, 16 and 32
    with 64 channels a head, down/up ResBlocks between levels, 6 output
    channels (ε and the learned-range variance).  The network takes any side
    divisible by 2^(levels − 1)."""

    def __init__(self, model_channels: int = 256, num_res_blocks: int = 2,
                 attention_ds: Sequence[int] = (8, 16, 32),
                 channel_mult: Sequence[int] = (1, 1, 2, 2, 4, 4), num_head_channels: int = 64):
        super().__init__()
        self.model_channels = mc = model_channels
        emb_ch = 4 * mc
        self.time_embed = nn.Sequential(nn.Linear(mc, emb_ch), nn.SiLU(), nn.Linear(emb_ch, emb_ch))
        ch = int(channel_mult[0] * mc)
        self.input_blocks = nn.ModuleList(
            [TimestepSequential(nn.Conv2d(IN_CHANNELS, ch, 3, padding=1))])
        chans, ds = [ch], 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlock(ch, emb_ch, int(mult * mc))]
                ch = int(mult * mc)
                if ds in attention_ds:
                    layers.append(AttentionBlock(ch, num_head_channels))
                self.input_blocks.append(TimestepSequential(*layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(TimestepSequential(ResBlock(ch, emb_ch, ch, down=True)))
                chans.append(ch)
                ds *= 2
        self.middle_block = TimestepSequential(ResBlock(ch, emb_ch, ch),
                                               AttentionBlock(ch, num_head_channels),
                                               ResBlock(ch, emb_ch, ch))
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                layers = [ResBlock(ch + chans.pop(), emb_ch, int(mult * mc))]
                ch = int(mult * mc)
                if ds in attention_ds:
                    layers.append(AttentionBlock(ch, num_head_channels))
                if level and i == num_res_blocks:
                    layers.append(ResBlock(ch, emb_ch, ch, up=True))
                    ds //= 2
                self.output_blocks.append(TimestepSequential(*layers))
        self.out = nn.Sequential(_norm(ch), nn.SiLU(), nn.Conv2d(ch, OUT_CHANNELS, 3, padding=1))

    def forward(self, x, timesteps, maps: Optional[List[torch.Tensor]] = None):
        """ε and the variance fraction (B, 6, H, W) of NCHW ``x``
        at ``timesteps`` (B,); each attention map is appended to ``maps``."""
        emb = self.time_embed(timestep_embedding(timesteps, self.model_channels))
        hs, h = [], x
        for block in self.input_blocks:
            h = block(h, emb, maps)
            hs.append(h)
        h = self.middle_block(h, emb, maps)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb, maps)
        return self.out(h)


def init_unet(unet: GuidedDiffusionUNet, generator: torch.Generator) -> None:
    """A seeded init with Flax's semantics: :func:`init_weights` (lecun-normal
    kernels, zero biases, GroupNorm's scale 1 and bias 0), then the layers
    the reference zero-initialises (``zero_module``: each ResBlock's
    ``out_layers.3``, each attention's ``proj_out``, ``out.2``) at 0, so that
    ε is exactly 0."""
    init_weights(unet, generator)
    zeroed = [unet.out[2]]
    for m in unet.modules():
        if isinstance(m, ResBlock):
            zeroed.append(m.out_layers[3])
        elif isinstance(m, AttentionBlock):
            zeroed.append(m.proj_out)
    with torch.no_grad():
        for layer in zeroed:
            layer.weight.zero_()
            layer.bias.zero_()


def init_nonzero(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """A seeded init with every parameter drawn and nonzero, for checks on
    random weights where ε must not be 0: :func:`init_weights`, the layers
    the reference zero-initialises drawn too, then biases N(0, 0.02²) and
    the other 1-D parameters (GroupNorm's scales) 1 + N(0, 0.1²), all from
    ``generator`` on the module's device.  Returns the module in eval mode."""
    init_weights(module, generator)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.02, generator=generator)
            elif p.ndim == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=generator, device=p.device))
    return module.eval()
