"""The generators of the generation attacks (counterpart of
``transferattack_tpu/generation/generators.py``; the reference's
``generation/{cdtp,ttp,m3d,ltp,ge_advgan,dsva}.py`` GeneratorResnet and
Generator, ``ada.py`` AttackGenerator).

NCHW ``nn.Module``s built from ``Sequential``s laid out as the reference's,
so their ``state_dict`` keys are the reference's PyTorch names (an official
checkpoint loads with ``load_state_dict``) and JAX's flat variables load
through the weights bridge.  BatchNorm runs in eval mode.  A JAX
``ConvTranspose(transpose_kernel=True)`` is torch's ``ConvTranspose2d`` on
the same (in, out, kh, kw) weight: Flax flips the kernel itself, and its
padding ``(k − 1 − p, k − 1 − p + output_padding)`` is torch's ``padding=p,
output_padding=...``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

NGF = 64
N_BLOCKS = 6     # GeneratorResnet's residual blocks
LATENT_DIM = 16  # ADA's z


class ResidualBlock(nn.Module):
    """``cdtp.py:101-130``: reflect pad, conv, BN, ReLU, dropout (off in
    eval), reflect pad, conv, BN, plus the skip."""

    def __init__(self, filters: int):
        super().__init__()
        self.block = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(filters, filters, 3, bias=False),
            nn.BatchNorm2d(filters), nn.ReLU(), nn.Dropout(0.5),
            nn.ReflectionPad2d(1), nn.Conv2d(filters, filters, 3, bias=False),
            nn.BatchNorm2d(filters))

    def forward(self, x):
        return x + self.block(x)


def _down(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 3, stride=2, padding=1, bias=False),
                         nn.BatchNorm2d(cout), nn.ReLU())


def _up(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(nn.ConvTranspose2d(cin, cout, 3, stride=2, padding=1,
                                            output_padding=1, bias=False),
                         nn.BatchNorm2d(cout), nn.ReLU())


class GeneratorResnet(nn.Module):
    """The TTP/M3D/CDTP/LTP/DSVA generator (``cdtp.py:23-108``): a 7×7 stem,
    two stride-2 convs to 256 channels, six residual blocks, two
    transposed-conv upsamples, a 7×7 conv with bias, ``(tanh + 1) / 2``: an
    image in [0, 1].  ``in_channels``: the stem's input channels (AIM feeds
    the image and its guide, 6)."""

    def __init__(self, inception: bool = False, in_channels: int = 3):
        super().__init__()
        self.inception = inception
        self.block1 = nn.Sequential(nn.ReflectionPad2d(3),
                                    nn.Conv2d(in_channels, NGF, 7, bias=False),
                                    nn.BatchNorm2d(NGF), nn.ReLU())
        self.block2 = _down(NGF, NGF * 2)
        self.block3 = _down(NGF * 2, NGF * 4)
        for i in range(N_BLOCKS):
            setattr(self, f"resblock{i + 1}", ResidualBlock(NGF * 4))
        self.upsampl1 = _up(NGF * 4, NGF * 2)
        self.upsampl2 = _up(NGF * 2, NGF)
        self.blockf = nn.Sequential(nn.ReflectionPad2d(3), nn.Conv2d(NGF, 3, 7))

    def forward(self, x):
        h = self.block3(self.block2(self.block1(x)))
        for i in range(N_BLOCKS):
            h = getattr(self, f"resblock{i + 1}")(h)
        h = self.blockf(self.upsampl2(self.upsampl1(h)))
        if self.inception:
            h = h[:, :, 1:, :-1]
        return (torch.tanh(h) + 1) / 2


class _AdvGANResnetBlock(nn.Module):
    """``ge_advgan.py:12-52``: reflect padding, BatchNorm, no bias."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3, bias=False), nn.BatchNorm2d(dim),
            nn.ReLU(), nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3, bias=False),
            nn.BatchNorm2d(dim))

    def forward(self, x):
        return x + self.conv_block(x)


class AdvGANGenerator(nn.Module):
    """GE-AdvGAN's Generator (``ge_advgan.py:55-106``): three VALID convs with
    bias, each with instance norm (no affine, eps 1e-5) and ReLU, four
    resnet blocks, three transposed convs without bias, ``tanh``.  The
    output, in [−1, 1], is the perturbation; at odd sides it is larger than
    the input by a row or column (the attack crops it)."""

    def __init__(self):
        super().__init__()
        self.encoder = nn.Sequential(
            nn.Conv2d(3, 8, 3), nn.InstanceNorm2d(8), nn.ReLU(),
            nn.Conv2d(8, 16, 3, stride=2), nn.InstanceNorm2d(16), nn.ReLU(),
            nn.Conv2d(16, 32, 3, stride=2), nn.InstanceNorm2d(32), nn.ReLU())
        self.bottle_neck = nn.Sequential(*[_AdvGANResnetBlock(32) for _ in range(4)])
        self.decoder = nn.Sequential(
            nn.ConvTranspose2d(32, 16, 3, stride=2, bias=False), nn.InstanceNorm2d(16),
            nn.ReLU(),
            nn.ConvTranspose2d(16, 8, 3, stride=2, bias=False), nn.InstanceNorm2d(8), nn.ReLU(),
            nn.ConvTranspose2d(8, 3, 6, bias=False), nn.Tanh())

    def forward(self, x):
        return self.decoder(self.bottle_neck(self.encoder(x)))


class _ADADown(nn.Module):
    """``UNetDown`` (``ada.py:99-128``): k3 s2 p1 conv without bias, optional
    BatchNorm (eps 1e-10), LeakyReLU 0.2.  The caller tiles z in."""

    def __init__(self, cin: int, feats: int, norm: bool):
        super().__init__()
        self.conv = nn.Conv2d(cin, feats, 3, stride=2, padding=1, bias=False)
        self.norm = nn.BatchNorm2d(feats, eps=1e-10) if norm else None

    def forward(self, h):
        h = self.conv(h)
        if self.norm is not None:
            h = self.norm(h)
        return F.leaky_relu(h, 0.2)


class _ADAUp(nn.Module):
    """``UNetUp`` (``ada.py:130-152``): ``ConvTranspose2d(k3, s2, p1,
    output_padding)`` with bias, BatchNorm (eps 1e-10), ReLU."""

    def __init__(self, cin: int, feats: int, out_pad: int):
        super().__init__()
        self.upconv = nn.ConvTranspose2d(cin, feats, 3, stride=2, padding=1,
                                         output_padding=out_pad)
        self.norm = nn.BatchNorm2d(feats, eps=1e-10)

    def forward(self, h):
        return F.relu(self.norm(self.upconv(h)))


class ADAGenerator(nn.Module):
    """ADA's AttackGenerator (``ada.py:154-203``, z 16, deeper_layer=False,
    last_dim 3): a U-Net whose every down block takes the MLP-encoded
    latent tiled as channel maps, skips ``[up2(d2), d1]`` and ``[up1(u2),
    d0]``, a final 3×3 conv without bias and ``tanh``.  Its shapes close at
    sides ≡ 3 (mod 4) (299 → 150 → 75 → 38 → 75 → 150 → 299); the output, in
    [−1, 1], is the perturbation."""

    def __init__(self, base: int = 64):
        super().__init__()
        z = LATENT_DIM
        self.z_encoder = nn.Sequential(nn.Linear(z, z), nn.ReLU(), nn.Linear(z, z), nn.ReLU())
        self.down0 = _ADADown(3 + z, base, norm=False)
        self.down1 = _ADADown(base + z, base, norm=True)
        self.down2 = _ADADown(base + z, base * 2, norm=False)
        self.up2 = _ADAUp(base * 2, base, out_pad=0)
        self.up1 = _ADAUp(base * 2, base, out_pad=1)
        self.up0 = _ADAUp(base * 2, base, out_pad=0)
        self.final = nn.Sequential(nn.Conv2d(base, 3, 3, padding=1, bias=False), nn.Tanh())

    @staticmethod
    def _tile(h, z):
        zmap = z[:, :, None, None].expand(-1, -1, h.shape[2], h.shape[3])
        return torch.cat([h, zmap.to(h.dtype)], dim=1)

    def forward(self, x, z):
        ze = self.z_encoder(z)
        d0 = self.down0(self._tile(x, ze))
        d1 = self.down1(self._tile(d0, ze))
        d2 = self.down2(self._tile(d1, ze))
        u2 = torch.cat([self.up2(d2), d1], dim=1)
        u1 = torch.cat([self.up1(u2), d0], dim=1)
        return self.final(self.up0(u1))
