"""Upsample-FIR-downsample resampling and fused bias + leaky ReLU in plain
PyTorch (counterpart of ``transferattack_tpu/ops/upfirdn.py``; the
reference's only CUDA kernels, ``defense/diffpure/score_sde/op/{upfirdn2d,
fused_bias_act}``, which serve NCSN++'s resampling blocks).

NHWC at the boundary, as in JAX.  Each is a zero-stuff, a pad and one
depthwise convolution (cuDNN on the card); no module of the port calls them
yet, so no kernel of the port's own is written for them.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def upfirdn2d(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """NHWC upfirdn: zero-stuff by ``up``, pad both spatial axes by ``pad``
    (before, after; a negative pad crops), filter each channel with the
    flipped ``kernel`` (a true convolution), keep every ``down``-th pixel
    (``upfirdn2d_kernel.cu``)."""
    B, H, W, C = x.shape
    kernel = torch.as_tensor(kernel, dtype=x.dtype, device=x.device)
    pad0, pad1 = pad
    if up > 1:
        z = x.new_zeros((B, H, up, W, up, C))
        z[:, :, 0, :, 0, :] = x
        x = z.reshape(B, H * up, W * up, C)
    x = x.permute(0, 3, 1, 2)
    x = F.pad(x, (max(pad0, 0), max(pad1, 0), max(pad0, 0), max(pad1, 0)))
    if pad0 < 0 or pad1 < 0:
        x = x[:, :, max(-pad0, 0): x.shape[2] - max(-pad1, 0),
              max(-pad0, 0): x.shape[3] - max(-pad1, 0)]
    weight = torch.flip(kernel, (0, 1))[None, None].expand(C, 1, *kernel.shape)
    out = F.conv2d(x, weight, stride=down, groups=C)
    return out.permute(0, 2, 3, 1)


def setup_blur_kernel(k: Sequence[float] = (1, 3, 3, 1)) -> torch.Tensor:
    k = torch.as_tensor(k, dtype=torch.float32)
    kern = torch.outer(k, k)
    return kern / kern.sum()


def upsample_2d(x: torch.Tensor, kernel: Optional[torch.Tensor] = None,
                factor: int = 2) -> torch.Tensor:
    kernel = (setup_blur_kernel() if kernel is None else kernel) * (factor ** 2)
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, up=factor, pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample_2d(x: torch.Tensor, kernel: Optional[torch.Tensor] = None,
                  factor: int = 2) -> torch.Tensor:
    kernel = setup_blur_kernel() if kernel is None else kernel
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, down=factor, pad=((p + 1) // 2, p // 2))


def fused_leaky_relu(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     negative_slope: float = 0.2, scale: float = 2 ** 0.5) -> torch.Tensor:
    """Bias on the last axis, leaky ReLU, times ``scale``
    (``fused_bias_act_kernel.cu``)."""
    if bias is not None:
        x = x + bias.reshape((1,) * (x.ndim - 1) + (-1,))
    return F.leaky_relu(x, negative_slope) * scale
