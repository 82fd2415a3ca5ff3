"""Smoothing kernels and the depthwise convolution that applies them
(counterpart of ``transferattack_tpu/ops/kernels.py``).

The kernels are numpy copies of JAX's (TIM's recipes, the normal pdf on a
linspace); :func:`smooth_conv` is one depthwise ``F.conv2d`` on cuDNN.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=16)
def gaussian_kernel(kernel_size: int, nsig: float = 3.0) -> np.ndarray:
    """Normalized 2-D gaussian kernel (TIM's ``'gaussian'``)."""
    x = np.linspace(-nsig, nsig, kernel_size)
    kern1d = np.exp(-0.5 * x**2) / np.sqrt(2 * np.pi)
    kern = np.outer(kern1d, kern1d)
    return (kern / kern.sum()).astype(np.float32)


@functools.lru_cache(maxsize=16)
def uniform_kernel(kernel_size: int) -> np.ndarray:
    return (np.ones((kernel_size, kernel_size)) / kernel_size**2).astype(np.float32)


@functools.lru_cache(maxsize=16)
def linear_kernel(kernel_size: int) -> np.ndarray:
    kern1d = 1 - np.abs(
        np.linspace((-kernel_size + 1) // 2, (kernel_size - 1) // 2, kernel_size)
        / (kernel_size**2)
    )
    kern = np.outer(kern1d, kern1d)
    return (kern / kern.sum()).astype(np.float32)


def make_kernel(kernel_type: str, kernel_size: int) -> np.ndarray:
    if kernel_type.lower() == "gaussian":
        return gaussian_kernel(kernel_size)
    if kernel_type.lower() == "uniform":
        return uniform_kernel(kernel_size)
    if kernel_type.lower() == "linear":
        return linear_kernel(kernel_size)
    raise ValueError(f"Unsupported kernel type {kernel_type}")


def smooth_conv(x: torch.Tensor, kernel) -> torch.Tensor:
    """Depthwise 'same' convolution of an NHWC batch with a 2-D kernel
    (padding ``k // 2`` on each side, as JAX pads)."""
    k = torch.as_tensor(np.asarray(kernel), dtype=x.dtype, device=x.device)
    c = x.shape[-1]
    weight = k[None, None].expand(c, 1, *k.shape)
    # a contiguous NHWC tensor permuted to NCHW is channels_last: no copy
    out = F.conv2d(x.permute(0, 3, 1, 2), weight, padding=k.shape[0] // 2, groups=c)
    return out.permute(0, 2, 3, 1).contiguous()
