"""Orthonormal 2-D DCT-II / DCT-III as products with the DCT matrix
(counterpart of ``transferattack_tpu/ops/dct.py``).

JAX computes these outside any Pallas kernel, so the port does too: two
``torch.tensordot`` products per transform, on cuBLAS on the card.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def _dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix D such that ``y = D @ x``."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    mat = np.cos(np.pi / n * (i + 0.5) * k)
    mat[0] *= 1.0 / np.sqrt(2.0)
    return (mat * np.sqrt(2.0 / n)).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _dct_tensor(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_dct_matrix(n)).to(device=device, dtype=dtype)


def _apply(x: torch.Tensor, axes, transpose: bool) -> torch.Tensor:
    for ax in axes:
        mat = _dct_tensor(x.shape[ax], x.dtype, x.device)
        mat = mat.T if transpose else mat
        x = torch.tensordot(mat, x, dims=([1], [ax])).movedim(0, ax)
    return x


def dct_2d(x: torch.Tensor, axes=(1, 2)) -> torch.Tensor:
    """2-D orthonormal DCT-II over ``axes`` (default NHWC spatial dims)."""
    return _apply(x, axes, transpose=False)


def idct_2d(x: torch.Tensor, axes=(1, 2)) -> torch.Tensor:
    """Inverse (DCT-III) of :func:`dct_2d`."""
    return _apply(x, axes, transpose=True)
