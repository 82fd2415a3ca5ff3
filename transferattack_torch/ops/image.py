"""Differentiable image warps and resampling (counterpart of the exact
functions of ``transferattack_tpu/ops/image.py``).

Layout at the boundary is NHWC, as in JAX.  Warps are bilinear with zero
padding and ``align_corners=False`` over ``F.affine_grid`` and
``F.grid_sample`` (JAX's ``affine_grid``/``grid_sample`` are written to that
contract); their backward is PyTorch's own.  JAX's gather-free stand-ins for
these warps (shear-based rotations, separable shifts and fields) exist only
because the TPU's gathers faulted, and are not ported.

:func:`scale_and_translate` is the port's copy of
``jax.image.scale_and_translate(..., method="linear")``: one (in, out)
triangle-kernel weight matrix per spatial axis, widened by ``1/scale`` when
it shrinks (JAX's ``antialias=True``), applied as two products.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Scalar = Union[float, Tensor]


def affine_grid(theta: Tensor, H: int, W: int) -> Tensor:
    """(B, H, W, 2) normalized (x, y) source coordinates of a batch of 2×3
    matrices mapping output to input coordinates (row 0 → x, row 1 → y)."""
    return F.affine_grid(theta.float(), [theta.shape[0], 1, H, W], align_corners=False)


def grid_sample(x: Tensor, grid: Tensor) -> Tensor:
    """Bilinear, zero-padded sample of NHWC ``x`` at normalized (x, y)
    ``grid`` (B, Ho, Wo, 2).  The taps run in fp32 whatever ``x``'s dtype,
    as in JAX."""
    out = F.grid_sample(x.float().permute(0, 3, 1, 2), grid.float(), mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out.permute(0, 2, 3, 1).to(x.dtype)


def affine_warp(x: Tensor, theta: Tensor) -> Tensor:
    """Apply (B, 2, 3) affine matrices to an NHWC batch."""
    return grid_sample(x, affine_grid(theta, x.shape[1], x.shape[2]))


def _per_image(v: Scalar, x: Tensor) -> Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=x.device).expand(x.shape[0])


def _theta(a: Tensor, b: Tensor, tx: Tensor, c: Tensor, d: Tensor, ty: Tensor) -> Tensor:
    return torch.stack([torch.stack([a, b, tx], -1), torch.stack([c, d, ty], -1)], 1)


def translate(x: Tensor, tx: Scalar, ty: Scalar) -> Tensor:
    """Translate by normalized offsets: the offset moves the sampling grid,
    so ``+tx`` samples from the right and moves the content left."""
    tx, ty = _per_image(tx, x), _per_image(ty, x)
    one, zero = torch.ones_like(tx), torch.zeros_like(tx)
    return affine_warp(x, _theta(one, zero, tx, zero, one, ty))


def rotate(x: Tensor, angle: Scalar) -> Tensor:
    """Rotate about the image center by ``angle`` radians (per image or one
    for all), in normalized coordinates as JAX's ``rotate``."""
    a = _per_image(angle, x)
    c, s, zero = torch.cos(a), torch.sin(a), torch.zeros_like(a)
    return affine_warp(x, _theta(c, -s, zero, s, c, zero))


def scale_around_center(x: Tensor, factor: Scalar) -> Tensor:
    """Zoom by ``factor`` (> 1 samples a wider window: the content shrinks)."""
    f = _per_image(factor, x)
    zero = torch.zeros_like(f)
    return affine_warp(x, _theta(f, zero, zero, zero, f, zero))


def rotate_quarter_then(x: Tensor, angle_deg: float) -> Tensor:
    """Rotation by a static angle shared by the batch, in degrees, as JAX's
    ``rotate_mm`` splits it: the nearest quarter turn exactly, as
    ``torch.rot90(k=q)`` over (H, W) (the same permutation as
    ``jnp.rot90``), then the residual of at most 45° through
    :func:`rotate`, bilinear (where JAX approximates it with three shears)."""
    a = float(angle_deg) % 360.0
    if a > 180.0:
        a -= 360.0
    q = int(round(a / 90.0))
    psi = math.radians(a - 90.0 * q)
    out = torch.rot90(x, k=q % 4, dims=(1, 2)) if q % 4 else x
    if abs(psi) < 1e-12:
        return out
    return rotate(out, psi)


def weight_matrix(in_size: int, out_size: int, scale: Scalar, translation: Scalar,
                  device=None) -> Tensor:
    """(in, out) linear-resampling weights of
    ``jax.image.scale_and_translate`` along one axis (JAX's
    ``compute_weight_mat`` with the triangle kernel and ``antialias=True``):
    output pixel o samples input coordinate ``(o + 0.5 - t) / s - 0.5``
    with a triangle ``max(1/s, 1)`` pixels wide, weights normalized over
    the input, and zero where the sample falls outside the input."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=device)
    translation = torch.as_tensor(translation, dtype=torch.float32, device=device)
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=scale.device) + 0.5)
                * inv_scale - translation * inv_scale - 0.5)
    pos = torch.arange(in_size, dtype=torch.float32, device=scale.device)
    w = torch.clamp(1 - (sample_f[None, :] - pos[:, None]).abs() / kernel_scale, min=0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * 1.1920928955078125e-07,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def scale_and_translate(x: Tensor, out_hw: Sequence[int], scale: Sequence[Scalar],
                        translation: Sequence[Scalar]) -> Tensor:
    """``jax.image.scale_and_translate(x, (B, *out_hw, C), (1, 2), scale,
    translation, method="linear")`` of an NHWC batch: input (y, x) maps to
    output ``(y·scale[0] + translation[0], x·scale[1] + translation[1])``,
    linear, antialiased when it shrinks, zero outside the input."""
    wh = weight_matrix(x.shape[1], out_hw[0], scale[0], translation[0], x.device)
    ww = weight_matrix(x.shape[2], out_hw[1], scale[1], translation[1], x.device)
    out = torch.einsum("bhwc,hp->bpwc", x, wh.to(x.dtype))
    return torch.einsum("bpwc,wq->bpqc", out, ww.to(x.dtype))
