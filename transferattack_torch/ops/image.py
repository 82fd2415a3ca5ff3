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
it shrinks (JAX's ``antialias=True``), applied as two products; the scale
may be one per image.  :func:`resize` is ``jax.image.resize(...,
"bilinear")`` on it (DiffAttack's SD backend, HGD's DUNet, DiffPure's runner).

IDAA's displacement fields (:func:`homography_field`, :func:`tps_field`,
:func:`fisheye_field`, :func:`gaussian_blur_sep` of a noise field) are
JAX's, and :func:`warp_field` samples any such field exactly, bilinear with
zero padding, where JAX resamples it in two separable 1-D passes with its
displacement clamped (``warp_field_sep``).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Union

import numpy as np
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
                  device=None, inv_scale: Optional[float] = None) -> Tensor:
    """(in, out) linear-resampling weights of
    ``jax.image.scale_and_translate`` along one axis (JAX's
    ``compute_weight_mat`` with the triangle kernel and ``antialias=True``):
    output pixel o samples input coordinate ``(o + 0.5 - t) / s - 0.5``
    with a triangle ``max(1/s, 1)`` pixels wide, weights normalized over
    the input, and zero where the sample falls outside the input.  A
    ``scale`` and ``translation`` of shape (B,) give (B, in, out).  ``1/s``
    is taken in fp32, as ``scale_and_translate`` takes it, unless
    ``inv_scale`` gives it (``jax.image.resize`` divides in float64)."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=device)
    translation = torch.as_tensor(translation, dtype=torch.float32, device=device)
    inv_scale = (1.0 / scale if inv_scale is None
                 else torch.as_tensor(inv_scale, dtype=torch.float32, device=scale.device))
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=scale.device) + 0.5)
                * inv_scale[..., None] - (translation * inv_scale)[..., None] - 0.5)
    pos = torch.arange(in_size, dtype=torch.float32, device=scale.device)
    w = torch.clamp(1 - (sample_f[..., None, :] - pos[:, None]).abs()
                    / kernel_scale[..., None, None], min=0)
    total = w.sum(-2, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * 1.1920928955078125e-07,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[..., None, :], w, torch.zeros_like(w))


def scale_and_translate(x: Tensor, out_hw: Sequence[int], scale: Sequence[Scalar],
                        translation: Sequence[Scalar]) -> Tensor:
    """``jax.image.scale_and_translate(x, (B, *out_hw, C), (1, 2), scale,
    translation, method="linear")`` of an NHWC batch: input (y, x) maps to
    output ``(y·scale[0] + translation[0], x·scale[1] + translation[1])``,
    linear, antialiased when it shrinks, zero outside the input.  Each
    scale and translation is one for the batch, or (B,): one an image (JAX's
    ``vmap`` of it)."""
    wh = weight_matrix(x.shape[1], out_hw[0], scale[0], translation[0], x.device)
    ww = weight_matrix(x.shape[2], out_hw[1], scale[1], translation[1], x.device)
    return _resample(x, wh, ww)


def _resample(x: Tensor, wh: Tensor, ww: Tensor) -> Tensor:
    out = torch.einsum("bhwc,hp->bpwc" if wh.ndim == 2 else "bhwc,bhp->bpwc", x, wh.to(x.dtype))
    return torch.einsum("bpwc,wq->bpqc" if ww.ndim == 2 else "bpwc,bwq->bpqc", out,
                        ww.to(x.dtype))


def resize(x: Tensor, height: int, width: int) -> Tensor:
    """``jax.image.resize(x, (B, height, width, C), "bilinear")`` of NHWC
    ``x``: antialiased when it shrinks, the scale's inverse taken in
    float64 and rounded once, as JAX takes it."""
    wh, ww = (weight_matrix(n, m, m / n, 0.0, x.device, inv_scale=1.0 / (m / n))
              for n, m in ((x.shape[1], height), (x.shape[2], width)))
    return _resample(x, wh, ww)


# ---------------------------------------------------------------------------
# displacement fields and their exact warp
# ---------------------------------------------------------------------------

def norm_grid(H: int, W: int, dtype=torch.float32, device=None):
    """(gy, gx), each (H, W): the ``align_corners=False`` normalized pixel
    centers."""
    ys = (2.0 * torch.arange(H, dtype=dtype, device=device) + 1.0) / H - 1.0
    xs = (2.0 * torch.arange(W, dtype=dtype, device=device) + 1.0) / W - 1.0
    return torch.meshgrid(ys, xs, indexing="ij")


def warp_field(x: Tensor, dx: Tensor, dy: Tensor) -> Tensor:
    """Sample NHWC ``x`` at ``p + d(p)``: ``dx``/``dy`` (B, H, W) source
    displacements in pixels (grid_sample's orientation), bilinear, zero
    outside the image."""
    H, W = x.shape[1], x.shape[2]
    gy, gx = norm_grid(H, W, device=x.device)
    grid = torch.stack([gx + dx.float() * (2.0 / W), gy + dy.float() * (2.0 / H)], -1)
    return grid_sample(x, grid)


# the output corners, in the order the homography's corners take
CORNERS = ((-1.0, -1.0), (1.0, -1.0), (1.0, 1.0), (-1.0, 1.0))


def homography_field(src_corners: Tensor, H: int, W: int, dst_corners: Tensor = None):
    """(dx, dy) in pixels of the homography T with ``T(dst_i) = src_i``
    on the output grid; corners (B, 4, 2) normalized (x, y) in the order
    (-1,-1), (1,-1), (1,1), (-1,1), ``dst`` the output corners by default.
    The 8×8 DLT systems are solved as one batched ``torch.linalg.solve``."""
    src = src_corners.float()
    B = src.shape[0]
    if dst_corners is None:
        dst_corners = torch.tensor(CORNERS, device=src.device).expand(B, 4, 2)
    dst = dst_corners.float()
    x, y, u, v = dst[..., 0], dst[..., 1], src[..., 0], src[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y], -1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y], -1)
    A = torch.stack([r1, r2], 2).reshape(B, 8, 8)
    h = torch.linalg.solve(A, torch.stack([u, v], -1).reshape(B, 8))
    Hm = torch.cat([h, torch.ones_like(h[:, :1])], 1).reshape(B, 3, 3)
    gy, gx = norm_grid(H, W, device=src.device)
    pts = torch.stack([gx, gy, torch.ones_like(gx)], -1)
    proj = torch.einsum("bij,hwj->bhwi", Hm, pts)
    sx, sy = proj[..., 0] / proj[..., 2], proj[..., 1] / proj[..., 2]
    return (sx - gx) * (W / 2.0), (sy - gy) * (H / 2.0)


@functools.lru_cache(maxsize=4)
def _tps_system(grid_n: int):
    """(control points (n, 2), inverse of the TPS system (n+3, n+3)), built
    in numpy fp32 as JAX builds its static constant."""
    n = grid_n * grid_n
    lin = np.linspace(-1.0, 1.0, grid_n, dtype=np.float32)
    cy, cx = np.meshgrid(lin, lin, indexing="ij")
    ctrl = np.stack([cx.ravel(), cy.ravel()], -1)
    d2 = ((ctrl[:, None, :] - ctrl[None, :, :]) ** 2).sum(-1)
    P = np.concatenate([np.ones((n, 1), np.float32), ctrl], 1)
    L = np.zeros((n + 3, n + 3), np.float32)
    L[:n, :n] = d2 * np.log(d2 + 1e-9)
    L[:n, n:] = P
    L[n:, :n] = P.T
    return ctrl, np.linalg.inv(L)


def tps_field(offsets: Tensor, H: int, W: int, grid_n: int = 3):
    """(dx, dy) in pixels of the thin-plate spline (U(r) = r²·log r²)
    through a ``grid_n × grid_n`` control grid on [-1, 1]² displaced by
    ``offsets`` (B, grid_n², 2) normalized."""
    dev = offsets.device
    ctrl, linv = _tps_system(grid_n)
    ctrl, linv = torch.from_numpy(ctrl).to(dev), torch.from_numpy(linv).to(dev)
    gy, gx = norm_grid(H, W, device=dev)
    pts = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)
    r2 = ((pts[:, None, :] - ctrl[None]) ** 2).sum(-1)
    basis = torch.cat([r2 * torch.log(r2 + 1e-9), torch.ones_like(pts[:, :1]), pts], 1)
    B = offsets.shape[0]
    rhs = torch.cat([offsets.float(), torch.zeros(B, 3, 2, device=dev)], 1)
    wa = torch.einsum("ij,bjk->bik", linv, rhs)
    f = torch.einsum("pj,bjk->bpk", basis, wa).reshape(B, H, W, 2)
    return f[..., 0] * (W / 2.0), f[..., 1] * (H / 2.0)


def fisheye_field(cx: Tensor, cy: Tensor, g: Tensor, H: int, W: int):
    """(dx, dy) in pixels of kornia's fisheye ``src = p + (p − c)·γ·r²``
    on the normalized grid; ``cx``, ``cy``, ``g`` one an image (B,)."""
    cx, cy, g = (t.float().reshape(-1, 1, 1) for t in (cx, cy, g))
    gy, gx = norm_grid(H, W, device=cx.device)
    rx, ry = gx[None] - cx, gy[None] - cy
    r2 = rx * rx + ry * ry
    return rx * g * r2 * (W / 2.0), ry * g * r2 * (H / 2.0)


def gaussian_blur_sep(field: Tensor, kernel_size: int, sigma_x: float,
                      sigma_y: float) -> Tensor:
    """A (B, H, W, C) field blurred by a separable gaussian (along W at
    ``sigma_x``, then along H at ``sigma_y``): two depthwise convolutions,
    zero "same" padding, in fp32."""
    def kern(sig):
        t = torch.arange(kernel_size, dtype=torch.float32, device=field.device) \
            - (kernel_size - 1) / 2.0
        k = torch.exp(-0.5 * (t / sig) ** 2)
        return k / k.sum()

    C, half = field.shape[-1], kernel_size // 2
    out = field.float().permute(0, 3, 1, 2)
    kx = kern(sigma_x).reshape(1, 1, 1, kernel_size).expand(C, 1, 1, kernel_size)
    out = F.conv2d(out, kx, padding=(0, half), groups=C)
    ky = kern(sigma_y).reshape(1, 1, kernel_size, 1).expand(C, 1, kernel_size, 1)
    out = F.conv2d(out, ky, padding=(half, 0), groups=C)
    return out.permute(0, 2, 3, 1)
