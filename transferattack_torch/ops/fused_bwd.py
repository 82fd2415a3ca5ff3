"""Fused backward-input of the ResNet bottleneck: CUDA kernels and their plain versions.

Counterpart of ``transferattack_tpu/ops/fused_bwd.py``, with its signatures
and layouts: activations are NHWC ``(B, H, W, C)`` or flattened ``(M, C)``,
forward kernels are HWIO, ``wt`` is ``(Cout, Cin)`` and ``w_col`` is
``(9·Cout, Cin)`` tap-major.  A channels_last NCHW activation permuted by
``(0, 2, 3, 1)`` is already such an NHWC tensor, so no copy is needed.

  ``fused_bwd_1x1``         dx = (g · mask) @ wt (+ skip)
  ``fused_bwd_3x3``         dx = conv3x3_same(g · mask, W′)
  ``bottleneck_bwd_input``  the backward-input chain of one bottleneck

The kernels are ``csrc/fused_bwd.cu`` (the 1×1) and ``csrc/fused_bwd_3x3.cu``
(the 3×3, a library of its own); the plain versions are the oracle the CPU
tests and ``chip_smoke.py`` hold them against.  The chain has no
BatchNorm scales, so it equals a real block's input gradient once BN is
folded into the convs (:func:`transferattack_torch.models.resnet.fold_bn`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Mapping, NamedTuple

import torch
import torch.nn.functional as F

from ._build import load_library

# the 3×3 kernel's shared memory (csrc/fused_bwd_3x3.cu): a halo of
# BM + 2·W + 2 rows of 144 bytes (64 bf16 channels padded to 72) and one zero
# row, then a ring of two 64 × 64 weight tiles in the same rows; the fp32
# epilogue tile (BM × 68 floats) reuses it
_BM = 256
_ROW_BYTES = 144
_RING_BYTES = 2 * 64 * _ROW_BYTES
_EPILOGUE_BYTES = _BM * 68 * 4
SMEM_PER_BLOCK = 232_448  # the most a block can have on an H100
BWD_3X3_MAX_W = 613       # the widest image whose halo fits

# the 1×1 kernel's tiles and ring (csrc/fused_bwd.cu): 128 pixels × BN
# output channels a tile, 64 reduction channels a step, and a ring of as many
# stages as fit in 200 KB
_1X1_BM, _1X1_BK = 128, 64
_1X1_STAGE_BUDGET = 200 * 1024


class Plan1x1(NamedTuple):
    bn: int           # output channels a tile: 64 when cin ≤ 64, else 128
    stage_bytes: int  # g, mask, the weight chunk and, with a skip, the skip tile
    stages: int       # the cp.async ring's depth
    smem: int         # dynamic shared memory a block
    tiles: int        # 128-pixel × BN tiles; the grid is min(tiles, SMs)


def plan_1x1(m: int, cout: int, cin: int, skip: bool) -> Plan1x1:
    """The 1×1 kernel's tiling for ``(m, cout) @ (cout, cin)`` with or
    without a skip, as ``csrc/fused_bwd.cu`` pins it: a stage holds the g
    and mask chunks (128 rows of 144 bytes each), the weight chunk (64 rows
    of BN + 8 channels) and, with a skip, the 128 × BN skip tile; the ring
    has ``⌊200 KB / stage⌋`` stages, at least 2.  At the chain's shapes:
    4 stages of 46,080 bytes for 256 → 64, 2 of 87,040 for 64 → 256 with
    the skip.  ``cout`` only has to be a positive multiple of 16."""
    if cout <= 0 or cout % 16 or cin <= 0 or cin % 16:
        raise ValueError(f"plan_1x1: channel counts must be multiples of 16, got "
                         f"{cout}, {cin}")
    bn = 64 if cin <= 64 else 128
    stage = (2 * _1X1_BM * (_1X1_BK + 8) * 2 + _1X1_BK * (bn + 8) * 2
             + (_1X1_BM * bn * 2 if skip else 0))
    stages = max(2, _1X1_STAGE_BUDGET // stage)
    tiles = -(-m // _1X1_BM) * -(-cin // bn)
    return Plan1x1(bn, stage, stages, stages * stage, tiles)


@functools.cache
def _lib_1x1():
    lib = load_library("fused_bwd")
    lib.fused_bwd_1x1_bf16.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.fused_bwd_1x1_bf16.restype = ctypes.c_int
    return lib


@functools.cache
def _lib_3x3():
    lib = load_library("fused_bwd_3x3")
    lib.fused_bwd_3x3_bf16.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.fused_bwd_3x3_bf16.restype = ctypes.c_int
    return lib


def smem_3x3(w: int) -> int:
    """Bytes of dynamic shared memory one block of the 3×3 kernel needs for
    images ``w`` pixels wide: ``max((256 + 2·w + 3)·144 + 18,432, 69,632)``,
    71,856 at w = 56.  Raises ``ValueError`` above the 232,448 bytes a block
    can have, which is for w > 613."""
    need = max((_BM + 2 * w + 3) * _ROW_BYTES + _RING_BYTES, _EPILOGUE_BYTES)
    if need > SMEM_PER_BLOCK:
        raise ValueError(
            f"fused_bwd_3x3: an image {w} pixels wide needs {need} bytes of shared "
            f"memory for its halo, more than the {SMEM_PER_BLOCK} a block can have "
            f"(W <= {BWD_3X3_MAX_W})")
    return need


def flip_3x3_for_bwd(w):
    """(3, 3, Cin, Cout) forward kernel → (9·Cout, Cin) backward kernel:
    spatial flip and channel transpose, tap-major rows."""
    return w.flip(0, 1).permute(0, 1, 3, 2).reshape(9 * w.shape[3], w.shape[2])


# ---------------------------------------------------------------------------
# plain versions (counterparts of jnp_bwd_1x1, jnp_bwd_3x3 and
# bottleneck_bwd_input_jnp)
# ---------------------------------------------------------------------------

def fused_bwd_1x1_plain(g, mask, wt, skip=None, *, return_gm=False):
    """(g · mask) @ wt (+ skip) in torch ops.  ``addmm`` hands the skip to the
    GEMM as its C operand, so on the card cuBLAS adds it to the fp32
    accumulator before the one rounding to ``g.dtype``, as JAX does.  With
    ``return_gm``, ``(out, g · mask)``, as :func:`fused_bwd_1x1`."""
    gm = g * mask
    out = gm @ wt if skip is None else torch.addmm(skip, gm, wt)
    return (out, gm) if return_gm else out


def fused_bwd_3x3_plain(g, mask, w_col):
    """conv3x3_same(g · mask, W′) as one convolution with the flipped kernel."""
    cout, cin = g.shape[-1], w_col.shape[1]
    weight = w_col.reshape(3, 3, cout, cin).permute(3, 2, 0, 1)  # OIHW
    out = F.conv2d((g * mask).permute(0, 3, 1, 2), weight, padding=1)
    return out.permute(0, 2, 3, 1).contiguous()


def bottleneck_bwd_input_plain(g, masks: Mapping, weights: Mapping):
    """Backward-input chain of one bottleneck in torch ops.

    g: (B, H, W, C4) gradient at the block output; masks: ``out`` (C4),
    ``c2`` and ``c1`` (C) ReLU masks, NHWC; weights: ``w1`` (1, 1, C4, C),
    ``w2`` (3, 3, C, C) and ``w3`` (1, 1, C, C4) forward HWIO kernels.
    """
    b, h, w, _ = g.shape
    flat = (g * masks["out"]).reshape(b * h * w, -1)
    d2 = (flat @ weights["w3"][0, 0].T).reshape(b, h, w, -1)
    d1 = fused_bwd_3x3_plain(d2, masks["c2"], flip_3x3_for_bwd(weights["w2"]))
    dx = fused_bwd_1x1_plain(d1.reshape(b * h * w, -1),
                             masks["c1"].reshape(b * h * w, -1),
                             weights["w1"][0, 0].T, skip=flat)
    return dx.reshape(b, h, w, -1)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def _on_cpu(tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check_cuda(name: str, tensors, channels) -> None:
    """Raise ``ValueError`` for what the kernels do not take."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors must be on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError(f"{name}: needs bfloat16 on the card, got "
                         f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: tensors must start on a 16-byte boundary")
    if any(c <= 0 or c % 16 for c in channels):
        raise ValueError(f"{name}: channel counts must be multiples of 16, got "
                         f"{list(channels)}")


def fused_bwd_1x1(g, mask, wt, skip=None, *, return_gm=False):
    """(g · mask) @ wt (+ skip) in one pass: g, mask (M, Cout); wt (Cout, Cin);
    skip, optional, (M, Cin).  Any M.  With ``return_gm``, ``(out, g · mask)``:
    the kernel writes the masked gradient it stages anyway as a second
    output, bit for bit ``g * mask``.  JAX's ``fused_bwd_1x1`` has no such
    output; :func:`bottleneck_bwd_input` takes it as the chain's skip.

    CUDA tensors go through the CUDA kernel (:func:`plan_1x1`): bf16,
    contiguous, 16-byte aligned, channel counts multiples of 16, or this
    raises ``ValueError``.  CPU tensors go through
    :func:`fused_bwd_1x1_plain`.  ``fused_bwd_1x1.launches`` counts kernel
    launches, one a call.
    """
    tensors = [g, mask, wt] + ([] if skip is None else [skip])
    if _on_cpu(tensors):
        return fused_bwd_1x1_plain(g, mask, wt, skip, return_gm=return_gm)
    if (g.dim() != 2 or wt.dim() != 2 or mask.shape != g.shape or wt.shape[0] != g.shape[1]
            or (skip is not None and skip.shape != (g.shape[0], wt.shape[1]))):
        raise ValueError("fused_bwd_1x1: shapes do not fit: "
                         f"{[tuple(t.shape) for t in tensors]}")
    _check_cuda("fused_bwd_1x1", tensors, wt.shape)
    m, cout = g.shape
    cin = wt.shape[1]
    out = torch.empty((m, cin), dtype=g.dtype, device=g.device)
    gm = torch.empty_like(g) if return_gm else None
    if m > 0:
        with torch.cuda.device(g.device):
            rc = _lib_1x1().fused_bwd_1x1_bf16(
                g.data_ptr(), mask.data_ptr(), wt.data_ptr(),
                None if skip is None else skip.data_ptr(),
                None if gm is None else gm.data_ptr(), out.data_ptr(), m, cout, cin,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fused_bwd_1x1: CUDA error {rc} at launch")
        fused_bwd_1x1.launches += 1
    return (out, gm) if return_gm else out


fused_bwd_1x1.launches = 0


def fused_bwd_3x3(g, mask, w_col):
    """conv3x3_same(g · mask, W′), the backward-input of a SAME 3×3
    stride-1 conv: g, mask (B, H, W, Cout); w_col (9·Cout, Cin) from
    :func:`flip_3x3_for_bwd`.  Any B and H; W up to 613.

    CUDA tensors go through the CUDA kernel (``g · mask`` staged once per
    block as a halo tile in shared memory, the nine taps read from there: no
    im2col and no padded copy in device memory) under the conditions of
    :func:`fused_bwd_1x1`, and raise ``ValueError`` for an image wider than
    613 pixels, whose halo does not fit (:func:`smem_3x3`).  CPU tensors go
    through :func:`fused_bwd_3x3_plain`.  ``fused_bwd_3x3.launches`` counts
    kernel launches.
    """
    tensors = [g, mask, w_col]
    if _on_cpu(tensors):
        return fused_bwd_3x3_plain(g, mask, w_col)
    if (g.dim() != 4 or w_col.dim() != 2 or mask.shape != g.shape
            or w_col.shape[0] != 9 * g.shape[3]):
        raise ValueError("fused_bwd_3x3: shapes do not fit: "
                         f"{[tuple(t.shape) for t in tensors]}")
    _check_cuda("fused_bwd_3x3", tensors, (g.shape[3], w_col.shape[1]))
    smem_3x3(g.shape[2])  # raises for an image too wide for the halo
    b, h, w, cout = g.shape
    cin = w_col.shape[1]
    out = torch.empty((b, h, w, cin), dtype=g.dtype, device=g.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(g.device):
        rc = _lib_3x3().fused_bwd_3x3_bf16(
            g.data_ptr(), mask.data_ptr(), w_col.data_ptr(), out.data_ptr(),
            b, h, w, cout, cin, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_bwd_3x3: CUDA error {rc} at launch")
    fused_bwd_3x3.launches += 1
    return out


fused_bwd_3x3.launches = 0


def bottleneck_bwd_input(g, masks: Mapping, weights: Mapping):
    """The chain of :func:`bottleneck_bwd_input_plain` in three launches and
    no pass of its own over the activations: 1×1ᵀ with the output mask, which
    also writes ``g · mask_out``; 3×3ᵀ with the ``c2`` mask; and 1×1ᵀ with the
    ``c1`` mask plus that ``g · mask_out`` as the skip (JAX computes it
    outside its kernels).  CPU tensors take the plain chain."""
    if _on_cpu([g, *masks.values(), *weights.values()]):
        return bottleneck_bwd_input_plain(g, masks, weights)
    if not all(t.is_contiguous() for t in (g, *masks.values())):
        raise ValueError("bottleneck_bwd_input: g and the masks must be contiguous")
    b, h, w, c4 = g.shape
    m = b * h * w
    flat_g = g.view(m, c4)
    mask_out = masks["out"].view(m, c4)
    d2, gm_out = fused_bwd_1x1(flat_g, mask_out, weights["w3"][0, 0].T.contiguous(),
                               return_gm=True)
    d1 = fused_bwd_3x3(d2.view(b, h, w, -1), masks["c2"], flip_3x3_for_bwd(weights["w2"]))
    dx = fused_bwd_1x1(d1.view(m, -1), masks["c1"].view(m, -1),
                       weights["w1"][0, 0].T.contiguous(), skip=gm_out)
    return dx.view(b, h, w, -1)
