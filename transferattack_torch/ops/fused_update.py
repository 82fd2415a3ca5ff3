"""Fused attack-update step: CUDA kernel and its plain PyTorch version.

    delta' = clip(x + clip(delta + alpha * sign(m), -eps, eps), lo, hi) - x

Counterpart of ``transferattack_tpu/ops/pallas_update.py``.  The kernel is
``csrc/fused_update.cu``; the plain version is the oracle the CPU tests and
``chip_smoke.py`` hold it against.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import load_library

_FN = None


def _kernel():
    global _FN
    if _FN is None:
        fn = load_library("fused_update").fused_sign_update_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_long] + [ctypes.c_float] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def fused_sign_update_plain(delta, momentum, x, alpha: float, eps: float,
                            lo: float = 0.0, hi: float = 1.0):
    """The update as plain torch ops, on any device."""
    return torch.clamp(x + torch.clamp(delta + alpha * torch.sign(momentum), -eps, eps),
                       lo, hi) - x


def fused_sign_update(delta, momentum, x, alpha: float, eps: float,
                      lo: float = 0.0, hi: float = 1.0):
    """Sign step + eps-ball + image-bound projection in one pass.

    CUDA tensors go through the CUDA kernel: they must be fp32, contiguous,
    of one shape and on one device, or this raises.  CPU tensors go through
    :func:`fused_sign_update_plain`.  ``fused_sign_update.launches`` counts
    kernel launches.
    """
    tensors = (delta, momentum, x)
    if all(t.device.type == "cpu" for t in tensors):
        return fused_sign_update_plain(delta, momentum, x, alpha, eps, lo, hi)
    if any(t.device != delta.device for t in tensors) or delta.device.type != "cuda":
        raise ValueError("fused_sign_update: delta, momentum and x must be on one "
                         f"CUDA device, got {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"fused_sign_update: needs float32, got {[t.dtype for t in tensors]}")
    if any(t.shape != delta.shape for t in tensors):
        raise ValueError("fused_sign_update: shapes differ: "
                         f"{[tuple(t.shape) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_sign_update: tensors must be contiguous")
    out = torch.empty_like(delta)
    with torch.cuda.device(delta.device):
        rc = _kernel()(delta.data_ptr(), momentum.data_ptr(), x.data_ptr(),
                       out.data_ptr(), delta.numel(), alpha, eps, lo, hi,
                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_sign_update: CUDA error {rc} at launch")
    fused_sign_update.launches += 1
    return out


fused_sign_update.launches = 0
