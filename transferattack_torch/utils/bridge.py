"""Weights bridge: the JAX package's flat variables into this package's modules.

``transferattack_tpu.models.save_npz_variables`` writes a Flax variables tree
as a flat dict ``{"params/backbone/layer1_0/conv1/kernel": array, ...}``.
This module inverts the rules of ``transferattack_tpu/utils/convert.py``
(PyTorch ``state_dict`` → Flax), so the same dict loads into the port:

* a 4-D ``kernel`` (HWIO) becomes ``weight`` (OIHW); a 2-D ``kernel``
  (I, O) becomes ``weight`` (O, I); ``bias`` passes through;
* BatchNorm ``scale``/``bias`` become ``weight``/``bias``, and
  ``batch_stats/.../mean``/``var`` become ``running_mean``/``running_var``;
* ``layerN_j`` becomes ``layerN.j``, ``downsample_conv`` becomes
  ``downsample.0`` and ``downsample_bn`` becomes ``downsample.1``.

The port's module names are torchvision's, so a real ``.pth`` state_dict
loads with ``load_state_dict`` and needs no bridge.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}
_BLOCK = re.compile(r"(layer\d+)_(\d+)")


def torch_key(jax_key: str) -> str:
    """``params/backbone/layer1_0/downsample_bn/scale`` →
    ``backbone.layer1.0.downsample.1.weight``."""
    collection, *path, leaf = jax_key.split("/")
    leaves = {"params": _PARAM_LEAVES, "batch_stats": _STAT_LEAVES}.get(collection)
    if leaves is None or leaf not in leaves:
        raise ValueError(f"no bridge rule for JAX variable {jax_key!r}")
    parts = []
    for p in path:
        block = _BLOCK.fullmatch(p)
        if block:
            parts += [block.group(1), block.group(2)]
        elif p == "downsample_conv":
            parts += ["downsample", "0"]
        elif p == "downsample_bn":
            parts += ["downsample", "1"]
        else:
            parts.append(p)
    return ".".join(parts + [leaves[leaf]])


def torch_layout(jax_key: str, value: np.ndarray) -> np.ndarray:
    """Transpose a JAX kernel into PyTorch's weight layout."""
    if jax_key.endswith("/kernel"):
        if value.ndim == 4:
            return value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        if value.ndim == 2:
            return value.T  # (I, O) -> (O, I)
    return value


def flat_to_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Map every JAX variable to its ``state_dict`` key and layout."""
    out: Dict[str, np.ndarray] = {}
    for k, v in flat.items():
        tk = torch_key(k)
        if tk in out:
            raise ValueError(f"two JAX variables map to {tk!r}")
        out[tk] = np.ascontiguousarray(torch_layout(k, np.asarray(v)))
    return out


def load_flat_variables(module: torch.nn.Module,
                        flat: Mapping[str, np.ndarray]) -> None:
    """Fill every parameter and buffer of ``module`` from ``flat``, strictly.

    Raises ``ValueError`` when a key of ``flat`` is unused, when a parameter
    or buffer is left unfilled, or when a shape differs.  BatchNorm's
    ``num_batches_tracked`` counter has no JAX counterpart and is only read
    in training mode, so it is not required.
    """
    sd = flat_to_state_dict(flat)
    target = {k: v for k, v in module.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    missing = sorted(set(target) - set(sd))
    extra = sorted(set(sd) - set(target))
    wrong = [f"{k}: {tuple(sd[k].shape)} vs {tuple(target[k].shape)}"
             for k in sorted(set(sd) & set(target))
             if tuple(sd[k].shape) != tuple(target[k].shape)]
    if missing or extra or wrong:
        raise ValueError(
            f"weights do not fit {type(module).__name__}: "
            f"missing {missing[:5]} ({len(missing)}), unused {extra[:5]} "
            f"({len(extra)}), wrong shape {wrong[:5]} ({len(wrong)})")
    with torch.no_grad():
        for k, v in sd.items():
            target[k].copy_(torch.tensor(v))
