"""AT and HGD (counterpart of ``transferattack_tpu/defense/at.py``; the
reference's ``defense/at/main_fast.py`` evaluate mode and
``defense/hgd/defense.py``).

AT classifies the adversarial PNGs with a 4px-adversarially-trained
ResNet-50 (``at_resnet50_4px.npz``) and writes a prediction CSV.

HGD puts a high-level-guided denoiser (``DUNet``) in front of each
classifier of the reference's four-net ensemble and sums their logits.
Each member's npz holds a ``denoise/`` and a ``classifier/`` subtree in the
JAX package's flat layout (:func:`convert_hgd` writes one from an official
``denoise_*.ckpt``).  A missing member is warned about, recorded as its
checkpoint name, and runs on a seeded denoiser (``init_weights`` from a torch
generator seeded 5) and the classifier's seeded init.

Everything runs in fp32 under ``torch.inference_mode`` on the card unless
``device="cpu"``.
"""
from __future__ import annotations

import os
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models import (Surrogate, aux_path, init_weights, load_npz, make_model, nhwc,
                      record_fallback, resolve_device, weights_root)
from ..ops.image import resize
from ..utils.bridge import load_flat_variables, state_dict_to_flat
from .scoring import classify_dir


def run_at(input_dir: str, output_dir: str, batchsize: int = 16,
           model_name: str = "resnet50", ckpt: str = "at_resnet50_4px",
           out_csv: str = "at_predictions.csv", device="cuda") -> str:
    """Classify with the fast-AT classifier (``main_fast.py:141``); returns
    the CSV's path."""
    dev = resolve_device(device)
    surrogate = make_model(model_name, device=dev)
    path = aux_path(ckpt)
    if path is not None:
        load_flat_variables(surrogate.module, load_npz(path))
    else:
        record_fallback(ckpt)
        warnings.warn(f"AT: {ckpt}.npz not found under {weights_root()}; base weights used.")
    return classify_dir(lambda x: surrogate.apply(x).argmax(-1), input_dir, output_dir,
                        batchsize, out_csv, dev)


class HGDConvBlock(nn.Module):
    """``defense/hgd/resnet.py:6-17`` Conv: a 3×3 conv without bias, BN, ReLU."""

    def __init__(self, n_in: int, n_out: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(n_in, n_out, 3, stride, 1, bias=False)
        self.bn = nn.BatchNorm2d(n_out)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


FWD_OUT, NUM_FWD = (64, 128, 256, 256, 256), (2, 3, 3, 3, 3)
BACK_OUT, NUM_BACK = (64, 128, 256, 256), (2, 3, 3, 3)


class DUNet(nn.Module):
    """HGD's DUNET (``defense/hgd/resnet.py:57-123`` ``Denoise`` with
    ``block=Conv``, the configuration of every shipped checkpoint), NCHW.

    A five-level conv encoder (each level after the first starts with a
    stride-2 block); a decoder that runs from the deepest skip up, resizing
    ``out`` bilinearly to the skip's side (as ``jax.image.resize``; at 299²
    the sides are 299, 150, 75, 38, 19, so an enlargement is not exactly
    2×), concatenating ``[out, skip]`` and running its blocks; then a 1×1
    ``final`` conv to 3 channels, plus the input.  The modules are named as
    the reference's (``fwd.i.j.conv``/``.bn``, ``back.i.j``, ``final``), so
    an official ``net.denoise.0.*`` state dict loads with
    ``load_state_dict`` and JAX's ``fwd_{i}_{j}``/``back_{i}_{j}`` through the
    weights bridge.
    """

    def __init__(self):
        super().__init__()
        fwd, n_in = [], 3
        for i, (width, n) in enumerate(zip(FWD_OUT, NUM_FWD)):
            fwd.append(nn.Sequential(*[
                HGDConvBlock(n_in if j == 0 else width, width, 2 if (j == 0 and i > 0) else 1)
                for j in range(n)]))
            n_in = width
        self.fwd = nn.ModuleList(fwd)
        back = []
        for i, (width, n) in enumerate(zip(BACK_OUT, NUM_BACK)):
            below = BACK_OUT[i + 1] if i + 1 < len(BACK_OUT) else FWD_OUT[-1]
            back.append(nn.Sequential(*[
                HGDConvBlock(below + FWD_OUT[i] if j == 0 else width, width) for j in range(n)]))
        self.back = nn.ModuleList(back)
        self.final = nn.Conv2d(BACK_OUT[0], 3, 1, bias=False)

    def forward(self, x):
        out, skips = x, []
        for i, level in enumerate(self.fwd):
            out = level(out)
            if i != len(self.fwd) - 1:
                skips.append(out)
        for i in reversed(range(len(self.back))):
            skip = skips[i]
            up = resize(out.permute(0, 2, 3, 1), skip.shape[2], skip.shape[3])
            out = self.back[i](torch.cat([up.permute(0, 3, 1, 2), skip], 1))
        return self.final(out) + x


# the reference's four denoiser + classifier pairs (``defense/hgd/defense.py:
# 88-145``), each denoising in pixel space and classifying at 299²; their
# logits are summed, then argmax'd (the TF labels' +1 is the scorer's START=1)
HGD_ENSEMBLE = (
    ("hgd_resnet152", "resnet152"),                      # denoise_res_015.ckpt
    ("hgd_inception_resnet_v2", "inception_resnet_v2"),  # denoise_inres_014.ckpt
    ("hgd_inception_v3", "inception_v3"),                # denoise_incepv3_012.ckpt
    ("hgd_resnext101_32x4d", "resnext101_32x4d"),        # denoise_rex_001.ckpt
)


def _load_hgd_member(ckpt_name: str, model_name: str,
                     device="cuda") -> Tuple[DUNet, Surrogate, bool]:
    """(denoiser, classifier, fallback) of one member, from
    ``<ckpt_name>.npz``'s ``denoise/`` and ``classifier/`` subtrees, or the
    seeded fallback.  The official four classify at 299², others at their
    own size."""
    dev = resolve_device(device)
    official = {m for _, m in HGD_ENSEMBLE}
    surrogate = make_model(model_name, pretrained=False,
                           input_size=299 if model_name in official else None, device=dev)
    denoiser = DUNet()
    path = aux_path(ckpt_name)
    if path is not None:
        flat = load_npz(path)
        for prefix, module in (("denoise/", denoiser), ("classifier/", surrogate.module)):
            load_flat_variables(module, {k[len(prefix):]: v for k, v in flat.items()
                                         if k.startswith(prefix)})
    else:
        record_fallback(ckpt_name)
        warnings.warn(f"HGD: {ckpt_name}.npz not found under {weights_root()}; random init.")
        init_weights(denoiser, torch.Generator().manual_seed(5))
    denoiser = denoiser.eval().requires_grad_(False).to(dev, memory_format=torch.channels_last)
    return denoiser, surrogate, path is None


def hgd_logits(members: Sequence[Tuple[DUNet, Surrogate, bool]], x: torch.Tensor):
    """The members' logits of NHWC ``x``, each on its own denoised copy, summed."""
    logits = 0.0
    for denoiser, surrogate, _ in members:
        logits = logits + surrogate.apply(nhwc(denoiser, x))
    return logits


def run_hgd(input_dir: str, output_dir: str, batchsize: int = 16,
            model_name: Optional[str] = None, ckpt: Optional[str] = None,
            out_csv: str = "hgd_predictions.csv", ensemble: Optional[Sequence[str]] = None,
            device="cuda") -> str:
    """Denoise, then classify, with the reference's four-net ensemble by
    default (``defense/hgd/defense.py:132-147``); ``model_name`` (and
    ``ckpt``) runs one member, ``ensemble`` the members ``hgd_<name>``.
    Returns the CSV's path."""
    dev = resolve_device(device)
    if model_name is not None:
        members = [(ckpt or f"hgd_{model_name}", model_name)]
    elif ensemble is not None:
        members = [(f"hgd_{n}", n) for n in ensemble]
    else:
        members = list(HGD_ENSEMBLE)
    loaded = [_load_hgd_member(c, m, dev) for c, m in members]
    return classify_dir(lambda x: hgd_logits(loaded, x).argmax(-1), input_dir, output_dir,
                        batchsize, out_csv, dev)


def _fill(module: nn.Module, state) -> Tuple[List[str], List[str]]:
    """Copy the entries of ``state`` that fit ``module``'s state dict into it;
    (missing keys, mismatched keys with their shapes), as JAX's
    ``reconcile_with_module`` reports them.  An entry the module lacks is
    ignored; a missing or mismatched one keeps the module's init."""
    target = {k: v for k, v in module.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    missing = [k for k in target if k not in state]
    mismatched = [f"{k}: ckpt{tuple(state[k].shape)} vs model{tuple(v.shape)}"
                  for k, v in target.items() if k in state and state[k].shape != v.shape]
    with torch.no_grad():
        for k, v in target.items():
            if k in state and state[k].shape == v.shape:
                v.copy_(torch.as_tensor(state[k]))
    return missing, mismatched


def convert_hgd(ckpt_path: str, model_name: str, out_name: Optional[str] = None,
                out_dir: Optional[str] = None) -> str:
    """An official HGD checkpoint (``denoise_*.ckpt``: a ``Net`` state dict
    with ``net.denoise.0.*`` denoiser keys and other ``net.*`` classifier
    keys, maybe behind ``module.``) as one npz in the JAX package's layout,
    ``denoise/`` and ``classifier/``, at ``<out_dir>/<out_name>.npz``
    (default: the weights root, ``hgd_<model_name>``).  Missing and
    mismatched keys are printed.  Returns the path."""
    state = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    den_state, cls_state = {}, {}
    for k, v in state.items():
        k2 = k[len("module."):] if k.startswith("module.") else k
        if k2.startswith("net.denoise.0."):
            den_state[k2[len("net.denoise.0."):]] = v
        elif k2.startswith("net.") and not k2.startswith("net.denoise"):
            cls_state[k2[len("net."):]] = v
    denoiser = DUNet()
    surrogate = make_model(model_name, pretrained=False, input_size=299, device="cpu")
    for module, sub, tag in ((denoiser, den_state, "denoiser"),
                             (surrogate.module.backbone, cls_state, "classifier")):
        missing, mismatched = _fill(module, sub)
        if missing or mismatched:
            print(f"[convert_hgd] {tag}: {len(missing)} missing, {len(mismatched)} mismatched")
            for m in (missing + mismatched)[:10]:
                print("  ", m)
    flat = {f"{name}/{k}": v for name, module in (("denoise", denoiser),
                                                   ("classifier", surrogate.module))
            for k, v in state_dict_to_flat(module).items()}
    path = os.path.join(out_dir or weights_root(), f"{out_name or f'hgd_{model_name}'}.npz")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)  # as JAX saves a dict of variables trees
    return path
