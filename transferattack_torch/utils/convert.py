"""Reference PyTorch checkpoints → ``$TA_TPU_WEIGHTS_DIR/<name>.npz``
(counterpart of the JAX package's ``utils/convert.py``).

The reference pulls pretrained surrogates from torchvision/timm at runtime;
here the user supplies ``<name>.pth`` (a ``state_dict``) and this module
writes the npz that ``models.make_model`` and the attacks read, in the JAX
package's flat layout (``params/backbone/layer1_0/conv1/kernel``), so that
the same file serves both packages.  It runs on the machine with the card:
PyTorch and numpy only.

The steps of JAX's converter, with the same rules (kept here as a copy):

* read the ``.pth`` with ``torch.load(weights_only=True)``, unwrap a
  ``state_dict`` or ``model`` entry and the ``module.attacker.model.``,
  ``module.model.`` and ``module.`` prefixes;
* name every tensor as JAX's converter does (:func:`torch_state_dict_to_flat`:
  list indices merged into their parent, the rewrites of ``_REWRITES`` that
  align torchvision's, timm's, the generators', AGS's ``f.N`` trunk,
  diffusers' and HF CLIP's trees with the model files' names, BatchNorm
  statistics under ``batch_stats``), in JAX's layout;
* reconcile that dict with the port's own module as JAX reconciles it with
  its module's variables (:func:`reconcile`: a variable the checkpoint lacks
  keeps the module's init, a wrong shape is reported and keeps it too, an
  extra key is dropped; both counts printed);
* load the result into the module through the weights bridge, and write the
  module with :func:`~transferattack_torch.utils.bridge.save_flat_variables`.

CLI::

    python -m transferattack_torch.utils.convert <name> <state_dict.pth>
    python -m transferattack_torch.utils.convert --list
    python -m transferattack_torch.utils.convert --all <download_dir>
"""
from __future__ import annotations

import glob
import os
import re
import sys
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .bridge import load_flat_variables, save_flat_variables, state_dict_to_flat
from .weights_manifest import MANIFEST, print_inventory, weights_root

_BN_SUFFIXES = {
    "weight": ("params", "scale"),
    "bias": ("params", "bias"),
    "running_mean": ("batch_stats", "mean"),
    "running_var": ("batch_stats", "var"),
}

# module-path fragments that are BatchNorm in the model definitions
_BN_HINTS = re.compile(
    r"(^|/)(bn[0-9]?|bn_[0-9]+|norm[0-9]?|downsample_bn|norm|"
    r"denseblock[0-9]+_denselayer[0-9]+/norm[12])($|/)"
)


def _merge_indices(key: str) -> str:
    """``layer1.0.conv1`` → ``layer1_0/conv1``; ``blocks.3.attn`` →
    ``blocks_3/attn``; plain numeric segments merge into the previous one."""
    merged: List[str] = []
    for p in key.split("."):
        if p.isdigit() and merged:
            merged[-1] = f"{merged[-1]}_{p}"
        else:
            merged.append(p)
    return "/".join(merged)


# post-merge path rewrites aligning the reference's module trees with the
# model files' names (in order; each rule applies to the result of the last)
_REWRITES = [
    # torchvision ResNet downsample Sequential → named conv/bn pair
    (re.compile(r"downsample_0"), "downsample_conv"),
    (re.compile(r"downsample_1"), "downsample_bn"),
    # timm ViT/PiT patch embed
    (re.compile(r"patch_embed/norm"), "patch_norm"),
    (re.compile(r"patch_embed/proj"), "patch_embed"),
    # Swin/PiT stage-nested blocks are flat names
    (re.compile(r"(layers_\d+)/blocks_(\d+)"), r"\1_blocks_\2"),
    (re.compile(r"(layers_\d+)/downsample"), r"\1_downsample"),
    (re.compile(r"(transformers_\d+)/blocks_(\d+)"), r"\1_blocks_\2"),
    (re.compile(r"(transformers_\d+)/pool"), r"\1_pool"),
    # DenseNet feature tree prefix
    (re.compile(r"^features/(denseblock\d+)/(denselayer\d+)"), r"\1_\2"),
    (re.compile(r"^features/(transition\d+)"), r"\1"),
    (re.compile(r"^features/(conv0|norm0|norm5)"), r"\1"),
    # MobileNetV2's ConvBNReLU Sequentials (prefix-tolerant, so AITL's
    # predictor's nested backbone converts too)
    (re.compile(r"(^|/)(features_\d+)_0(?=/)"), r"\1\2/conv"),
    (re.compile(r"(^|/)(features_\d+)_1(?=/)"), r"\1\2/bn"),
    (re.compile(r"(conv_\d+)_0(?=/)"), r"\1/conv"),
    (re.compile(r"(conv_\d+)_1(?=/)"), r"\1/bn"),
    # GeneratorResnet (TTP, M3D, CDTP, LTP, GE-AdvGAN's generators): the
    # Sequential indices as named conv/bn children (a residual block's
    # Sequential: 0 pad, 1 conv, 2 bn, 3 relu, 4 dropout, 5 pad, 6 conv, 7 bn)
    (re.compile(r"(^|/)block1_1(?=/)"), r"\1block1_conv"),
    (re.compile(r"(^|/)block1_2(?=/)"), r"\1block1_bn"),
    (re.compile(r"(^|/)block([23])_0(?=/)"), r"\1block\2_conv"),
    (re.compile(r"(^|/)block([23])_1(?=/)"), r"\1block\2_bn"),
    (re.compile(r"(resblock\d+)/block_1(?=/)"), r"\1/conv1"),
    (re.compile(r"(resblock\d+)/block_2(?=/)"), r"\1/bn1"),
    (re.compile(r"(resblock\d+)/block_6(?=/)"), r"\1/conv2"),
    (re.compile(r"(resblock\d+)/block_7(?=/)"), r"\1/bn2"),
    (re.compile(r"(upsampl\d)_0(?=/)"), r"\1_conv"),
    (re.compile(r"(upsampl\d)_1(?=/)"), r"\1_bn"),
    (re.compile(r"(^|/)blockf_1(?=/)"), r"\1blockf_conv"),
    # AGS's SSL trunk: ``f`` holds the headless torchvision ResNet-50's
    # children (f.0 conv1, f.1 bn1, f.4..7 layer1..4; the projection head g
    # is dropped at reconcile)
    (re.compile(r"^f_0(?=/)"), "conv1"),
    (re.compile(r"^f_1(?=/)"), "bn1"),
    (re.compile(r"^f_4(?=[_/])"), "layer1"),
    (re.compile(r"^f_5(?=[_/])"), "layer2"),
    (re.compile(r"^f_6(?=[_/])"), "layer3"),
    (re.compile(r"^f_7(?=[_/])"), "layer4"),
    # the Stable Diffusion stack (diffusers' UNet and VAE): the sampler and
    # feed-forward Sequentials as single names
    (re.compile(r"(downsamplers_0|upsamplers_0)/conv"), r"\1_conv"),
    (re.compile(r"ff/net_0/proj"), "ff/net_0_proj"),
    # HF CLIPTextModel: the text_model/encoder wrappers dropped; the token
    # embedding an embedding table, the position embedding a bare parameter
    (re.compile(r"^text_model/encoder/"), ""),
    (re.compile(r"^text_model/"), ""),
    (re.compile(r"^embeddings/token_embedding/weight$"), "token_embedding/embedding"),
    (re.compile(r"^embeddings/position_embedding/weight$"), "position_embedding"),
]


def _apply_rewrites(path: str) -> str:
    for pat, rep in _REWRITES:
        path = pat.sub(rep, path)
    return path


def convert_tensor(path: str, arr: np.ndarray, is_bn: bool) -> Tuple[str, str, np.ndarray]:
    """(collection, leaf name, array in JAX's layout) of one tensor."""
    leaf = path.rsplit("/", 1)[-1]
    if is_bn and leaf in _BN_SUFFIXES:
        coll, name = _BN_SUFFIXES[leaf]
        return coll, name, arr
    if leaf.startswith("pos_embed") and arr.ndim == 4:
        return "params", leaf, arr.transpose(0, 2, 3, 1)  # PiT/Visformer (1, C, H, W)
    if leaf == "weight":
        if arr.ndim == 4:  # conv OIHW → HWIO
            return "params", "kernel", arr.transpose(2, 3, 1, 0)
        if arr.ndim == 3 and arr.shape[-1] == 1:  # a kernel-1 Conv1d is a Dense
            return "params", "kernel", arr[:, :, 0].T
        if arr.ndim == 2:  # linear
            return "params", "kernel", arr.T
        return "params", "scale", arr  # a 1-D weight outside BN: LayerNorm's
    if leaf == "bias":
        return "params", "bias", arr
    return "params", leaf, arr


def torch_state_dict_to_flat(state: Mapping[str, object], prefix: str = "backbone",
                             bn_paths: re.Pattern = _BN_HINTS) -> Dict[str, np.ndarray]:
    """A reference ``state_dict`` as the JAX package's flat variables
    (``{"params/backbone/conv1/kernel": array, ...}``): the keys and arrays
    of JAX's ``torch_state_dict_to_flax``, flattened."""
    # BatchNorm modules (they carry running_mean); MobileNetV2's bare
    # ``conv.N`` BN maps onto ``bn_{N-1}`` (the model names the project
    # conv/bn pair with one index)
    bn_modules = {_merge_indices(k).rsplit("/", 1)[0] for k in state if k.endswith("running_mean")}
    bn_renames = {}
    for mod in bn_modules:
        m = re.search(r"(.*)/conv_(\d+)$", mod)
        if m:
            bn_renames[mod] = f"{m.group(1)}/bn_{int(m.group(2)) - 1}"
    out: Dict[str, np.ndarray] = {}
    for key, tensor in state.items():
        if key.endswith(("num_batches_tracked", "relative_position_index", "attn_mask")):
            continue  # derived buffers, recomputed by the models
        arr = np.array(tensor.detach().cpu().numpy() if hasattr(tensor, "detach") else tensor,
                       copy=True)
        merged = _merge_indices(key)
        mod = merged.rsplit("/", 1)[0] if "/" in merged else ""
        if mod in bn_renames:
            merged = bn_renames[mod] + "/" + merged.rsplit("/", 1)[-1]
        merged = _apply_rewrites(merged)
        mod_path = merged.rsplit("/", 1)[0] if "/" in merged else ""
        is_bn = bool(bn_paths.search(mod_path)) or merged.rsplit("/", 1)[-1] in (
            "running_mean", "running_var")
        coll, leaf, conv = convert_tensor(merged, arr, is_bn)
        parts = [coll] + ([prefix] if prefix else []) + (mod_path.split("/") if mod_path else [])
        out["/".join(parts + [leaf])] = conv
    return out


def reconcile(module: nn.Module, converted: Mapping[str, np.ndarray]) -> Dict[str, List[str]]:
    """Fill ``module`` from ``converted`` (JAX's flat layout) as JAX's
    ``reconcile_with_module`` fills its variables: each of the module's
    variables takes the checkpoint's value where its shape is right; a
    missing one, or one of the wrong shape, keeps the module's init; keys
    the module lacks are dropped.  Returns ``{"missing": [...],
    "mismatched": [...]}``, named as JAX names them."""
    own = state_dict_to_flat(module)
    missing, mismatched, filled = [], [], {}
    for key, ref in own.items():
        conv = converted.get(key)
        if conv is None:
            missing.append(key)
            filled[key] = ref
        elif tuple(np.shape(conv)) != tuple(ref.shape):
            mismatched.append(f"{key}: ckpt{tuple(np.shape(conv))} vs model{tuple(ref.shape)}")
            filled[key] = ref
        else:
            filled[key] = np.asarray(conv, dtype=ref.dtype)
    load_flat_variables(module, filled)
    return {"missing": missing, "mismatched": mismatched}


def _report(name: str, report: Mapping[str, List[str]]) -> None:
    if report["missing"] or report["mismatched"]:
        print(f"[convert] {name}: {len(report['missing'])} missing, "
              f"{len(report['mismatched'])} mismatched")
        for m in (report["missing"] + report["mismatched"])[:20]:
            print("  ", m)


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def _unwrap(state):
    """The ``state_dict`` inside a checkpoint: its ``state_dict`` or
    ``model`` entry, without DataParallel's or the robustness library's
    prefixes."""
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    elif isinstance(state, dict) and isinstance(state.get("model"), dict) and all(
            hasattr(v, "shape") for v in state["model"].values()):
        state = state["model"]  # the slightly-robust releases
    for pref in ("module.attacker.model.", "module.model.", "module."):
        if any(k.startswith(pref) for k in state):
            state = {(k[len(pref):] if k.startswith(pref) else k): v for k, v in state.items()}
    return state


def _write(module: nn.Module, name: str, out_dir: Optional[str]) -> str:
    return save_flat_variables(module, os.path.join(out_dir or weights_root(), f"{name}.npz"))


def _convert(name: str, module: nn.Module, state, prefix: str, out_dir: Optional[str]) -> str:
    report = reconcile(module, torch_state_dict_to_flat(state, prefix=prefix))
    _report(name, report)
    return _write(module, name, out_dir)


# checkpoint names that do not embed the classifier's architecture
_CKPT_ARCH_OVERRIDES = {
    "ags_coco": "resnet50", "ags_comics": "resnet50", "ags_paintings": "resnet50",
}


def _ckpt_arch(name: str) -> Optional[str]:
    """The zoo architecture behind a ``<family>_<arch>[_<variant>]``
    checkpoint name (``dra_resnet50`` → resnet50, ``lgv_resnet50_3`` →
    resnet50, ``at_resnet50_4px`` → resnet50, ...), else None."""
    from ..models import list_models

    if name in _CKPT_ARCH_OVERRIDES:
        return _CKPT_ARCH_OVERRIDES[name]
    models = set(list_models())
    if name in models:
        return name
    parts = name.split("_")
    for i in range(len(parts)):
        for j in range(len(parts), i, -1):
            cand = "_".join(parts[i:j])
            if cand in models:
                return cand
    return None


def convert_and_save(name: str, state_dict_path: str, out_dir: Optional[str] = None) -> str:
    """A classifier's checkpoint (a registry name, or a fine-tuned
    checkpoint whose name embeds one) converted against that model and
    written as ``<out_dir or weights root>/<name>.npz``; returns the path."""
    from ..models import build_module

    state = _unwrap(_load(state_dict_path))
    arch = _ckpt_arch(name)
    if arch is None:
        raise ValueError(f"cannot infer the model behind {name!r}: use an "
                         "'<family>_<arch>' npz name or a registry model name")
    return _convert(name, build_module(arch), state, "backbone", out_dir)


def _aux_module(name: str) -> nn.Module:
    """The port's module of an auxiliary network of the manifest."""
    if name == "nrp":
        from ..defense.nrp import NRPNet
        return NRPNet()
    if name == "diffpure_unet":
        from ..defense.gd_unet import GuidedDiffusionUNet
        return GuidedDiffusionUNet()
    from ..input_transformation import learned
    if name == "ana_alignment":
        from ..model_related.checkpoint_surrogates import AlignmentNet
        return AlignmentNet(1024)  # over ResNet-50's layer3
    return {"atta_model": learned.ATTAModel, "pam_semantic_predictor": learned.SemanticPredictor,
            "stm_stylenet": learned.StyleNet, "aitl_encoder": learned.AITLEncoder,
            "aitl_decoder": learned.AITLDecoder, "aitl_predictor": learned.AITLPredictor}[name]()


_AUX_NAMES = ("nrp", "diffpure_unet", "atta_model", "pam_semantic_predictor", "stm_stylenet",
              "aitl_encoder", "aitl_decoder", "aitl_predictor", "ana_alignment")

# per-artifact key scrubs (the manifest's conversion notes)
_AUX_PRESCRUB: Dict[str, Callable] = {
    # the ATTA checkpoint wraps the CNN as Sequential(Normalize, net)
    "atta_model": lambda sd: {(k[2:] if k.startswith("1.") else k): v for k, v in sd.items()},
    # the Ghiasi weights live under 'state_dict_ghiasi'
    "stm_stylenet": lambda sd: sd.get("state_dict_ghiasi", sd),
    # the AITL predictor replaces MobileNetV2's classifier Sequential by a
    # bare Linear: re-nest it so that the MobileNetV2 rules apply
    "aitl_predictor": lambda sd: {k.replace("backbone.classifier.", "backbone.classifier.1."): v
                                  for k, v in sd.items()},
    # the ANA checkpoint nests the net under 'alignment_state_dict'
    "ana_alignment": lambda sd: sd.get("alignment_state_dict", sd),
}


def convert_aux(name: str, state_dict_path: str, out_dir: Optional[str] = None) -> str:
    """An auxiliary network's checkpoint (NRP's purifier, DiffPure's UNet,
    ATTA's CNN, PAM's predictor, STM's StyleNet, AITL's encoder, decoder and
    predictor, ANA's alignment net) as ``<name>.npz``."""
    state = _load(state_dict_path)
    if isinstance(state, dict) and "state_dict" in state and name != "stm_stylenet":
        state = state["state_dict"]
    scrub = _AUX_PRESCRUB.get(name)
    if scrub is not None:
        state = scrub(state)
    return _convert(name, _aux_module(name), state, "", out_dir)


def convert_stm_embeddings(state_dict_path: str, out_dir: Optional[str] = None) -> str:
    """``checkpoint_embeddings.pth`` → ``stm_embeddings.npz``: the PBN mean
    and the covariance factored as A = U·diag(√s)."""
    state = _load(state_dict_path)
    mean = np.asarray(state["pbn_embedding_mean"], np.float32).reshape(1, 100)
    cov = np.asarray(state["pbn_embedding_covariance"], np.float64)
    u, s, _ = np.linalg.svd(cov)
    a = (u @ np.diag(np.sqrt(s))).astype(np.float32)
    path = os.path.join(out_dir or weights_root(), "stm_embeddings.npz")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, pbn_embedding_mean=mean, A=a)
    return path


# generator npz names → the generator module
_GENERATOR_PREFIXES = ("ttp_", "m3d_", "cdtp", "ltp", "dsva", "ge_advgan", "ada", "fap")


def _generator_module(npz_name: str) -> nn.Module:
    from ..generation.generators import ADAGenerator, AdvGANGenerator, GeneratorResnet

    if npz_name.startswith("ge_advgan"):
        return AdvGANGenerator()
    if npz_name.startswith("ada"):
        return ADAGenerator()
    return GeneratorResnet()


def convert_generator(npz_name: str, state_dict_path: str, out_dir: Optional[str] = None) -> str:
    """An official generator checkpoint (TTP, M3D, CDTP, LTP, DSVA's
    GeneratorResnet, GE-AdvGAN's generator, ADA's) as ``<npz_name>.npz``."""
    state = _load(state_dict_path)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return _convert(npz_name, _generator_module(npz_name), state, "", out_dir)


def _sd_module(name: str) -> nn.Module:
    if name == "sd_unet":
        from ..generation.sd_unet import SDUNet
        return SDUNet()
    if name == "sd_vae":
        from ..generation.sd_vae import SDVAE
        return SDVAE()
    from ..generation.sd_text import CLIPTextEncoder
    return CLIPTextEncoder()


_SD_NAMES = ("sd_unet", "sd_vae", "sd_text")


def convert_sd(name: str, state_dict_path: str, out_dir: Optional[str] = None) -> str:
    """A diffusers or HF Stable Diffusion component (``sd_unet``,
    ``sd_vae``, ``sd_text``) as ``<name>.npz``."""
    state = _load(state_dict_path)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return _convert(name, _sd_module(name), state, "", out_dir)


def convert_one(name: str, path: str, out_dir: Optional[str] = None) -> str:
    """``path`` converted by the recipe that ``name`` asks for."""
    if name.startswith("hgd_"):
        from ..defense.at import convert_hgd
        return convert_hgd(path, name[len("hgd_"):], out_dir=out_dir)
    if name in _SD_NAMES:
        return convert_sd(name, path, out_dir)
    if name == "stm_embeddings":
        return convert_stm_embeddings(path, out_dir)
    if name in _AUX_NAMES:
        return convert_aux(name, path, out_dir)
    if name.startswith(_GENERATOR_PREFIXES):
        return convert_generator(name, path, out_dir)
    return convert_and_save(name, path, out_dir)


def convert_all(download_dir: str, out_dir: Optional[str] = None) -> List[Tuple[str, str, float]]:
    """Convert every file under ``download_dir`` that the manifest names
    (by its upstream file name), print what was converted (with its host
    seconds) and what failed, then the inventory.  Returns ``[(name, npz
    path, seconds)]``."""
    by_source = {art.source.split(" ")[0].split("/")[-1]: art for art in MANIFEST}
    converted, skipped = [], []
    for path in sorted(glob.glob(os.path.join(download_dir, "**", "*"), recursive=True)):
        art = by_source.get(os.path.basename(path))
        if art is None or not os.path.isfile(path):
            continue
        t0 = time.perf_counter()
        try:
            out = convert_one(art.npz, path, out_dir)
            converted.append((art.npz, out, time.perf_counter() - t0))
        except Exception as exc:  # keep going; report at the end
            skipped.append((art.npz, str(exc)))
    print(f"converted {len(converted)} artifacts:")
    for name, out, secs in converted:
        print(f"  ✓ {name} → {out} ({secs:.2f} s)")
    for name, err in skipped:
        print(f"  ✗ {name}: {err}")
    print_inventory()
    return converted


def main(argv: Optional[List[str]] = None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--list" in argv:
        print_inventory()
    elif "--all" in argv:
        convert_all(argv[argv.index("--all") + 1])
    elif len(argv) == 2:
        print(convert_one(argv[0], argv[1]))
    else:
        raise SystemExit("usage: python -m transferattack_torch.utils.convert "
                         "<name> <file.pth> | --list | --all <dir>")


if __name__ == "__main__":
    main()
