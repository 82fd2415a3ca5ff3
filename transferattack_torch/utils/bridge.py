"""Weights bridge: the JAX package's flat variables into this package's modules.

``transferattack_tpu.models.save_npz_variables`` writes a Flax variables tree
as a flat dict ``{"params/backbone/layer1_0/conv1/kernel": array, ...}``.
This module inverts the rules of ``transferattack_tpu/utils/convert.py``
(PyTorch ``state_dict`` → Flax), so the same dict loads into the port:

* a 4-D ``kernel`` (HWIO, grouped and depthwise ones too) becomes ``weight``
  (OIHW); a 2-D ``kernel`` (I, O) becomes ``weight`` (O, I); ``bias``
  passes through; a 4-D ``pos_embed*`` (1, H, W, C) becomes (1, C, H, W);
* BatchNorm and LayerNorm ``scale``/``bias`` become ``weight``/``bias``, and
  ``batch_stats/.../mean``/``var`` become ``running_mean``/``running_var``;
  other leaves (``cls_token``, ``relative_position_bias_table``, ...) keep
  their names;
* a 3-D ``kernel`` of Flax's ``SelfAttention`` (``toy_vit``) becomes a
  Linear ``weight``: query/key/value (dim, heads, head_dim) → (heads·head_dim,
  dim), ``out`` (heads, head_dim, dim) → (dim, heads·head_dim); their 2-D
  ``bias`` (heads, head_dim) is flattened;
* module paths: ``layerN_j`` → ``layerN.j``, ``features_N`` →
  ``features.N`` (likewise ``classifier``, ``blocks``, CaiT's
  ``blocks_token_only``, ``stageN``, ``net`` of ANA's alignment net, and
  Inception-ResNet-v2's ``repeat``/``repeat_1``/``repeat_2`` and
  ``branchK``: ``repeat_1_0`` → ``repeat_1.0``, ``branch1_2`` →
  ``branch1.2``),
  ``downsample_conv``/``downsample_bn`` → ``downsample.0``/``.1``,
  ``patch_embed`` → ``patch_embed.proj``, ``patch_norm`` →
  ``patch_embed.norm``, ``layers_i_blocks_j`` → ``layers.i.blocks.j`` (and
  ``transformers_i_*``, ``*_downsample``, ``*_pool``), and MobileNetV2's
  named pairs back to torchvision's ``Sequential`` indices
  (``features_N/conv`` → ``features.N.0``, ``conv_k/bn`` → ``conv.k.1``,
  ``bn_k`` → ``conv.{k+1}``), DenseNet's ``denseblockI_denselayerJ`` →
  ``features.denseblockI.denselayerJ`` and ``transitionI``, ``conv0``,
  ``norm0``, ``norm5`` → under ``features.``, and an ensemble's
  ``members_i`` → ``members.i`` (one flat dict of a JAX ensemble loads into
  the port's); the auxiliary networks of RFCoA and the learned
  transformations: ``enc_i``/``dec_i`` → ``enc.i``/``dec.i`` (``dec_out``
  as it is), StyleNet's ``layers_i`` → ``layers.i``, ATTA's ``conv_0``/
  ``conv_2`` → ``conv.0``/``conv.2``, AITL's ``fc1_0``/``fc1_3`` →
  ``fc1.0``/``fc1.3`` (a ``Sequential``'s Linear and BatchNorm1d, its
  statistics too);
* the generators of ``generation/`` (``convert.py``'s generator rewrites,
  inverted): GeneratorResnet's ``block1_conv``/``block1_bn`` →
  ``block1.1``/``.2`` and ``blockf_conv`` → ``blockf.1`` (a reflect pad is
  entry 0), ``block2_conv``/``block2_bn`` → ``block2.0``/``.1`` (likewise
  ``block3``, ``upsampl1``, ``upsampl2``), a ``resblockN``'s ``conv1``,
  ``bn1``, ``conv2``, ``bn2`` → ``resblockN.block.1``, ``.2``, ``.6``,
  ``.7``; AdvGAN's ``encoder_i``, ``decoder_i``, ``bottle_neck_i`` and
  ``conv_block_i`` and ADA's ``z_encoder_i`` and ``final_i`` as indices.
  A transposed conv's JAX kernel (kh, kw, out, in) takes the 4-D rule to
  torch's ``ConvTranspose2d`` (in, out, kh, kw) with no flip: Flax's
  ``transpose_kernel`` flips it itself;
* the defenses: HGD's DUNet's ``fwd_I_J``/``back_I_J`` → ``fwd.I.J``/``back.I.J``
  (the reference's ``Denoise``), NRP's ``RRDB_trunk_I`` → ``RRDB_trunk.I``
  (ESRGAN's);
* the guided-diffusion UNet (``defense/gd_unet.py``): ``input_blocks_N_M``
  and ``output_blocks_N_M`` → ``input_blocks.N.M``, and ``middle_block``,
  ``time_embed``, ``out``, ``in_layers``, ``emb_layers``, ``out_layers``
  as indices; an attention block's ``qkv`` and ``proj_out`` Dense kernels
  (I, O) become the reference's ``Conv1d`` weights (O, I, 1).

* the Stable Diffusion stack (``generation/sd_*.py``, diffusers' names):
  ``down_blocks_N``, ``up_blocks_N``, ``resnets_N``, ``attentions_N``,
  ``transformer_blocks_N`` and ``to_out_N`` as indices, and the joined
  ``net_0_proj``, ``downsamplers_0_conv``, ``upsamplers_0_conv`` →
  ``net.0.proj``, ``downsamplers.0.conv``, ``upsamplers.0.conv``; an
  ``nn.Embed`` table's ``embedding`` becomes ``weight``.

The port's module names are the ones the JAX converter maps (torchvision's
and timm's; Visformer's are the JAX model's own, see its module), so a
``state_dict`` with those names loads with ``load_state_dict`` and needs no
bridge.

The way back, :func:`save_flat_variables`, writes a module's ``state_dict``
in that flat layout (what the training entry points save, HGD's converter,
a seeded guided-diffusion UNet), each key held to give back its torch name
and value through the rules above.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias", "embedding": "weight"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}
_INDEXED = re.compile(r"(layer\d+|features|classifier|blocks|blocks_token_only|stage\d+|conv|net"
                      r"|repeat|repeat_[12]|branch\d|members|enc|dec|layers|fc\d+"
                      r"|encoder|decoder|bottle_neck|conv_block|z_encoder|final"
                      r"|time_embed|middle_block|in_layers|emb_layers|out_layers|out"
                      r"|down_blocks|up_blocks|resnets|attentions|transformer_blocks|to_out"
                      r"|RRDB_trunk)_(\d+)")
_STAGED = re.compile(r"(layers|transformers)_(\d+)_(?:blocks_(\d+)|(downsample|pool))")
_RENAMED = {"downsample_conv": ["downsample", "0"], "downsample_bn": ["downsample", "1"],
            "patch_embed": ["patch_embed", "proj"], "patch_norm": ["patch_embed", "norm"]}
# a ConvBNReLU of MobileNetV2 (``features_0``, ``features_18``, ``conv_k``
# inside a block): its ``conv``/``bn`` children are Sequential entries 0/1
_CONV_BN_RELU = re.compile(r"features_\d+|conv_\d+")
_PROJECTION_BN = re.compile(r"bn_(\d+)")  # MobileNetV2's last BN of a block
# DenseNet's children of torchvision's ``features`` Sequential
_DENSE_LAYER = re.compile(r"(denseblock\d+)_(denselayer\d+)")
_DENSE_TOP = re.compile(r"transition\d+|conv0|norm0|norm5")
# GeneratorResnet's named conv/BN pairs, Sequential entries from 1 where a
# reflect pad comes first, and a residual block's children
_GEN_PAIR = re.compile(r"(block[123f]|upsampl\d)_(conv|bn)")
_GEN_PADDED = ("block1", "blockf")
_RESBLOCK = re.compile(r"resblock\d+")
_RESBLOCK_CHILD = {"conv1": "1", "bn1": "2", "conv2": "6", "bn2": "7"}
# two indices in one name: the guided-diffusion UNet's blocks (``input_blocks_4_1``
# → ``input_blocks.4.1``) and HGD's DUNet's (``fwd_2_0`` → ``fwd.2.0``)
_DOUBLE_NAMES = ("input_blocks", "output_blocks", "fwd", "back")
_DOUBLE_INDEXED = re.compile(rf"({'|'.join(_DOUBLE_NAMES)})_(\d+)_(\d+)")
_UNET_ATTN_DENSE = ("qkv", "proj_out")  # an attention block's Conv1d layers
_UNET_CONV1D = re.compile(r"(input_blocks|output_blocks)_\d+_\d+|middle_block_\d+")
# the Stable Diffusion stack's joined names (diffusers' Sequentials)
_SD_JOINED = {"net_0_proj": ["net", "0", "proj"],
              "downsamplers_0_conv": ["downsamplers", "0", "conv"],
              "upsamplers_0_conv": ["upsamplers", "0", "conv"]}


def _module_path(path) -> list:
    parts, prev = [], ""
    for p in path:
        staged, indexed = _STAGED.fullmatch(p), _INDEXED.fullmatch(p)
        dense, pair = _DENSE_LAYER.fullmatch(p), _GEN_PAIR.fullmatch(p)
        double = _DOUBLE_INDEXED.fullmatch(p)
        if p in _RENAMED:
            parts += _RENAMED[p]
        elif p in _SD_JOINED:
            parts += _SD_JOINED[p]
        elif staged:
            parts += [staged.group(1), staged.group(2)] + (
                ["blocks", staged.group(3)] if staged.group(3) else [staged.group(4)])
        elif p in ("conv", "bn") and _CONV_BN_RELU.fullmatch(prev):
            parts.append("0" if p == "conv" else "1")
        elif _PROJECTION_BN.fullmatch(p):
            parts += ["conv", str(int(p[3:]) + 1)]
        elif dense:
            parts += ["features", *dense.groups()]
        elif _DENSE_TOP.fullmatch(p):
            parts += ["features", p]
        elif pair:
            first = 1 if pair.group(1) in _GEN_PADDED else 0
            parts += [pair.group(1), str(first + (pair.group(2) == "bn"))]
        elif p in _RESBLOCK_CHILD and _RESBLOCK.fullmatch(prev):
            parts += ["block", _RESBLOCK_CHILD[p]]
        elif double:
            parts += list(double.groups())
        elif indexed:
            parts += [indexed.group(1), indexed.group(2)]
        else:
            parts.append(p)
        prev = p
    return parts


def torch_key(jax_key: str) -> str:
    """``params/backbone/layer1_0/downsample_bn/scale`` →
    ``backbone.layer1.0.downsample.1.weight``."""
    collection, *path, leaf = jax_key.split("/")
    if collection == "params":
        name = _PARAM_LEAVES.get(leaf, leaf)  # cls_token, pos_embed, ... as they are
    elif collection == "batch_stats" and leaf in _STAT_LEAVES:
        name = _STAT_LEAVES[leaf]
    else:
        raise ValueError(f"no bridge rule for JAX variable {jax_key!r}")
    return ".".join(_module_path(path) + [name])


def torch_layout(jax_key: str, value: np.ndarray) -> np.ndarray:
    """Transpose a JAX kernel into PyTorch's weight layout."""
    *path, leaf = jax_key.split("/")
    if leaf == "kernel":
        if value.ndim == 4:
            return value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        if value.ndim == 2 and len(path) >= 2 and path[-1] in _UNET_ATTN_DENSE \
                and _UNET_CONV1D.fullmatch(path[-2]):
            return value.T[:, :, None]  # a UNet attention's Dense -> Conv1d (O, I, 1)
        if value.ndim == 2:
            return value.T  # (I, O) -> (O, I)
        if value.ndim == 3 and path[-1] == "out":  # (heads, head_dim, dim)
            return value.reshape(-1, value.shape[-1]).T
        if value.ndim == 3:  # (dim, heads, head_dim)
            return value.reshape(value.shape[0], -1).T
    if leaf == "bias" and value.ndim == 2:  # (heads, head_dim)
        return value.reshape(-1)
    if leaf.startswith("pos_embed") and value.ndim == 4:
        return value.transpose(0, 3, 1, 2)  # (1, H, W, C) -> (1, C, H, W)
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


# the writer: a torch module type → its parameters' and buffers' Flax
# (collection, leaf, layout) rules
_CONVS = (nn.Conv2d, nn.ConvTranspose2d)
_NORMS = (nn.BatchNorm1d, nn.BatchNorm2d, nn.LayerNorm, nn.GroupNorm)
_GEN_BLOCK = re.compile(r"block[123f]|upsampl\d")
_RESBLOCK_JAX = {v: k for k, v in _RESBLOCK_CHILD.items()}
_RENAMED_JAX = {tuple(v): k for k, v in _RENAMED.items()}


def _jax_module_path(name: str, modules: Mapping[str, nn.Module]) -> list:
    """A torch module path → JAX's (the inverse of ``_module_path``)."""
    parts = name.split(".") if name else []
    out, i = [], 0
    while i < len(parts):
        p, rest = parts[i], parts[i + 1:]
        if tuple(parts[i:i + 2]) in _RENAMED_JAX:  # ResNet's downsample.0/.1, a patch embed
            out.append(_RENAMED_JAX[tuple(parts[i:i + 2])])
            i += 2
        elif p in ("downsamplers", "upsamplers", "net") and rest[:2] in (["0", "conv"],
                                                                      ["0", "proj"]):
            out.append("_".join([p, *rest[:2]]))
            i += 3
        elif _GEN_BLOCK.fullmatch(p) and rest and rest[0].isdigit():
            # GeneratorResnet's Sequential entries: its conv or its BN
            child = modules[".".join(parts[:i + 2])]
            out.append(f"{p}_{'conv' if isinstance(child, _CONVS) else 'bn'}")
            i += 2
        elif _RESBLOCK.fullmatch(p) and rest[:1] == ["block"] and len(rest) > 1:
            out += [p, _RESBLOCK_JAX[rest[1]]]
            i += 3
        elif p in _DOUBLE_NAMES and len(rest) > 1 and rest[0].isdigit() and rest[1].isdigit():
            out.append(f"{p}_{rest[0]}_{rest[1]}")
            i += 3
        elif p in ("layers", "transformers") and len(rest) > 2 and rest[0].isdigit() \
                and rest[1] == "blocks" and rest[2].isdigit():
            out.append(f"{p}_{rest[0]}_blocks_{rest[2]}")  # Swin's and PiT's staged blocks
            i += 4
        elif p in ("layers", "transformers") and len(rest) > 1 and rest[0].isdigit() \
                and rest[1] in ("downsample", "pool"):
            out.append(f"{p}_{rest[0]}_{rest[1]}")
            i += 3
        elif p == "features" and len(rest) > 1 and _DENSE_LAYER.fullmatch("_".join(rest[:2])):
            out.append("_".join(rest[:2]))  # DenseNet's denseblockI.denselayerJ
            i += 3
        elif p == "features" and rest and _DENSE_TOP.fullmatch(rest[0]):
            out.append(rest[0])  # DenseNet's transitionI, conv0, norm0, norm5
            i += 2
        elif len(rest) > 1 and rest[0].isdigit() and rest[1] in ("0", "1") and type(
                modules.get(".".join(parts[:i + 2]))).__name__ == "ConvBNReLU":
            # MobileNetV2's ConvBNReLU: its conv and BN as named children
            out += [f"{p}_{rest[0]}", "conv" if rest[1] == "0" else "bn"]
            i += 3
        elif p == "conv" and rest and rest[0].isdigit() and isinstance(
                modules.get(".".join(parts[:i + 2])), nn.BatchNorm2d):
            out.append(f"bn_{int(rest[0]) - 1}")  # MobileNetV2's projection BN
            i += 2
        elif rest and rest[0].isdigit():
            out.append(f"{p}_{rest[0]}")
            i += 2
        else:
            out.append(p)
            i += 1
    return out


def _jax_leaf(module: nn.Module, owner: str, name: str, value: np.ndarray):
    """(collection, leaf, value in JAX's layout) of ``name`` of ``module``,
    the module at path ``owner``; None for BatchNorm's step counter."""
    if isinstance(module, _CONVS) and name == "weight":
        return "params", "kernel", value.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    if isinstance(module, nn.Conv1d) and owner.rpartition(".")[2] in _UNET_ATTN_DENSE \
            and name in ("weight", "bias"):
        # a UNet attention's Conv1d (O, I, 1), a Dense (I, O) in JAX
        return ("params", "kernel", value[:, :, 0].T) if name == "weight" else \
            ("params", "bias", value)
    if isinstance(module, nn.Linear) and name == "weight":
        return "params", "kernel", value.T
    if isinstance(module, (*_CONVS, nn.Linear, *_NORMS)) and name == "bias":
        return "params", "bias", value
    if isinstance(module, _NORMS) and name == "weight":
        return "params", "scale", value
    if isinstance(module, _NORMS[:2]) and name in ("running_mean", "running_var"):
        return "batch_stats", name[len("running_"):], value
    if isinstance(module, _NORMS[:2]) and name == "num_batches_tracked":
        return None
    if isinstance(module, nn.Embedding) and name == "weight":
        return "params", "embedding", value
    if name not in ("weight", "bias") and name in dict(module.named_parameters(recurse=False)):
        # a free parameter (class and distillation tokens, position
        # embeddings, CLIP's too, Swin's relative position bias, CaiT's
        # LayerScale), as it is
        if name.startswith("pos_embed") and value.ndim == 4:
            return "params", name, value.transpose(0, 2, 3, 1)  # (1, C, H, W) -> (1, H, W, C)
        return "params", name, value
    raise ValueError(f"no writer rule for {name!r} of {type(module).__name__}")


def state_dict_to_flat(module: nn.Module) -> Dict[str, np.ndarray]:
    """``module``'s ``state_dict`` as JAX's flat variables, the inverse of
    :func:`flat_to_state_dict`: Conv and ConvTranspose weights to HWIO
    ``kernel``s, Linear weights to (I, O), norm weights to ``scale``,
    BatchNorm statistics under ``batch_stats``, an embedding table to
    ``embedding``, a free parameter (tokens, position embeddings) as it is,
    a 4-D position embedding to (1, H, W, C); module paths as JAX's models
    name them (DenseNet's, MobileNetV2's, Swin's and PiT's included).
    Raises on a module type it has no rule for, and on a key whose torch
    name or value the bridge would not give back."""
    modules = dict(module.named_modules())
    flat: Dict[str, np.ndarray] = {}
    for tname, tensor in module.state_dict().items():
        owner, _, leaf = tname.rpartition(".")
        value = tensor.detach().cpu().numpy()
        rule = _jax_leaf(modules[owner], owner, leaf, value)
        if rule is None:
            continue
        collection, jleaf, jvalue = rule
        key = "/".join([collection, *_jax_module_path(owner, modules), jleaf])
        jvalue = np.ascontiguousarray(jvalue)
        if torch_key(key) != tname or not np.array_equal(torch_layout(key, jvalue), value):
            raise ValueError(f"{tname!r} written as {key!r} would load as "
                             f"{torch_key(key)!r}")
        flat[key] = jvalue
    return flat


def save_flat_variables(module: nn.Module, path: str) -> str:
    """Write ``module`` to ``path`` as JAX's ``save_npz_variables`` does (one
    ``np.savez`` of ``/``-joined keys), so that JAX's ``load_npz_variables``
    and :func:`load_flat_variables` both read it.  Returns ``path``."""
    flat = state_dict_to_flat(module)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)
    return path
