"""ViT and DeiT (counterpart of ``models/vit.py``), timm's module names, with
the JAX model's gradient-surgery hook points.

The ViT-specific attacks (TGR, PNA, SAPR, FDAP, VDC, FPR, ATT, SETR, LL2S,
ATA-ViT) rewrite cotangents and activations inside the attention and MLP.
A :class:`ViTSurgery` names those edits, field for field as JAX's does:
each ``*_bwd`` is ``fn(g, meta) -> g`` on the cotangent of its tensor (an
identity ``torch.autograd.Function`` whose backward applies it,
:func:`apply_bwd_hook`), each ``*_post``/``*_pre`` a forward edit
``fn(x, meta)`` (``attn_pre`` also takes the forward's generator).  ``meta``
has ``block`` (the block index) and, in the attention, ``num_heads`` and
``tokens``.

The surgery is an argument of ``forward``, not a part of the module:
:func:`with_surgery` gives a surrogate that calls the same module, the same
parameters, with another surgery (JAX's ``_rebuild_vit``).  The module's
own ``surgery`` is the default.

Two attention layouts: with no edit of the attention map (JAX's
``fast_layout``) and no tap on it, ``F.scaled_dot_product_attention``;
otherwise the explicit ``softmax(q kᵀ / √dh) v`` with the hooks between.
The JAX ``PatchEmbed`` (a reshape and a matmul) is the stride-P
convolution ``patch_embed.proj`` here.  ``img_size`` sets the length of
``pos_embed``, which the Flax model infers from its first input.

Taps, as JAX sows them (:meth:`~transferattack_torch.models.Surrogate.features`):
``blocks_{i}`` (and ``blocks_{i}/block_out``) is block i's output,
``blocks_{i}/attn`` its attention map after the surgery.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import register_model


@dataclasses.dataclass(frozen=True, eq=False)
class ViTSurgery:
    """Gradient and activation surgery of a ViT (JAX's ``ViTSurgery``).

    ``*_bwd``: ``fn(g, meta) -> g`` on that tensor's cotangent.  ``scores_bwd``
    is the pre-softmax scores' (where the reference's ``attn_drop`` hooks
    land), ``attn_bwd`` the softmax map's, ``qkv_bwd`` the fused qkv
    projection's, ``q_bwd`` a separate q projection's (CaiT's class
    attention), ``mlp_bwd`` the MLP hidden activation's, ``mlp_in_bwd`` the
    MLP branch input's, ``mlp_out_bwd`` the MLP output's.

    Forward edits: ``attn_pre(x, meta, generator)`` of the attention input
    tokens (SAPR), ``qkv_post``, ``scores_post``, ``attn_post``,
    ``attn_out_post``, ``mlp_hidden_post``, ``mlp_out_post``,
    ``mlp_in_post`` (after norm2), ``mlp_branch_pre`` (the MLP branch's view
    of the residual stream before norm2; the skip keeps the untouched
    tensor), ``block_out_post``.  ``kv_extra(meta) -> (k, v[, bias])``
    appends (B, h, R, dh) keys and values on the key axis, the bias added to
    the R extra score columns only.  ``skip_attn_grad``: the backward takes
    the attention map as a constant (PNA).
    """

    attn_bwd: Optional[Callable] = None
    scores_bwd: Optional[Callable] = None
    qkv_bwd: Optional[Callable] = None
    mlp_bwd: Optional[Callable] = None
    mlp_in_bwd: Optional[Callable] = None
    mlp_out_bwd: Optional[Callable] = None
    attn_post: Optional[Callable] = None
    attn_pre: Optional[Callable] = None
    kv_extra: Optional[Callable] = None
    mlp_hidden_post: Optional[Callable] = None
    attn_out_post: Optional[Callable] = None
    mlp_out_post: Optional[Callable] = None
    mlp_in_post: Optional[Callable] = None
    qkv_post: Optional[Callable] = None
    q_bwd: Optional[Callable] = None
    scores_post: Optional[Callable] = None
    mlp_branch_pre: Optional[Callable] = None
    block_out_post: Optional[Callable] = None
    skip_attn_grad: bool = False

    def edits_attention_map(self) -> bool:
        """Whether an edit needs the explicit attention map (JAX's
        ``fast_layout`` is the negation)."""
        return (self.scores_bwd is not None or self.attn_bwd is not None
                or self.attn_post is not None or self.scores_post is not None
                or self.skip_attn_grad)


DEFAULT_VIT_SURGERY = ViTSurgery()


class _BwdHook(torch.autograd.Function):
    """Identity whose backward applies ``hook(g, meta)``."""

    @staticmethod
    def forward(ctx, x, hook, meta):
        ctx.hook, ctx.meta = hook, meta
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.hook(g, ctx.meta), None, None


def apply_bwd_hook(x, hook: Optional[Callable], meta):
    """``x``, with ``hook(g, meta)`` applied to its cotangent (none without
    a hook)."""
    return x if hook is None else _BwdHook.apply(x, hook, meta)


def with_surgery(surrogate, surgery: ViTSurgery, **forward_kwargs):
    """A view of ``surrogate`` whose forward runs ``surgery`` (and any other
    ``forward`` keyword): the same module and parameters, nothing copied or
    re-initialised."""
    return dataclasses.replace(surrogate, forward_kwargs={
        **surrogate.forward_kwargs, "surgery": surgery, **forward_kwargs})


class Tap(nn.Identity):
    """A point a forward hook can read or replace, its tensor taken in the
    layout it has (not permuted as a CNN's NCHW output is)."""

    token_layout = True


def attention(q, k, v, s: ViTSurgery, meta, tap: Tap, ext_bias=None):
    """``softmax(q kᵀ / √dh) v`` over (B, h, N, dh) with ``s``'s map edits;
    SDPA when nothing reads or edits the map."""
    if not s.edits_attention_map() and ext_bias is None and not tap._forward_hooks:
        return F.scaled_dot_product_attention(q, k, v)
    attn = (q @ k.transpose(-2, -1)) * q.shape[-1] ** -0.5
    if ext_bias is not None:
        n = q.shape[2]
        attn = torch.cat([attn[..., :n], attn[..., n:] + ext_bias], dim=-1)
    attn = apply_bwd_hook(attn, s.scores_bwd, meta)
    if s.scores_post is not None:
        attn = s.scores_post(attn, meta)
    attn = attn.softmax(dim=-1)
    if s.attn_post is not None:
        attn = s.attn_post(attn, meta)
    attn = attn.detach() if s.skip_attn_grad else apply_bwd_hook(attn, s.attn_bwd, meta)
    return tap(attn) @ v


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, block_index: int = 0):
        super().__init__()
        self.num_heads = num_heads
        self.block_index = block_index
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.attn_map = Tap()

    def forward(self, x, s: ViTSurgery = DEFAULT_VIT_SURGERY, generator=None):
        b, n, d = x.shape
        h = self.num_heads
        meta = {"block": self.block_index, "num_heads": h, "tokens": n}
        if s.attn_pre is not None:
            x = s.attn_pre(x, meta, generator)
        qkv = self.qkv(x)
        if s.qkv_post is not None:
            qkv = s.qkv_post(qkv, meta)
        qkv = apply_bwd_hook(qkv, s.qkv_bwd, meta)
        q, k, v = qkv.reshape(b, n, 3, h, d // h).permute(2, 0, 3, 1, 4)
        ext_bias = None
        if s.kv_extra is not None:
            ext = s.kv_extra(meta)
            k = torch.cat([k, ext[0].to(k.dtype)], dim=2)
            v = torch.cat([v, ext[1].to(v.dtype)], dim=2)
            if len(ext) > 2:
                ext_bias = torch.as_tensor(ext[2], dtype=q.dtype, device=q.device)
        out = attention(q, k, v, s, meta, self.attn_map, ext_bias)
        out = self.proj(out.transpose(1, 2).reshape(b, n, d))
        if s.attn_out_post is not None:
            out = s.attn_out_post(out, meta)
        return out


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, block_index: int = 0):
        super().__init__()
        self.block_index = block_index
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x, s: ViTSurgery = DEFAULT_VIT_SURGERY):
        meta = {"block": self.block_index}
        x = F.gelu(self.fc1(x))
        if s.mlp_hidden_post is not None:
            x = s.mlp_hidden_post(x, meta)
        x = self.fc2(apply_bwd_hook(x, s.mlp_bwd, meta))
        x = apply_bwd_hook(x, s.mlp_out_bwd, meta)
        if s.mlp_out_post is not None:
            x = s.mlp_out_post(x, meta)
        return x


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 block_index: int = 0):
        super().__init__()
        self.block_index = block_index
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, block_index)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), block_index)

    def forward(self, x, s: ViTSurgery = DEFAULT_VIT_SURGERY, generator=None):
        meta = {"block": self.block_index}
        x = x + self.attn(self.norm1(x), s, generator)
        h = x
        if s.mlp_branch_pre is not None:
            # the skip keeps the untouched x: an edit here reaches the
            # residual stream through norm2 only
            h = s.mlp_branch_pre(h, meta)
        h = self.norm2(h)
        if s.mlp_in_post is not None:
            h = s.mlp_in_post(h, meta)
        x = x + self.mlp(apply_bwd_hook(h, s.mlp_in_bwd, meta), s)
        if s.block_out_post is not None:
            x = s.block_out_post(x, meta)
        return x


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, patch)

    def forward(self, x):  # (B, 3, H, W) -> (B, tokens, dim)
        return self.proj(x).flatten(2).transpose(1, 2)


_BLOCK_TAP = re.compile(r"blocks_(\d+)(?:/(block_out|attn))?")


class VisionTransformer(nn.Module):
    def __init__(self, patch_size: int = 16, dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0, num_classes: int = 1000,
                 distilled: bool = False, img_size: int = 224,
                 surgery: ViTSurgery = DEFAULT_VIT_SURGERY, token_drop: float = 0.0):
        super().__init__()
        self.num_classes = num_classes
        self.distilled = distilled
        self.patch_size, self.dim, self.depth, self.num_heads = patch_size, dim, depth, num_heads
        self.surgery = surgery
        self.token_drop = float(token_drop)
        self.patch_embed = PatchEmbed(dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        prefix = 1
        if distilled:
            self.dist_token = nn.Parameter(torch.zeros(1, 1, dim))
            prefix = 2
        self.pos_embed = nn.Parameter(
            torch.zeros(1, (img_size // patch_size) ** 2 + prefix, dim))
        self.blocks = nn.ModuleList([Block(dim, num_heads, mlp_ratio, i)
                                     for i in range(depth)])
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.head = nn.Linear(dim, num_classes)
        if distilled:
            self.head_dist = nn.Linear(dim, num_classes)

    def token_keep(self, generator: torch.Generator, shape, device):
        """PatchOut's 0/1 keep draws, (B, tokens, 1) at rate 1 − token_drop
        (the seam of JAX's inline ``bernoulli``)."""
        if generator is None:
            raise ValueError("token_drop > 0 needs a generator")
        u = torch.rand(shape, generator=generator, device=generator.device)
        return (u < 1.0 - self.token_drop).to(device)

    def forward(self, x, features_only: bool = False, extra_tokens=None,
                surgery: Optional[ViTSurgery] = None, generator=None):
        """``extra_tokens``: a (B, R, D) sequence appended after the position
        embedding (LL2S's robust tokens).  ``generator``: the draws of
        ``token_drop`` and of the surgery's ``attn_pre``."""
        s = self.surgery if surgery is None else surgery
        x = self.patch_embed(x)
        b = x.shape[0]
        prefix = [self.cls_token.expand(b, -1, -1)]
        if self.distilled:
            prefix.append(self.dist_token.expand(b, -1, -1))
        x = torch.cat(prefix + [x], dim=1) + self.pos_embed
        if extra_tokens is not None:
            x = torch.cat([x, extra_tokens.to(x.dtype)], dim=1)
        if self.token_drop > 0.0:  # never the class or distillation token
            keep = self.token_keep(generator, (b, x.shape[1], 1), x.device).to(x.dtype)
            keep[:, :len(prefix)] = 1.0
            x = x * keep
        for blk in self.blocks:
            x = blk(x, s, generator)
        x = self.norm(x)
        if features_only:
            return x[:, 0]
        logits = self.head(x[:, 0])
        if self.distilled:
            # timm's DeiT in eval: the mean of the class and distillation heads
            logits = (logits + self.head_dist(x[:, 1])) / 2.0
        return logits

    def tap_keys(self):
        return [f"blocks_{i}{t}" for i in range(self.depth) for t in ("", "/attn")]

    def tap_path(self, key: str) -> Optional[str]:
        """The module whose output is JAX's tap ``key``."""
        m = _BLOCK_TAP.fullmatch(key)
        if m is None:
            return None
        return f"blocks.{m.group(1)}" + (".attn.attn_map" if m.group(2) == "attn" else "")


register_model("vit_base_patch16_224", sized=True)(VisionTransformer)
register_model("vit_small_patch16_224", sized=True)(
    lambda **kw: VisionTransformer(dim=384, depth=12, num_heads=6, **kw)
)
register_model("deit_base_distilled_patch16_224", sized=True)(
    lambda **kw: VisionTransformer(distilled=True, **kw)
)
