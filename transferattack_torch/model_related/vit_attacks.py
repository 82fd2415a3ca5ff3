"""ViT-surrogate attacks (counterpart of ``model_related/vit_attacks.py``):
TGR, PNA-PatchOut, SAPR and FDAP.

The reference's backward hooks on attention internals are
:class:`~transferattack_torch.models.vit.ViTSurgery` edits run inside the
forward.  The reference takes TGR's truncation indices from batch element 0
(it mandates batch size 1); JAX, and the port, take them per image, which
is the same at batch size 1.  The draws go through the seams
:meth:`PNA_PatchOut.patchout_mask` and :meth:`SAPR.token_perm`.
"""
from __future__ import annotations

import torch

from ..attack import AttackState, draw
from ..gradient.mifgsm import MIFGSM
from ..models import Surrogate
from ..models.vit import ViTSurgery, with_surgery
from .sgm import surgery_model


def vit_model(spec, kwargs, **model_kwargs):
    """The surrogate ``spec`` with ``model_kwargs`` (a ``surgery``, CaiT's
    ``cls_surgery``): a registry name is built with them on the attack's
    device; a :class:`Surrogate` becomes a view that runs them (JAX's
    ``_with_surgery``).  ``pretrained`` and ``input_size`` come out of the
    attack's ``kwargs``."""
    if isinstance(spec, Surrogate):
        kwargs.pop("pretrained", None)
        kwargs.pop("input_size", None)
        return with_surgery(spec, **model_kwargs) if model_kwargs else spec
    return surgery_model(spec, kwargs, **model_kwargs)


def _zero_token_extremes(g, dim: int):
    """Zero the argmax and argmin positions along ``dim``, per other index."""
    idx = torch.arange(g.shape[dim], device=g.device).reshape(
        [-1 if a == dim else 1 for a in range(g.ndim)])
    keep = (idx != g.argmax(dim, keepdim=True)) & (idx != g.argmin(dim, keepdim=True))
    return g * keep.to(g.dtype)


def tgr_attn_bwd(g, meta, gamma=0.25):
    """(B, h, N, N) pre-softmax score cotangent: scaled by γ, then the whole
    row and column of each head's largest and smallest entry zeroed."""
    g = gamma * g
    b, h, n, _ = g.shape
    flat = g.reshape(b, h, n * n)
    rows = torch.arange(n, device=g.device)

    def row_col(pos):
        r, c = (pos // n)[..., None], (pos % n)[..., None]
        return (rows != r)[..., :, None] & (rows != c)[..., None, :]

    keep = row_col(flat.argmax(-1)) & row_col(flat.argmin(-1))
    return g * keep.to(g.dtype)


def tgr_token_bwd(g, meta, gamma):
    """(B, N, C) output cotangent of the qkv or MLP projection: scaled by γ,
    then each channel's extreme tokens zeroed."""
    return _zero_token_extremes(gamma * g, 1)


def tgr_cls_attn_bwd(g, meta, gamma=0.25):
    """(B, h, 1, N) class-attention score cotangent: scaled by γ, then the
    extreme heads of each key zeroed."""
    return _zero_token_extremes(gamma * g, 1)


TGR_SURGERY = ViTSurgery(
    scores_bwd=lambda g, m: tgr_attn_bwd(g, m, 0.25),
    qkv_bwd=lambda g, m: tgr_token_bwd(g, m, 0.75),
    mlp_out_bwd=lambda g, m: tgr_token_bwd(g, m, 0.5),
)

# CaiT's class-attention blocks: the query's gradient dropped, k/v and the MLP
# truncated as in the main blocks; both class-attention blocks are hooked
TGR_CLS_SURGERY = ViTSurgery(
    scores_bwd=lambda g, m: tgr_cls_attn_bwd(g, m, 0.25),
    q_bwd=lambda g, m: torch.zeros_like(g),
    qkv_bwd=lambda g, m: tgr_token_bwd(g, m, 0.75),
    mlp_out_bwd=lambda g, m: tgr_token_bwd(g, m, 0.5),
)


class TGR(MIFGSM):
    """Token gradient regularization (CVPR 2023).  On a CaiT (a ``cait*``
    name, or a surrogate whose backbone has class attention) the
    class-attention blocks take ``TGR_CLS_SURGERY``."""

    def __init__(self, model_name="vit_base_patch16_224", **kwargs):
        kwargs.setdefault("attack", "TGR")
        mkw = {"surgery": TGR_SURGERY}
        if (model_name.startswith("cait") if isinstance(model_name, str)
                else hasattr(model_name.module.backbone, "cls_surgery")):
            mkw["cls_surgery"] = TGR_CLS_SURGERY
        super().__init__(vit_model(model_name, kwargs, **mkw), **kwargs)


def patchout_keep(gen, shape, crop_length: int, sample_num_patches: int, device):
    """A (1, H, W, 1) 0/1 mask keeping ``sample_num_patches`` random
    crop_length² patches: the top scores of a U(0, 1) draw a patch."""
    h, w = shape[1], shape[2]
    gh, gw = h // crop_length, w // crop_length
    n = gh * gw
    scores = draw(gen, torch.rand, (n,), device=device)
    thresh = scores.sort().values[n - min(sample_num_patches, n)]
    keep = (scores >= thresh).float().reshape(gh, gw)
    return keep.repeat_interleave(crop_length, 0).repeat_interleave(crop_length, 1)[None, :, :, None]


class PNA_PatchOut(MIFGSM):
    """Pay no attention + PatchOut: the attention map's gradient dropped,
    each iteration attacking a random subset of patches, an L2 penalty on
    delta."""

    def __init__(self, model_name="vit_base_patch16_224", crop_length=16,
                 sample_num_patches=130, lamb=0.1, **kwargs):
        kwargs.setdefault("attack", "PNA_PatchOut")
        model = vit_model(model_name, kwargs, surgery=ViTSurgery(skip_attn_grad=True))
        super().__init__(model, **kwargs)
        self.crop_length = int(crop_length)
        self.sample_num_patches = int(sample_num_patches)
        self.lamb = float(lamb)

    def patchout_mask(self, gen, x):
        """This iteration's patch mask (JAX's ``_patchout_mask``)."""
        return patchout_keep(gen, x.shape, self.crop_length, self.sample_num_patches,
                             x.device)

    def get_grad(self, x, y, state: AttackState, gen):
        mask = self.patchout_mask(gen, x)
        delta = state.delta.detach().requires_grad_(True)
        logits = self.model.apply(x + delta * mask).float()
        self.grad_evals += 1
        # eps inside the sqrt: the L2 norm's gradient at delta = 0 is NaN;
        # the norm of the whole batch's delta
        l2 = torch.sqrt(self.batch_sum(delta ** 2, axis=0) + 1e-12)
        (grad,) = torch.autograd.grad(self.get_loss(logits[None], y) + self.lamb * l2, delta)
        return grad, {}


class SAPR(MIFGSM):
    """Self-attention patch restructuring: each attention input arrives, with
    probability ``prob``, with its non-class tokens permuted (one permutation
    a draw)."""

    def __init__(self, model_name="vit_base_patch16_224", prob=0.15, **kwargs):
        kwargs.setdefault("attack", "SAPR")
        self.prob = float(prob)
        model = vit_model(model_name, kwargs, surgery=ViTSurgery(attn_pre=self._attn_pre))
        super().__init__(model, **kwargs)

    def token_perm(self, gen, n_tokens: int, block: int):
        """(a permutation of 1..N−1, whether to apply it) for one attention
        input (JAX's seam)."""
        perm = draw(gen, torch.randperm, n_tokens - 1, device=self.device) + 1
        return perm, bool(draw(gen, torch.rand, (), device=self.device) < self.prob)

    def _attn_pre(self, x, meta, gen):
        perm, apply = self.token_perm(gen, x.shape[1], meta["block"])
        if not apply:
            return x
        idx = torch.cat([torch.zeros(1, dtype=perm.dtype, device=perm.device), perm])
        return x[:, idx.to(x.device)]

    def get_grad(self, x, y, state: AttackState, gen):
        delta = state.delta.detach().requires_grad_(True)
        logits = self.model.apply(x + delta, generator=gen).float()
        self.grad_evals += 1
        (grad,) = torch.autograd.grad(self.get_loss(logits[None], y), delta)
        return grad, {}


class FDAP(MIFGSM):
    """Feature-diversity collapse: CE minus γ·Σ_blocks mean (log‖f − f̄‖)^β,
    f the normalised MLP-branch input (norm2's output) of blocks 5–9;
    alpha=3/255, epoch=30."""

    def __init__(self, model_name="vit_base_patch16_224", epoch=30, beta=2.0,
                 gamma=0.1, blocks=(5, 6, 7, 8, 9), **kwargs):
        kwargs.setdefault("attack", "FDAP")
        kwargs.setdefault("alpha", 3 / 255)
        super().__init__(vit_model(model_name, kwargs), epoch=epoch, **kwargs)
        self.beta = float(beta)
        self.gamma = float(gamma)
        self.blocks = tuple(blocks)

    def get_grad(self, x, y, state: AttackState, gen):
        feats = []

        def mlp_in_post(h, m):
            if m["block"] in self.blocks:
                feats.append(h)
            return h

        delta = state.delta.detach().requires_grad_(True)
        logits = with_surgery(self.model, ViTSurgery(mlp_in_post=mlp_in_post)).apply(
            x + delta).float()
        self.grad_evals += 1
        loss_div = 0.0
        for f in feats:
            f = f.float()
            r = (f - f.mean(dim=1, keepdim=True)).reshape(f.shape[0], -1).norm(dim=1) + 1e-8
            loss_div = loss_div + self.batch_share(torch.log(r) ** self.beta)
        loss = self.get_loss(logits[None], y) - self.gamma * loss_div
        (grad,) = torch.autograd.grad(loss, delta)
        return grad, {}
