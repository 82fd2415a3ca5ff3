"""Advanced ViT-surrogate attacks (counterpart of
``model_related/vit_attacks2.py``): VDC, FPR, ATT and SETR.

The reference mutates backward-hook state across two backward passes
(VDC), keeps accumulators across iterations in hooks (FPR) or calibrates
gradient-penalty factors from recorded variances (ATT).  As in JAX:

* a cotangent is recorded as the gradient at a zero offset added where the
  hook sits (``torch.autograd.grad`` with respect to the offsets);
* adding ``add`` to the cotangent at p is adding ``⟨add, p⟩`` to the loss;
* scaling the cotangent at p by s is the forward rewrite
  ``s·p + ((1−s)·p).detach()``.

Offsets are made in the dtype of the tensor they are added to, so a bf16
forward stays bf16.  FPR's noise goes through the seam
:meth:`FPR.attn_noise`, ATT's patch mask through :meth:`ATT.patchout_mask`.
"""
from __future__ import annotations

import warnings

import torch
from torch import nn

from ..attack import AttackState, draw, softmax_cross_entropy
from ..gradient.mifgsm import MIFGSM
from ..models import aux_path, load_npz, record_fallback, weights_root
from ..models.vit import ViTSurgery, with_surgery
from ..utils.bridge import load_flat_variables
from .vit_attacks import patchout_keep, vit_model


def vit_shapes(model, batch: int):
    """(attention map, tokens) shapes of the surrogate's blocks at ``batch``,
    from its hyperparameters (the preprocess resizes to its input size)."""
    bb = model.module.backbone
    n = (model.input_size // bb.patch_size) ** 2 + (2 if getattr(bb, "distilled", False) else 1)
    return (batch, bb.num_heads, n, n), (batch, n, bb.dim)


def _dtype(model):
    return model.compute_dtype or torch.float32


def _scaled(p, s):
    """``p`` whose cotangent is scaled by ``s``."""
    return s * p + ((1 - s) * p).detach()


class VDC(MIFGSM):
    """Virtual dense connections.  Pass 1 records, in a plain backward, the
    cotangent of every block's pre-softmax scores (where the reference's
    ``attn_drop`` hook lands), of its MLP branch at norm2's input (the
    ``norm2`` hook, through that branch only) and of the final norm's input.
    Pass 2 scales the scores' cotangent ×0.25 and the MLP branch's ×0.5
    (compounding through depth) and injects depth-accumulated records,
    damped by 0.1·0.5^k, as virtual skips; the MLP chain is seeded with the
    final-norm record's class row ×0.1×0.5."""

    def __init__(self, model_name="vit_base_patch16_224", lamb=0.1, **kwargs):
        kwargs.setdefault("attack", "VDC")
        super().__init__(vit_model(model_name, kwargs), **kwargs)
        self.lamb = float(lamb)
        self.depth = self.model.module.backbone.depth

    def get_grad(self, x, y, state: AttackState, gen):
        D = self.depth
        attn_shape, tok_shape = vit_shapes(self.model, x.shape[0])
        dt, dev = _dtype(self.model), x.device

        # pass 1: the plain backward's cotangents, at zero offsets
        off = {"attn": [torch.zeros(attn_shape, dtype=dt, device=dev, requires_grad=True)
                        for _ in range(D)],
               "mlp": [torch.zeros(tok_shape, dtype=dt, device=dev, requires_grad=True)
                       for _ in range(D)],
               "norm": torch.zeros(tok_shape, dtype=dt, device=dev, requires_grad=True)}
        probes = ViTSurgery(
            scores_post=lambda sc, m: sc + off["attn"][m["block"]],
            mlp_branch_pre=lambda h, m: h + off["mlp"][m["block"]],
            block_out_post=lambda o, m: o + off["norm"] if m["block"] == D - 1 else o)
        logits = with_surgery(self.model, probes).apply(x + state.delta).float()
        leaves = off["attn"] + off["mlp"] + [off["norm"]]
        cot = [c.float() for c in torch.autograd.grad(self.get_loss(logits[None], y), leaves)]
        attn_cot, mlp_cot, norm_cot = cot[:D], cot[D:2 * D], cot[-1]

        # walking from the deepest block, block b receives the damped records
        # of the deeper ones; visit k = D-1-b damps by 0.1·0.5^k
        def accumulate(recs, acc):
            adds = [None] * D
            for b in range(D - 1, -1, -1):
                adds[b] = acc
                acc = acc + recs[b] * 0.1 * (0.5 ** (D - 1 - b))
            return adds

        seed = torch.zeros(tok_shape, device=dev)
        seed[:, 0] = norm_cot[:, 0] * 0.1 * 0.5
        attn_add = accumulate(attn_cot, torch.zeros(attn_shape, device=dev))
        mlp_add = accumulate(mlp_cot, seed)

        # pass 2: the cotangents scaled, the records injected as ⟨add, p⟩
        side = []

        def scores_post(sc, m):
            side.append((attn_add[m["block"]] * sc).sum())
            return _scaled(sc, 0.25)

        def mlp_branch_pre(h, m):
            side.append((mlp_add[m["block"]] * h).sum())
            return _scaled(h, 0.5)

        delta = state.delta.detach().requires_grad_(True)
        view = with_surgery(self.model, ViTSurgery(scores_post=scores_post,
                                                   mlp_branch_pre=mlp_branch_pre))
        logits = view.apply(x + delta).float()
        self.grad_evals += 2
        (grad,) = torch.autograd.grad(self.get_loss(logits[None], y) + sum(side), delta)
        return grad, {}


class FPR(MIFGSM):
    """Feature-map perturbation and refinement: noisy re-softmaxed attention
    maps at blocks {0, 1, 4, 9, 11}; each attention and MLP output scaled
    ×0.8 and added to the last iteration's, decayed by 0.3, the accumulators
    carried in the state."""

    noisy_blocks = (0, 1, 4, 9, 11)

    def __init__(self, model_name="vit_base_patch16_224", attn_range=25.0,
                 scale=0.8, mom_decay=0.3, **kwargs):
        kwargs.setdefault("attack", "fpr")
        super().__init__(vit_model(model_name, kwargs), **kwargs)
        self.attn_range = float(attn_range)
        self.scale = float(scale)
        self.mom_decay = float(mom_decay)
        self.depth = self.model.module.backbone.depth

    def init_extra(self, x, y):
        _, tok_shape = vit_shapes(self.model, x.shape[0])
        zeros = torch.zeros((self.depth,) + tok_shape, device=x.device)
        return {"attn_acc": zeros, "mlp_acc": zeros.clone()}

    def attn_noise(self, gen, step: int, block: int, shape, dtype):
        """Per-head U(1 − range, 1 + range) multiplier of a (h, N, N) map,
        shared over the batch (JAX's seam)."""
        u = draw(gen, torch.rand, shape, device=self.device)
        return (u * (2 * self.attn_range) + (1 - self.attn_range)).to(dtype)

    def get_grad(self, x, y, state: AttackState, gen):
        attn_acc, mlp_acc = state.extra["attn_acc"], state.extra["mlp_acc"]
        new_attn, new_mlp = [None] * self.depth, [None] * self.depth

        def attn_post(attn, m):
            b = m["block"]
            if b not in self.noisy_blocks:
                return attn
            noise = self.attn_noise(gen, state.step, b, attn.shape[1:], attn.dtype)
            return (attn * noise[None]).softmax(dim=-1)

        # the hooked outputs are the next iteration's accumulators
        def attn_out_post(out, m):
            out = (self.mom_decay * attn_acc[m["block"]] + out * self.scale).to(out.dtype)
            new_attn[m["block"]] = out.detach().float()
            return out

        def mlp_out_post(out, m):
            out = (self.mom_decay * mlp_acc[m["block"]] + out * self.scale).to(out.dtype)
            new_mlp[m["block"]] = out.detach().float()
            return out

        view = with_surgery(self.model, ViTSurgery(
            attn_post=attn_post, attn_out_post=attn_out_post, mlp_out_post=mlp_out_post))
        delta = state.delta.detach().requires_grad_(True)
        logits = view.apply(x + delta).float()
        self.grad_evals += 1
        (grad,) = torch.autograd.grad(self.get_loss(logits[None], y), delta)
        return grad, {"attn_acc": torch.stack(new_attn), "mlp_acc": torch.stack(new_mlp)}


class ATT(MIFGSM):
    """Adaptive token tuning: a probe pass records each path's cotangent
    variance a block (attention map, qkv, MLP input); the attack pass scales
    each path's backward by GPF = clamp(γ + λ(1 − √(var/var_ref)), 0, 1),
    var_ref the first iteration's, on a PatchOut input."""

    def __init__(self, model_name="vit_base_patch16_224", lam=0.01, gamma=0.5,
                 crop_length=16, sample_num_patches=130, **kwargs):
        kwargs.setdefault("attack", "ATT")
        super().__init__(vit_model(model_name, kwargs), **kwargs)
        self.lam = float(lam)
        self.gamma = float(gamma)
        self.crop_length = int(crop_length)
        self.sample_num_patches = int(sample_num_patches)
        self.depth = self.model.module.backbone.depth

    def init_extra(self, x, y):
        return {"var_ref": {k: torch.full((self.depth,), -1.0, device=x.device)
                            for k in ("attn", "qkv", "mlp")}}

    def patchout_mask(self, gen, x):
        """This iteration's patch mask (JAX's ``_patchout_mask``)."""
        return patchout_keep(gen, x.shape, min(self.crop_length, x.shape[1]),
                             self.sample_num_patches, x.device)

    def get_grad(self, x, y, state: AttackState, gen):
        D = self.depth
        attn_shape, tok_shape = vit_shapes(self.model, x.shape[0])
        shapes = {"attn": attn_shape, "qkv": tok_shape[:-1] + (tok_shape[-1] * 3,),
                  "mlp": tok_shape}
        dt, dev = _dtype(self.model), x.device

        # probe pass: the plain cotangents' variances
        off = {k: [torch.zeros(s, dtype=dt, device=dev, requires_grad=True) for _ in range(D)]
               for k, s in shapes.items()}
        probes = ViTSurgery(attn_post=lambda a, m: a + off["attn"][m["block"]],
                            qkv_post=lambda q, m: q + off["qkv"][m["block"]],
                            mlp_in_post=lambda h, m: h + off["mlp"][m["block"]])
        logits = with_surgery(self.model, probes).apply(x + state.delta).float()
        keys = ("attn", "qkv", "mlp")
        cots = torch.autograd.grad(self.get_loss(logits[None], y),
                                   [t for k in keys for t in off[k]])
        cur = {k: torch.stack([self.batch_var(c.float()) for c in cots[i * D:(i + 1) * D]])
               for i, k in enumerate(keys)}
        ref = state.extra["var_ref"]
        var_ref = {k: torch.where(ref[k] < 0, cur[k], ref[k]) for k in keys}
        gpf = {k: torch.clamp(self.gamma + self.lam * (1 - torch.sqrt(
            cur[k] / (var_ref[k] + 1e-12))), 0.0, 1.0) for k in keys}

        mask = self.patchout_mask(gen, x)
        scaled = ViTSurgery(
            attn_post=lambda a, m: _scaled(a, gpf["attn"][m["block"]].to(a.dtype)),
            qkv_post=lambda q, m: _scaled(q, gpf["qkv"][m["block"]].to(q.dtype)),
            mlp_in_post=lambda h, m: _scaled(h, gpf["mlp"][m["block"]].to(h.dtype)))
        delta = state.delta.detach().requires_grad_(True)
        logits = with_surgery(self.model, scaled).apply(x + delta * mask).float()
        self.grad_evals += 2
        (grad,) = torch.autograd.grad(self.get_loss(logits[None], y), delta)
        return grad, {"var_ref": var_ref}


class TRMHead(nn.Module):
    """Token-refinement head of SETR's ``deit_ensemble.py``: one conv and BN
    pair applied twice over the patch grid (the reference's second assignment
    overwrites the first), an identity shortcut, a global mean, plus a
    linear map of the class token."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, padding=1, bias=False)
        self.bn = nn.BatchNorm2d(dim, eps=1e-5)
        self.token_fc = nn.Linear(dim, dim)

    def forward(self, tokens):
        cls_tok, patches = tokens[:, 0], tokens[:, 1:]
        b, n, d = patches.shape
        s = int(round(n ** 0.5))
        p = patches.transpose(1, 2).reshape(b, d, s, s)
        f = torch.relu(self.bn(self.conv(p)))
        f = torch.relu(self.bn(self.conv(f)) + p)
        return f.mean(dim=(2, 3)) + self.token_fc(cls_tok)


class TRMHeads(nn.Module):
    """One refinement head a non-final block, JAX's names
    (``transformerheads_{i}``)."""

    def __init__(self, dim: int, depth: int):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            setattr(self, f"transformerheads_{i}", TRMHead(dim))

    def forward(self, token_list):
        return [getattr(self, f"transformerheads_{i}")(t) for i, t in enumerate(token_list)]


class SETR(MIFGSM):
    """Self-ensemble and token refinement: the CE of the final logits plus
    that of every non-final block's final-norm'd tokens, each through its
    refinement head (``trm=True``, weights from
    ``$TA_TPU_WEIGHTS_DIR/setr_trm_<model>.npz``) or, without that file (a
    warning and a recorded fallback) or with ``trm=False``, its class token,
    then the shared classifier."""

    def __init__(self, model_name="vit_base_patch16_224", trm=True, **kwargs):
        kwargs.setdefault("attack", "SETR")
        super().__init__(vit_model(model_name, kwargs), **kwargs)
        bb = self.model.module.backbone
        self.depth = bb.depth
        self.trm = None
        if trm:
            name = model_name if isinstance(model_name, str) else self.model.name
            path = aux_path(f"setr_trm_{name}")
            if path is not None:
                self.trm = TRMHeads(bb.dim, self.depth - 1)
                load_flat_variables(self.trm, load_npz(path))
                self.trm.eval().requires_grad_(False).to(self.device)
            else:
                record_fallback(f"setr_trm_{name}")
                warnings.warn(f"SETR: TRM checkpoint setr_trm_{name}.npz missing under "
                              f"{weights_root()}; falling "
                              "back to the trm=False self-ensemble loss.")

    def get_grad(self, x, y, state: AttackState, gen):
        bb = self.model.module.backbone
        taps = [f"blocks_{b}" for b in range(self.depth - 1)]
        delta = state.delta.detach().requires_grad_(True)
        logits, feats = self.model.features(x + delta, taps)
        self.grad_evals += 1
        total = softmax_cross_entropy(logits.float(), y).mean()
        toks = [bb.norm(feats[t]) for t in taps]
        if self.trm is not None:
            outs = self.trm([t.float() for t in toks])
        else:
            outs = [t[:, 0] for t in toks]
        for out in outs:
            total = total + softmax_cross_entropy(bb.head(out.to(bb.head.weight.dtype)).float(),
                                                  y).mean()
        (grad,) = torch.autograd.grad(-total if self.targeted else total, delta)
        return grad, {}
