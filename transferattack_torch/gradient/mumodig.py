"""MUMODIG, multiple monotonic diversified integrated gradients (counterpart
of ``gradient/mumodig.py``).

Integrated gradients along the path from a per-channel random lower-bound
quantization baseline, plus the same on ``N_trans`` randomly transformed
copies (roll, flip, rotation, resize-and-pad).  The rotation is exact
bilinear (JAX uses three shears) and the resize-and-pad is
``scale_and_translate``.  Every integration point of an iteration goes
through the surrogate in one batch, each as a leaf of its own.  The draws
are the seam :meth:`MUMODIG.ig_draws`.
"""
from __future__ import annotations

import math

import torch

from ..attack import AttackState, draw, draw_rows
from ..ops.image import rotate, scale_and_translate
from .mifgsm import MIFGSM


def lb_quantize(x, u, region_num: int):
    """Lower-bound quantization baseline: per (image, channel),
    ``region_num − 1`` thresholds at fractions ``u`` (B·C, R − 1) between
    the min and the max; each pixel maps to its region's left end."""
    B, H, W, C = x.shape
    flat = x.permute(0, 3, 1, 2).reshape(B * C, H * W)
    mn, mx = flat.min(1).values, flat.max(1).values
    thresholds = u * (mx - mn)[:, None] + mn[:, None]
    lefts = torch.sort(torch.cat([mn[:, None], thresholds], 1), 1).values
    idx = ((flat[:, :, None] >= lefts[:, None, :]).sum(-1) - 1).clamp(0, region_num - 1)
    return lefts.gather(1, idx).reshape(B, C, H, W).permute(0, 2, 3, 1)


def transform_draws(gen, x, split=None) -> dict:
    """One random transform: branch 0 is one of vshift, hshift, vflip, hflip
    and rotate (``op``), branch 1 a resize into a 245 canvas and pad
    (``split``: an attack's ``data_split``, for the per-image angles)."""
    B, H, W, C = x.shape
    dev = x.device
    if int(draw(gen, torch.randint, 0, 2, (), device=dev)) == 0:
        op = int(draw(gen, torch.randint, 0, 5, (), device=dev))
        d = {"branch": 0, "op": op}
        if op in (0, 1):
            d["shift"] = int(draw(gen, torch.randint, 0, H if op == 0 else W, (), device=dev))
        elif op == 4:
            d["angle"] = draw_rows(split, gen, torch.rand, B, device=dev) * 90.0 - 45.0
        return d
    lo, hi = min(W, 245), max(W, 245)
    inter = (draw(gen, torch.randint, lo, hi, (), device=dev) if hi > lo
             else torch.tensor(lo, device=dev)).float()
    top = draw(gen, torch.rand, (), device=dev) * (245.0 - inter)
    left = draw(gen, torch.rand, (), device=dev) * (245.0 - inter)
    return {"branch": 1, "inter": inter, "top": top, "left": left}


def rand_transform(x, d: dict):
    """Apply the transform of :func:`transform_draws` (``angle`` in degrees)."""
    H, W = x.shape[1], x.shape[2]
    if d["branch"] == 0:
        op = d["op"]
        if op in (0, 1):
            return torch.roll(x, d["shift"], dims=op + 1)
        if op in (2, 3):
            return x.flip(op - 1)
        return rotate(x, d["angle"] * math.pi / 180.0)
    scale = d["inter"] / 245.0
    return scale_and_translate(x, (H, W), (scale, scale),
                               (d["top"] * H / 245.0, d["left"] * W / 245.0))


class MUMODIG(MIFGSM):
    """Official args: N_trans=6, N_base=1, N_interpolate=1, region_num=2,
    lamb=0.65."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, N_trans=6, N_base=1, N_interpolate=1, region_num=2,
                 lamb=0.65, targeted=False, random_start=False, norm="linfty",
                 loss="crossentropy", attack="MUMODIG", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.N_trans = int(N_trans)
        self.N_base = int(N_base)
        self.N_interpolate = int(N_interpolate)
        self.region_num = int(region_num)
        self.lamb = float(lamb)

    def ig_draws(self, gen, x, state):
        """The quantization fractions of the ``N_base`` baselines of x, and
        for each of the ``N_trans`` copies its transform and its baseline's
        fractions."""
        dev = x.device
        n_u = (x.shape[0], x.shape[3], self.region_num - 1)  # (B·C, R − 1) by rows

        def fractions():
            return self.draw_rows(gen, torch.rand, n_u, device=dev).reshape(-1, n_u[-1])

        base = [fractions() for _ in range(self.N_base)]
        trans = [(transform_draws(gen, x, self.data_split), fractions())
                 for _ in range(self.N_trans)]
        return {"base": base, "trans": trans}

    def get_grad(self, x, y, state: AttackState, gen):
        draws = self.ig_draws(gen, x, state)
        xadv = (x + state.delta).detach()
        # (transform or None, baseline, path) of each integration path
        paths = []
        for u in draws["base"]:
            baseline = lb_quantize(xadv, u, self.region_num)
            paths.append((None, baseline, xadv - baseline))
        for d, u in draws["trans"]:
            x_t = rand_transform(xadv, d)
            baseline = lb_quantize(x_t, u, self.region_num)
            paths.append((d, baseline, x_t - baseline))
        ni = self.N_interpolate
        leaves = xadv[None].repeat(len(paths) * ni, 1, 1, 1, 1).requires_grad_(True)
        views = []
        for k, (d, baseline, _) in enumerate(paths):
            for i in range(ni):
                p = leaves[k * ni + i]
                p = p if d is None else rand_transform(p, d)
                views.append(baseline + (i + self.lamb) / ni * (p - baseline))
        logits = self.get_logits(torch.stack(views))
        self.grad_evals += logits.shape[0]
        loss = sum(self.get_loss(lg[None], y) for lg in logits)
        (g,) = torch.autograd.grad(loss, leaves)
        g = g.reshape((len(paths), ni) + x.shape).sum(1)
        return sum(g[k] * path for k, (_, _, path) in enumerate(paths)), {}
