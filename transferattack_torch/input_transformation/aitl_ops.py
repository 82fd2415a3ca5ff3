"""AITL's 20 input transformations (counterpart of ``aitl_ops.py``; the
reference's ``input_transformation/aitl.py:280-533``), indexed 1..20.

Each op is split into its draws (:func:`op_draws`, JAX's bounds and shapes)
and an apply step (:func:`apply_op`), so that a test can feed the values
JAX drew.  The six affine ops (translate x/y, shear x/y, reshape, rotate)
warp exactly through :func:`~..ops.image.affine_warp`, where JAX takes its
gather-free stand-in; the crop is the antialiased ``scale_and_translate``.

The reference's quirks are kept, as JAX keeps them: the inversion returns
``−x``, the rotation takes radians as degrees (±0.52°), and the sharpness
kernel sums the smoothed RGB channels into one map.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..attack import draw, draw_rows
from ..ops.image import affine_warp, scale_and_translate
from .dim import resize_pad, resize_pad_draws

AITL_OPS = ("crop", "brightness", "color", "translate_x", "translate_y", "admix",
            "shear_y", "resize", "contrast", "cutout", "hue", "invert", "reshape", "gamma",
            "sharpness", "shear_x", "scale", "rotate", "admix_and_scale", "saturation")


def op_draws(gen, index: int, x_shape, device=None, split=None) -> dict:
    """The random values of op ``index`` (1-based) on a batch of
    ``x_shape`` (``split``: an attack's ``data_split``, whose rows of the
    per-image draws it takes)."""
    B, H, W = x_shape[:3]
    op = AITL_OPS[index - 1]

    def u(lo, hi, shape=()):  # a shape other than () has the batch's rows on axis 0
        fn = draw if shape == () else functools.partial(draw_rows, split)
        return fn(gen, torch.rand, shape, device=device) * (hi - lo) + lo

    def pow2():
        return 2.0 ** draw(gen, torch.randint, 0, 5, (), device=device).float()

    if op == "crop":
        rnd = draw(gen, torch.randint, min(200, H - 1), H, (), device=device).float()
        return {"rnd": rnd, "top": torch.floor(u(0.0, 1.0) * (H - rnd)),
                "left": torch.floor(u(0.0, 1.0) * (W - rnd))}
    if op in ("brightness", "color", "contrast", "sharpness"):
        return {"f": u(0.5, 1.5)}
    if op in ("translate_x", "translate_y"):
        return {"t": u(-0.4, 0.4)}
    if op in ("shear_x", "shear_y"):
        return {"f": u(-0.5, 0.5)}
    if op == "admix":
        return {"perm": draw_rows(split, gen, torch.randperm, B, device=device)}
    if op == "resize":
        return resize_pad_draws(gen, H, 1.15, 1.0, device)
    if op == "cutout":
        return {"u_top": u(0.0, 1.0), "u_left": u(0.0, 1.0)}
    if op == "hue":
        return {"d": u(-0.2, 0.2, (B, 1, 1))}
    if op == "invert":
        return {}
    if op == "reshape":
        return {"sx": u(0.5, 1.5), "sy": u(0.5, 1.5), "shx": u(-0.5, 0.5),
                "shy": u(-0.5, 0.5), "tx": u(-0.5, 0.5), "ty": u(-0.5, 0.5)}
    if op == "gamma":
        return {"g": u(0.0, 2.0, (B, 1, 1, 1))}
    if op == "scale":
        return {"s": pow2()}
    if op == "rotate":
        return {"angle": u(-math.pi / 6, math.pi / 6)}
    if op == "admix_and_scale":
        return {"perm": draw_rows(split, gen, torch.randperm, B, device=device), "s": pow2()}
    if op == "saturation":
        return {"f": u(0.0, 11.0)}
    raise KeyError(index)


def _blend(degenerate, x, factor):
    return torch.clamp(degenerate * (1 - factor) + x * factor, 0.0, 1.0)


def _gray(x):
    return (0.2989 * x[..., 0] + 0.5870 * x[..., 1] + 0.1140 * x[..., 2])[..., None]


def _affine(x, a, b, tx, c, d, ty):
    """One 2×3 matrix (output → input, normalized coordinates) for the
    batch, warped exactly."""
    v = [torch.as_tensor(t, dtype=torch.float32, device=x.device) for t in (a, b, tx, c, d, ty)]
    theta = torch.stack([torch.stack(v[:3]), torch.stack(v[3:])])
    return affine_warp(x, theta.expand(x.shape[0], 2, 3))


def rgb_to_hsv(x):
    """(h, s, v) in [0, 1] of NHWC RGB; ``amax``/``amin`` share a tie's
    gradient, as JAX's ``max``/``min`` do; ``%`` is floor modulo."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx, mn = torch.amax(x, dim=-1), torch.amin(x, dim=-1)
    df = mx - mn + 1e-12
    h = torch.where(mx == r, torch.remainder((g - b) / df, 6.0),
                    torch.where(mx == g, (b - r) / df + 2.0, (r - g) / df + 4.0)) / 6.0
    s = torch.where(mx > 0, df / (mx + 1e-12), torch.zeros_like(mx))
    return torch.stack([h, s, mx], dim=-1)


def hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0] * 6.0, hsv[..., 1], hsv[..., 2]
    i = torch.floor(h)
    f = h - i
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    i = i.long() % 6

    def pick(*vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


def apply_op(x, index: int, draws: dict, whole=None):
    """Op ``index`` (1-based) on NHWC ``x`` with its draws; ``whole`` gives
    the whole batch's rows of ``x`` that Admix's partners index (``x``
    itself by default)."""
    partners = x if whole is None or "perm" not in draws else whole(x)
    op = AITL_OPS[index - 1]
    H, W = x.shape[1], x.shape[2]
    if op == "crop":
        s = draws["rnd"] / H
        return scale_and_translate(x, (H, W), (s, s), (draws["top"], draws["left"]))
    if op == "brightness":
        return _blend(torch.zeros_like(x), x, draws["f"])
    if op == "color":
        return _blend(_gray(x).expand(x.shape), x, draws["f"])
    if op == "translate_x":
        return _affine(x, 1.0, 0.0, draws["t"], 0.0, 1.0, 0.0)
    if op == "translate_y":
        return _affine(x, 1.0, 0.0, 0.0, 0.0, 1.0, draws["t"])
    if op == "admix":
        return torch.clamp(x + 0.2 * partners[draws["perm"]], 0.0, 1.0)
    if op == "shear_y":
        return _affine(x, 1.0, 0.0, 0.0, draws["f"], 1.0, 0.0)
    if op == "resize":
        return resize_pad(x, **draws)
    if op == "contrast":
        mean = _gray(x).mean(dim=(1, 2, 3), keepdim=True)
        return _blend(torch.ones_like(x) * mean, x, draws["f"])
    if op == "cutout":  # RandomErasing(p=1, scale=0.04, ratio=0.4, value=0)
        area = 0.04 * H * W
        h = math.sqrt(area * 0.4)
        w = area / h
        top, left = draws["u_top"] * (H - h), draws["u_left"] * (W - w)
        rows = torch.arange(H, dtype=x.dtype, device=x.device)[None, :, None, None]
        cols = torch.arange(W, dtype=x.dtype, device=x.device)[None, None, :, None]
        inside = (rows >= top) & (rows < top + h) & (cols >= left) & (cols < left + w)
        return torch.where(inside, torch.zeros_like(x), x)
    if op == "hue":  # hue is circular: wrap, as torchvision's adjust_hue
        hsv = rgb_to_hsv(x)
        return hsv_to_rgb(torch.cat([torch.remainder(hsv[..., :1] + draws["d"][..., None], 1.0),
                                     torch.clamp(hsv[..., 1:], 0.0, 1.0)], dim=-1))
    if op == "invert":
        return -x
    if op == "reshape":
        d = draws
        return _affine(x, d["sx"], d["shx"], d["tx"], d["shy"], d["sy"], d["ty"])
    if op == "gamma":
        return torch.clamp(torch.pow(x + 1e-10, draws["g"]), 0.0, 1.0)
    if op == "sharpness":
        k = torch.tensor([[1, 1, 1], [1, 5, 1], [1, 1, 1]], dtype=x.dtype,
                         device=x.device) / 13.0
        deg = F.conv2d(x.permute(0, 3, 1, 2), k.expand(1, 3, 3, 3), padding=1)
        return _blend(deg.permute(0, 2, 3, 1), x, draws["f"])
    if op == "shear_x":
        return _affine(x, 1.0, draws["f"], 0.0, 0.0, 1.0, 0.0)
    if op == "scale":
        return x / draws["s"]
    if op == "rotate":  # radians read as degrees, as the reference passes them
        ang = draws["angle"] * (math.pi / 180.0)
        c, s = torch.cos(ang), torch.sin(ang)
        return _affine(x, c, -s, 0.0, s, c, 0.0)
    if op == "admix_and_scale":
        return torch.clamp((x + 0.2 * partners[draws["perm"]]) / draws["s"], 0.0, 1.0)
    if op == "saturation":  # ColorJitter(saturation=10): U[0, 11] against gray
        return _blend(_gray(x).expand(x.shape), x, draws["f"])
    raise KeyError(index)
