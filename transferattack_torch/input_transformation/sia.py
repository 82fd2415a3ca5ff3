"""SIA, the structure-invariant attack (counterpart of
``input_transformation/sia.py``).

Each of ``num_scale`` copies cuts the image into a ``num_block`` ×
``num_block`` grid at random points and applies one of seven random ops to
each cell (shift, flip, rotation by 180°, scale, noise), as per-pixel index
maps and one gather.  :func:`sia_draws` draws a copy's parameters and
:func:`sia_apply` applies them, so a test can feed JAX's draws.
"""
from __future__ import annotations

import torch

from ..attack import AttackState, draw, draw_rows
from ..gradient.mifgsm import MIFGSM
from ..ops.blocks import block_bounds, block_id, random_cuts

# 0 vshift, 1 hshift, 2 vflip, 3 hflip, 4 rot180, 5 scale, 6 noise
NUM_OPS = 7


def sia_draws(gen, x, num_block: int, eps_noise: float = 16 / 255, split=None) -> dict:
    """One copy's draws: the cut edges of rows and columns, an op, two
    fractional shifts and a scale a cell, and a noise image (``split``: an
    attack's ``data_split``, whose rows of the one-process noise it takes)."""
    B, H, W, C = x.shape
    dev = x.device
    cells = (num_block, num_block)
    return {
        "h_edges": random_cuts(gen, H, num_block, dev),
        "w_edges": random_cuts(gen, W, num_block, dev),
        "ops": draw(gen, torch.randint, 0, NUM_OPS, cells, device=dev),
        "shift_v": draw(gen, torch.rand, cells, device=dev),
        "shift_h": draw(gen, torch.rand, cells, device=dev),
        "scale": draw(gen, torch.rand, cells, device=dev),
        "noise": (draw_rows(split, gen, torch.rand, x.shape, device=dev)
                  * (2 * eps_noise) - eps_noise),
    }


def sia_apply(x, h_edges, w_edges, ops, shift_v, shift_h, scale, noise):
    """One SIA copy from its draws (JAX's ``_sia_apply``)."""
    B, H, W, C = x.shape
    h_id, w_id = block_id(h_edges, H), block_id(w_edges, W)
    h_starts, h_lens = block_bounds(h_edges)
    w_starts, w_lens = block_bounds(w_edges)
    bi, bj = h_id[:, None], w_id[None, :]
    op = ops[bi, bj]  # (H, W)
    a, lh = h_starts[bi], h_lens[bi]
    c0, lw = w_starts[bj], w_lens[bj]
    r = torch.arange(H, device=x.device)[:, None]
    c = torch.arange(W, device=x.device)[None, :]
    step_v = (shift_v[bi, bj] * lh).long()
    step_h = (shift_h[bi, bj] * lw).long()
    src_r = torch.where(op == 0, a + torch.remainder(r - a + step_v, lh),
                        torch.where((op == 2) | (op == 4), a + (lh - 1) - (r - a), r))
    src_c = torch.where(op == 1, c0 + torch.remainder(c - c0 + step_h, lw),
                        torch.where((op == 3) | (op == 4), c0 + (lw - 1) - (c - c0), c))
    gathered = x[:, src_r, src_c, :]
    cell_scale = torch.where(op == 5, scale[bi, bj], torch.ones_like(scale[bi, bj]))
    out = gathered * cell_scale[None, :, :, None].to(x.dtype)
    noisy = torch.clamp(gathered + noise, 0.0, 1.0)
    return torch.where((op == 6)[None, :, :, None], noisy, out)


def sia_blocktransform(x, gen, num_block: int, eps_noise: float = 16 / 255, params=None,
                       split=None):
    """One SIA copy; ``params`` (the keys of :func:`sia_draws`) bypasses
    the draws, as JAX's ``params=`` does."""
    if params is None:
        params = sia_draws(gen, x, num_block, eps_noise, split)
    return sia_apply(x, **params)


class SIA(MIFGSM):
    """Official args: num_scale=20, num_block=3."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, num_scale=20, num_block=3, targeted=False,
                 random_start=False, norm="linfty", loss="crossentropy",
                 attack="SIA", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.num_scale = int(num_scale)
        self.num_block = int(num_block)

    def num_copies(self):
        return self.num_scale

    def transform(self, x, state: AttackState, gen):
        return torch.stack([sia_blocktransform(x, gen, self.num_block, split=self.data_split)
                            for _ in range(self.num_scale)])
