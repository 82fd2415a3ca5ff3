"""BSR, block shuffle and rotation (counterpart of
``input_transformation/bsr.py``).

Each copy cuts the image into strips at random proportional cuts, rotates
each strip about its own center (bilinear, zero outside the strip, up to
±24°), shuffles sub-strips of each strip along the other axis, then shuffles
the strips; half the copies work on columns first.  The rotation is exact
bilinear through ``grid_sample`` (JAX uses three shears, a TPU stand-in);
the shuffles are index maps.  :func:`bsr_draws` draws a copy's parameters
and :func:`bsr_apply` applies them, the keys being those of JAX's
``params=``.
"""
from __future__ import annotations

import math

import torch

from ..attack import AttackState, draw
from ..gradient.mifgsm import MIFGSM
from ..ops.blocks import block_bounds, block_id, bsr_lengths, permute_strips
from ..ops.image import grid_sample


def bsr_draws(gen, x, num_block: int, max_angle_deg: float = 24.0) -> dict:
    """One copy's draws: orientation, row-strip edges and angles (radians),
    each strip's column edges and permutation, and the strip permutation."""
    dev = x.device
    flip = draw(gen, torch.rand, (), device=dev) < 0.5
    size = x.shape[2] if bool(flip) else x.shape[1]
    other = x.shape[1] if bool(flip) else x.shape[2]
    h_edges = bsr_lengths(gen, size, num_block, dev)
    angles = ((draw(gen, torch.rand, num_block, device=dev) * 2 - 1)
              * max_angle_deg * math.pi / 180.0)
    w_edges = torch.stack([bsr_lengths(gen, other, num_block, dev) for _ in range(num_block)])
    col_perms = torch.stack([draw(gen, torch.randperm, num_block, device=dev)
                             for _ in range(num_block)])
    row_perm = draw(gen, torch.randperm, num_block, device=dev)
    return {"flip": flip, "h_edges": h_edges, "angles": angles, "w_edges": w_edges,
            "col_perms": col_perms, "row_perm": row_perm}


def rotate_row_strips(x, h_edges, angles):
    """Rotate each row strip about its own center by its angle (radians),
    bilinear, reading zero outside the strip: the strip's rotation as an
    image of its own, in pixel units."""
    B, H, W, C = x.shape
    h_id = block_id(h_edges, H)
    starts, lens = block_bounds(h_edges)
    rows = torch.arange(H, dtype=torch.float32, device=x.device)[:, None]
    cols = torch.arange(W, dtype=torch.float32, device=x.device)[None, :]
    cy = (starts[h_id] + (lens[h_id] - 1) / 2.0).float()[:, None]
    cx = (W - 1) / 2.0
    theta = angles[h_id].float()[:, None]
    cos, sin = torch.cos(theta), torch.sin(theta)
    u, v = cols - cx, rows - cy
    src_c = cx + u * cos + v * sin
    src_r = cy - u * sin + v * cos
    grid = torch.stack([(2 * src_c + 1) / W - 1, (2 * src_r + 1) / H - 1], -1)
    grid = grid[None].expand(B, H, W, 2)
    out = torch.zeros_like(x)
    for s in range(h_edges.shape[0]):
        inside = (h_id == s).to(x.dtype)[None, :, None, None]
        out = out + inside * grid_sample(x * inside, grid)
    return out


def shuffle_rows_first(x, h_edges, angles, w_edges, col_perms, row_perm):
    """Rotate the row strips, shuffle each strip's column blocks, then shuffle
    the row strips."""
    B, H, W, C = x.shape
    rotated = rotate_row_strips(x, h_edges, angles)
    colmap = torch.stack([permute_strips(w_edges[s], col_perms[s], W)
                          for s in range(h_edges.shape[0])])
    rowmap = permute_strips(h_edges, row_perm, H)
    src_cols = colmap[block_id(h_edges, H)[rowmap]]  # (H, W)
    taken = rotated[:, rowmap]
    return torch.gather(taken, 2, src_cols[None, :, :, None].expand(B, H, W, C))


def bsr_apply(x, flip, **params):
    """One BSR copy from its draws; ``flip`` works on columns first."""
    if bool(flip):
        return shuffle_rows_first(x.transpose(1, 2), **params).transpose(1, 2)
    return shuffle_rows_first(x, **params)


def bsr_one_copy(x, gen, num_block: int, params=None):
    """One copy; ``params`` (the keys of :func:`bsr_draws`) bypasses the
    draws, as JAX's ``params=`` does."""
    if params is None:
        params = bsr_draws(gen, x, num_block)
    return bsr_apply(x, **params)


class BSR(MIFGSM):
    """Official args: num_scale=20, num_block=3."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, num_scale=20, num_block=3, targeted=False,
                 random_start=False, norm="linfty", loss="crossentropy",
                 attack="BSR", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.num_scale = int(num_scale)
        self.num_block = int(num_block)

    def num_copies(self):
        return self.num_scale

    def transform(self, x, state: AttackState, gen):
        return torch.stack([bsr_one_copy(x, gen, self.num_block)
                            for _ in range(self.num_scale)])
