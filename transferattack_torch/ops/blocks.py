"""Blockwise index maps (SIA and BSR machinery; counterpart of
``transferattack_tpu/ops/blocks.py``).

Cut points are drawn from a ``torch.Generator``; every index map is a pure
function of the drawn edges, so a test can feed the edges JAX drew.
"""
from __future__ import annotations

import torch

from ..attack import draw


def random_cuts(gen: torch.Generator, size: int, num_block: int, device=None) -> torch.Tensor:
    """``num_block - 1`` distinct interior cut points in ``[1, size)``,
    sorted, as block right edges (the last is ``size``): SIA's
    ``np.random.choice(range(1, size), num_block - 1, replace=False)``."""
    scores = draw(gen, torch.rand, size - 1, device=device)
    cuts = torch.sort(torch.topk(scores, num_block - 1).indices + 1).values
    return torch.cat([cuts, torch.tensor([size], device=cuts.device)])


def bsr_lengths(gen: torch.Generator, size: int, num_block: int, device=None) -> torch.Tensor:
    """BSR's random split: lengths proportional to uniform(0, 2) draws,
    summing to ``size``, returned as right edges."""
    r = draw(gen, torch.rand, num_block, device=device) * 2.0
    ends = torch.round(torch.cumsum(r, 0) / r.sum() * size).long()
    ends[-1] = size
    return ends


def block_id(edges: torch.Tensor, size: int) -> torch.Tensor:
    """Block index of each position: ``id[p] = #edges <= p``."""
    pos = torch.arange(size, device=edges.device)
    return (pos[:, None] >= edges[None, :]).sum(1)


def block_bounds(edges: torch.Tensor):
    """(starts, lengths) from right edges."""
    starts = torch.cat([edges.new_zeros(1), edges[:-1]])
    return starts, edges - starts


def permute_strips(edges: torch.Tensor, perm: torch.Tensor, size: int) -> torch.Tensor:
    """Index map of a strip shuffle: output position p reads input position
    ``map[p]``, the strips (cut at ``edges``) reordered by ``perm``."""
    starts, lengths = block_bounds(edges)
    out_lengths = lengths[perm]
    out_ends = torch.cumsum(out_lengths, 0)
    out_starts = out_ends - out_lengths
    pos = torch.arange(size, device=edges.device)
    oid = (pos[:, None] >= out_ends[None, :]).sum(1)
    return starts[perm[oid]] + pos - out_starts[oid]
