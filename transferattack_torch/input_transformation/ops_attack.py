"""OPS, operator and perturbation sampling (counterpart of
``input_transformation/ops_attack.py``).

Each iteration: the gradient at x + delta, plus the gradients at
``num_sample_neighbor`` noise offsets drawn from a pool, each offset viewed
through ``num_sample_operator`` random chains (2 to 4 long) of 31 basic ops
(flips, rolls, rotations, scalings and DIM at ten rates).  A neighbour's
chains go through the surrogate ``op_chunk`` chains a batch, as the
gradient of their summed loss.  The pool comes from ``seed + 1`` in
``init_extra``; the other draws are the seam :meth:`OPS.chain_draws`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..attack import Attack, AttackState, draw
from ..ops.image import rotate_quarter_then
from .dim import resize_pad, resize_pad_draws

ROT_ANGLES = [5, -5, 15, -15, 45, -45, 90, -90, 180]
SCALES = [2, 3, 4, 5, 6, 7, 8]
DIM_RATES = [1.1, 1.3, 1.5, 1.7, 1.9, 2.1, 2.3, 2.5, 2.7, 2.9]
NUM_BASIC_OPS = 5 + len(ROT_ANGLES) + len(SCALES) + len(DIM_RATES)  # 31
_FIRST_SCALE = 5 + len(ROT_ANGLES)
_FIRST_DIM = _FIRST_SCALE + len(SCALES)


def basic_op_draws(gen, op_idx: int, x) -> dict:
    """The draws basic op ``op_idx`` takes (a roll's shift, a DIM draw)."""
    H, W = x.shape[1], x.shape[2]
    if op_idx in (3, 4):
        n = H if op_idx == 3 else W
        return {"shift": draw(gen, torch.randint, 0, n, (), device=x.device)}
    if op_idx >= _FIRST_DIM:
        return resize_pad_draws(gen, H, DIM_RATES[op_idx - _FIRST_DIM], 0.5, x.device)
    return {}


def apply_basic_op(x, op_idx: int, draws: dict):
    """Basic op ``op_idx`` (0..30) on an NHWC batch, from its draws."""
    if op_idx == 0:
        return x
    if op_idx == 1:
        return x.flip(1)
    if op_idx == 2:
        return x.flip(2)
    if op_idx in (3, 4):
        return torch.roll(x, int(draws["shift"]), dims=op_idx - 2)
    if op_idx < _FIRST_SCALE:
        return rotate_quarter_then(x, ROT_ANGLES[op_idx - 5])
    if op_idx < _FIRST_DIM:
        return x / SCALES[op_idx - _FIRST_SCALE]
    return resize_pad(x, **draws)


class OPS(Attack):
    """Official args: beta=2, num_sample_neighbor=30, num_sample_operator=30,
    levels 2-4, pool ratios 0.25..1.5, alpha=eps/epoch."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, beta=2.0,
                 num_sample_neighbor=30, num_sample_operator=30,
                 sample_levels=(2, 3, 4), decay=1.0, targeted=False,
                 random_start=False, norm="linfty", loss="crossentropy",
                 op_chunk=10, attack="OPS", **kwargs):
        kwargs.pop("alpha", None)
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=eps / epoch,
                         decay=decay, targeted=targeted, random_start=random_start,
                         norm=norm, loss=loss, attack=attack, **kwargs)
        self.beta = float(beta)
        self.num_sample_neighbor = int(num_sample_neighbor)
        self.num_sample_operator = int(num_sample_operator)
        self.sample_levels = tuple(sample_levels)
        self.max_level = max(self.sample_levels) if sample_levels else 0
        self.sample_ratios = np.arange(0.0, 1.5, 0.25) + 0.25
        self.op_chunk = int(op_chunk)
        self.using_sampling = self.num_sample_neighbor * self.num_sample_operator > 0

    def init_extra(self, x, y):
        if not self.using_sampling:
            return {}
        # per-image-shaped noises pooled over the six radii
        # the CPU's generator: one seed gives one pool on any device
        gen = torch.Generator().manual_seed(self.seed + 1)
        shape = (self.num_sample_neighbor,) + x.shape[1:]
        pools = [(draw(gen, torch.rand, shape, device=x.device) * 2 - 1)
                 * (self.beta * self.eps * r) for r in self.sample_ratios]
        return {"eps_pool": torch.cat(pools)}

    def chain_draws(self, gen, x, state):
        """The pool entries of this iteration's neighbours, and for each
        neighbour ``num_sample_operator`` chains: (op indices padded with
        the identity to ``max_level``, each op's draws)."""
        pool_n = state.extra["eps_pool"].shape[0]
        sel = draw(gen, torch.randperm, pool_n, device=x.device)[:self.num_sample_neighbor]
        chains = []
        for _ in range(self.num_sample_neighbor):
            ops = draw(gen, torch.randint, 0, NUM_BASIC_OPS,
                       (self.num_sample_operator, self.max_level), device=x.device)
            lvl = draw(gen, torch.randint, 0, len(self.sample_levels),
                       (self.num_sample_operator,), device=x.device)
            levels = torch.tensor(self.sample_levels, device=x.device)[lvl]
            ops = torch.where(torch.arange(self.max_level, device=x.device)[None]
                              < levels[:, None], ops, torch.zeros_like(ops)).tolist()
            chains.append([[(op, basic_op_draws(gen, op, x)) for op in row] for row in ops])
        return sel, chains

    def get_grad(self, x, y, state: AttackState, gen):
        grad = self.input_grad(x + state.delta, y, state, gen)
        if not self.using_sampling:
            return grad, {}
        pool = state.extra["eps_pool"]
        sel, chains = self.chain_draws(gen, x, state)
        total = torch.zeros_like(x)
        for e_idx, neighbour in zip(sel.tolist(), chains):
            base = x + state.delta + pool[e_idx][None]
            for c0 in range(0, len(neighbour), self.op_chunk):
                point = base.detach().requires_grad_(True)
                views = []
                for row in neighbour[c0:c0 + self.op_chunk]:
                    v = point
                    for op, draws in row:
                        v = apply_basic_op(v, op, draws)
                    views.append(v)
                logits = self.get_logits(torch.stack(views))
                self.grad_evals += logits.shape[0]
                loss = sum(self.get_loss(lg[None], y) for lg in logits)
                (g,) = torch.autograd.grad(loss, point)
                total = total + g
        n = self.num_sample_neighbor * self.num_sample_operator + 1
        return (grad + total) / n, {}
