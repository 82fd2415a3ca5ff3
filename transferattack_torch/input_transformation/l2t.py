"""L2T, learning to transform (counterpart of
``input_transformation/l2t.py``).

A learnable categorical distribution over 10 transformations: each
iteration samples ``num_scale`` chains of ``ops_num`` ops, attacks with
their mean loss (the chains through the surrogate as one batch), and
updates the distribution by REINFORCE on ∂(Σ p_chain·loss)/∂θ, kept in
``state.extra["aug_param"]``.  The seams are JAX's: :meth:`L2T.apply_op`
and :meth:`L2T.sample_ids`.  Each op's draws (:func:`op_draws`) are split
from its apply step (:func:`apply_l2t_op`).  The rotation is exact bilinear
(JAX uses three shears) and the translation is ``translate``.
"""
from __future__ import annotations

import torch

from ..attack import Attack, AttackState, draw, draw_rows
from ..ops.blocks import bsr_lengths, permute_strips
from ..ops.dct import dct_2d, idct_2d
from ..ops.image import rotate, scale_and_translate, translate
from .dim import resize_pad, resize_pad_draws

# rotate, sim, dim, blockshuffle, admix, ide, masked, ssm, crop, affine
NUM_OPS = 10


def op_draws(gen, op_idx: int, x, split=None) -> dict:
    """The draws op ``op_idx`` takes on the batch ``x`` (``split``: an
    attack's ``data_split``, whose rows of the per-image draws it takes)."""
    B, H, W, C = x.shape
    dev = x.device

    def uniform(shape, lo, hi):
        return draw(gen, torch.rand, shape, device=dev) * (hi - lo) + lo

    def rows(fn, *args):  # a draw with the batch's rows on axis 0
        return draw_rows(split, gen, fn, *args, device=dev)

    def uniform_rows(shape, lo, hi):
        return rows(torch.rand, shape) * (hi - lo) + lo

    if op_idx == 0:
        return {"angle": uniform_rows((B,), -0.2, 0.2)}
    if op_idx == 1:
        return {"power": draw(gen, torch.randint, 0, 5, (), device=dev)}
    if op_idx == 2:
        return {"dim": resize_pad_draws(gen, H, 1.1, 1.0, dev)}
    if op_idx == 3:
        return {"edges": bsr_lengths(gen, H, 3, dev),
                "perm": draw(gen, torch.randperm, 3, device=dev)}
    if op_idx == 4:
        return {"perm": rows(torch.randperm, B)}
    if op_idx == 5:
        return {"keep": rows(torch.rand, x.shape) < 0.9}
    if op_idx == 6:
        return {"cell": draw(gen, torch.rand, (4, 4), device=dev) < 0.75}
    if op_idx == 7:
        return {"gauss": rows(torch.randn, x.shape), "mask": uniform_rows(x.shape, 0.5, 1.5)}
    if op_idx == 8:
        side = uniform((), 0.8, 1.0)
        return {"side": side, "ty": uniform((), 0.0, 1.0) * (1 - side) * H,
                "tx": uniform((), 0.0, 1.0) * (1 - side) * W}
    return {"tx": uniform_rows((B,), -0.1, 0.1), "ty": uniform_rows((B,), -0.1, 0.1)}


def apply_l2t_op(x, op_idx: int, draws: dict, eps: float, whole=None):
    """Op ``op_idx`` on ``x`` from its draws; ``whole`` gives the whole
    batch's rows of ``x`` that Admix's partners index (``x`` itself by
    default)."""
    B, H, W, C = x.shape
    d = draws
    if op_idx == 0:
        return rotate(x, d["angle"])
    if op_idx == 1:
        return x * 2.0 ** -d["power"].to(x.dtype)
    if op_idx == 2:
        return resize_pad(x, **d["dim"])
    if op_idx == 3:
        return x[:, permute_strips(d["edges"], d["perm"], H)]
    if op_idx == 4:
        return x + 0.2 * (x if whole is None else whole(x))[d["perm"]].detach()
    if op_idx == 5:
        return x * d["keep"].to(x.dtype)
    if op_idx == 6:
        mask = d["cell"].to(x.dtype).repeat_interleave(H // 4, 0).repeat_interleave(W // 4, 1)
        return x * mask[None, :, :, None]
    if op_idx == 7:
        return idct_2d(dct_2d(x + d["gauss"] * eps) * d["mask"])
    if op_idx == 8:
        s = 1.0 / d["side"]
        return scale_and_translate(x, (H, W), (s, s), (-d["ty"] * s, -d["tx"] * s))
    return translate(x, d["tx"], d["ty"])


class L2T(Attack):
    """Official args: num_scale=3, ops_num=2, aug_lr=0.01."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 decay=1.0, num_scale=3, ops_num=2, aug_lr=0.01, targeted=False,
                 random_start=False, norm="linfty", loss="crossentropy",
                 attack="L2T", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.num_scale = int(num_scale)
        self.ops_num = int(ops_num)
        self.aug_lr = float(aug_lr)

    def init_extra(self, x, y):
        return {"aug_param": torch.zeros(NUM_OPS, dtype=x.dtype, device=x.device)}

    def apply_op(self, x, op_idx: int, gen, step, copy, slot):
        """One op of a chain (``step``/``copy``/``slot`` index the draw)."""
        return apply_l2t_op(x, op_idx, op_draws(gen, op_idx, x, self.data_split), self.eps,
                            self.whole_batch)

    def sample_ids(self, gen, aug_param, step, copy):
        """``ops_num`` categorical draws from softmax(θ), with replacement."""
        p = torch.softmax(aug_param, 0).to(gen.device)
        return torch.multinomial(p, self.ops_num, replacement=True, generator=gen)

    def get_grad(self, x, y, state: AttackState, gen):
        aug_param = state.extra["aug_param"]
        delta = state.delta.detach().requires_grad_(True)
        chains, ids_all = [], []
        for copy in range(self.num_scale):
            ids = [int(i) for i in self.sample_ids(gen, aug_param, state.step, copy)]
            pt = x + delta
            for slot, op in enumerate(ids):
                pt = self.apply_op(pt, op, gen, state.step, copy, slot)
            chains.append(pt)
            ids_all.append(ids)
        logits = self.get_logits(torch.stack(chains))
        self.grad_evals += self.num_scale
        losses = torch.stack([self.get_loss(lg[None], y) for lg in logits])
        (g,) = torch.autograd.grad(losses.sum(), delta)
        # REINFORCE: ∂(p_chain · loss)/∂θ, the loss held constant
        theta = aug_param.detach().requires_grad_(True)
        p = torch.softmax(theta, 0)
        chain_p = torch.stack([torch.prod(p[torch.tensor(ids, device=p.device)])
                               for ids in ids_all])
        (ag,) = torch.autograd.grad((chain_p * self.whole_loss(losses)).sum(), theta)
        new_param = aug_param + self.aug_lr * ag / self.num_scale
        return g / self.num_scale, {"aug_param": new_param}
