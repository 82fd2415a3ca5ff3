"""IDAA and the Everywhere attack (counterpart of
``input_transformation/idaa.py``), both targeted.

IDAA: the perturbation is ``tanh``-parameterized, an unbounded ``w``
squashed into the per-pixel box ``[-min(x, eps), min(1 - x, eps)]``, and
``w`` descends ``CE(target) − γ·CE(source)`` by Adam (no sign, no bias
correction).  Each iteration replicates ``w`` into ``num_scale + 1`` copies;
the flattened copies·batch axis is cut into ten contiguous blocks, one for
each of the reference's ten kornia ops (:data:`IDAA_OPS`), then local mixup
blends random boxes with a permuted partner, and each copy's gradient is
L1-mean normalized before the copies are averaged.

The ops' warps sample their fields exactly (:func:`~..ops.image.warp_field`,
:func:`~..ops.image.rotate`, :func:`~..ops.image.translate`), where JAX
resamples them in separable 1-D passes with a clamped displacement.  Every
draw is split from its apply step: :func:`op_draws` / :func:`apply_op`,
:func:`mix_draws` / :func:`local_mix`, through the seams
:meth:`IDAA.op_draws`, :meth:`IDAA.mix_draws` and :meth:`IDAA.aug_gate`, so
that a test can feed the values JAX drew.

Everywhere: see :class:`EverywhereAttack`.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..attack import Attack, AttackState, draw, softmax_cross_entropy
from ..advanced_objective.cfm import di_keepresolution
from ..ops.image import (CORNERS, fisheye_field, gaussian_blur_sep, homography_field, rotate,
                         scale_and_translate, tps_field, translate, warp_field)
from ..ops.kernels import gaussian_kernel, smooth_conv
from ..utils import img_max

# the reference's kornia op list, in its order (``idaa.py:79-90``)
IDAA_OPS = ("hflip", "perspective", "rotation", "vflip", "tps", "resize", "affine",
            "erase", "elastic", "fisheye")

_INWARD = ((1.0, 1.0), (-1.0, 1.0), (-1.0, -1.0), (1.0, -1.0))


# ---------------------------------------------------------------------------
# Beta draws from an explicit generator
# ---------------------------------------------------------------------------

def gamma_draw(gen, alpha: float, n: int) -> torch.Tensor:
    """``n`` Gamma(α, 1) draws (fp64) on the generator's device:
    Marsaglia–Tsang for Gamma(α + 1), times ``U^{1/α}`` when α < 1."""
    dev = gen.device
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.empty(n, dtype=torch.float64, device=dev)
    todo = torch.arange(n, device=dev)
    while todo.numel():
        m = todo.numel()
        z = torch.randn(m, generator=gen, dtype=torch.float64, device=dev)
        u = torch.rand(m, generator=gen, dtype=torch.float64, device=dev)
        v = (1.0 + c * z) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v
                        + d * torch.log(v.clamp(min=1e-300)))
        out[todo[ok]] = d * v[ok]
        todo = todo[~ok]
    if alpha < 1.0:
        u = torch.rand(n, generator=gen, dtype=torch.float64, device=dev)
        out = out * u ** (1.0 / alpha)
    return out


def beta_draw(gen, a: float, b: float, n: int, device=None) -> torch.Tensor:
    """``n`` Beta(a, b) draws as ``X / (X + Y)``, X ~ Gamma(a), Y ~ Gamma(b),
    fp32 on ``device``."""
    xa, xb = gamma_draw(gen, a, n), gamma_draw(gen, b, n)
    return (xa / (xa + xb)).float().to(device)


# ---------------------------------------------------------------------------
# the ten ops: draws and apply steps
# ---------------------------------------------------------------------------

def op_draws(gen, op: str, S: int, H: int, W: int, device=None) -> dict:
    """The random values of ``op`` on ``S`` images, as JAX draws them (its
    bounds and shapes; angles in degrees)."""
    def u(shape, lo, hi):
        return draw(gen, torch.rand, shape, device=device) * (hi - lo) + lo

    if op == "hflip":
        return {}
    if op == "perspective":
        return {"d": u((S, 4, 2), 0.0, 0.5)}
    if op == "rotation":
        return {"angle": u((S,), -15.0, 15.0)}
    if op == "vflip":
        return {"flip": draw(gen, torch.rand, (S,), device=device) < 0.6}
    if op == "tps":
        return {"offsets": u((S, 9, 2), -0.3, 0.3)}
    if op == "resize":
        return {"scale": u((S,), 0.9, 1.0)}
    if op == "affine":
        # the vertical translate draw is clamped to ±0.3 of the side (JAX's
        # departure from the reference's ±1.0, kept)
        return {"angle": u((S,), -1.0, 5.0), "scale": u((S,), 0.4, 1.3),
                "shear": u((S,), -0.5, 0.5), "tx": u((S,), -0.3, 0.3),
                "ty": torch.clamp(u((S,), -1.0, 1.0), -0.3, 0.3)}
    if op == "erase":
        return {"area": u((S,), 0.01, 0.04), "ratio": u((S,), 0.3, 1.0),
                "top": u((S,), 0.0, 1.0), "left": u((S,), 0.0, 1.0)}
    if op == "elastic":
        return {"noise": u((S, H, W, 2), -1.0, 1.0)}
    if op == "fisheye":
        return {"cx": u((S,), -0.3, 0.3), "cy": u((S,), -0.3, 0.3), "g": u((S,), 0.9, 1.0)}
    raise KeyError(op)


def perspective_field(d, H: int, W: int):
    """kornia RandomPerspective's field: the end corners move inward by
    ``d`` (S, 4, 2), and the output samples the source at the homography
    mapping end to base, so the content moves inward."""
    base = torch.tensor(CORNERS, device=d.device)
    end = base[None] + torch.tensor(_INWARD, device=d.device)[None] * d.float()
    return homography_field(base.expand(d.shape[0], 4, 2), H, W, dst_corners=end)


def _center_scale(seg, s):
    """Scale each image about its center by ``s`` (S,), linear, as JAX's
    per-image ``scale_and_translate``."""
    H, W = seg.shape[1], seg.shape[2]
    return scale_and_translate(seg, (H, W), (s, s), (H * (1 - s) / 2, W * (1 - s) / 2))


def apply_op(op: str, seg, **d):
    """``op`` on the NHWC block ``seg`` with its draws ``d``."""
    S, H, W, _ = seg.shape
    if op == "hflip":
        return seg.flip(2)
    if op == "perspective":
        return warp_field(seg, *perspective_field(d["d"], H, W))
    if op == "rotation":
        return rotate(seg, d["angle"] * math.pi / 180)
    if op == "vflip":
        return torch.where(d["flip"].reshape(-1, 1, 1, 1), seg.flip(1), seg)
    if op == "tps":
        return warp_field(seg, *tps_field(d["offsets"], H, W))
    if op == "resize":
        return _center_scale(seg, d["scale"])
    if op == "affine":
        # kornia's order: x-shear about the center (src_x = x − tan(sh)·y_c),
        # scale about the center, rotation, then the translate, whose
        # fractions are of the full side
        y_c = torch.arange(H, dtype=torch.float32, device=seg.device) - (H - 1) / 2.0
        dxs = -torch.tan(d["shear"] * math.pi / 180)[:, None, None] * y_c[None, :, None]
        out = warp_field(seg, dxs.expand(S, H, W), torch.zeros(S, H, W, device=seg.device))
        out = _center_scale(out, d["scale"])
        out = rotate(out, d["angle"] * math.pi / 180)
        return translate(out, -2.0 * d["tx"], -2.0 * d["ty"])
    if op == "erase":
        area = d["area"].reshape(-1, 1, 1) * H * W
        ratio = d["ratio"].reshape(-1, 1, 1)
        eh, ew = torch.sqrt(area * ratio), torch.sqrt(area / ratio)
        top, left = d["top"].reshape(-1, 1, 1) * (H - eh), d["left"].reshape(-1, 1, 1) * (W - ew)
        rows = torch.arange(H, dtype=torch.float32, device=seg.device)[None, :, None]
        cols = torch.arange(W, dtype=torch.float32, device=seg.device)[None, None, :]
        box = (rows >= top) & (rows < top + eh) & (cols >= left) & (cols < left + ew)
        return torch.where(box[..., None], torch.ones_like(seg), seg)
    if op == "elastic":
        # RandomElasticTransform((27, 27), (33, 31), (0.1, 1.0)): blurred
        # U(−1, 1) noise scaled by α in normalized units
        disp = gaussian_blur_sep(d["noise"], 27, 33.0, 31.0)
        return warp_field(seg, disp[..., 0] * 0.1 * (W / 2.0), disp[..., 1] * 1.0 * (H / 2.0))
    if op == "fisheye":
        return warp_field(seg, *fisheye_field(d["cx"], d["cy"], d["g"], H, W))
    raise KeyError(op)


def op_blocks(N: int):
    """The ten ops' contiguous blocks of the flattened axis of ``N`` images
    (JAX's adaptation of the reference's ``op[k % 10]``)."""
    n_ops = len(IDAA_OPS)
    bounds = [round(j * N / n_ops) for j in range(n_ops + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


def op_cycle(flat, draws, gate=None):
    """Each op of :data:`IDAA_OPS` on its block of ``flat``; ``draws[j]`` are
    op j's (None for an empty block); where ``gate`` (N,) is false an image
    passes unchanged."""
    outs = [apply_op(op, flat[lo:hi], **d)
            for op, (lo, hi), d in zip(IDAA_OPS, op_blocks(flat.shape[0]), draws) if hi > lo]
    out = torch.cat(outs, 0)
    if gate is not None:
        out = torch.where(gate.reshape(-1, 1, 1, 1), out, flat)
    return out


def mix_draws(gen, N: int, H: int, W: int, alpha: float = 0.4, num: int = 3,
              device=None) -> list:
    """``num`` rounds of local-mixup draws: (Beta(α, α) weights (N,), the
    partner permutation (N,), box center rows (N,) and columns (N,))."""
    return [(beta_draw(gen, alpha, alpha, N, device),
             draw(gen, torch.randperm, N, device=device),
             draw(gen, torch.randint, 0, H, (N,), device=device),
             draw(gen, torch.randint, 0, W, (N,), device=device)) for _ in range(num)]


def local_mix(flat, draws, crop_size: float = 0.7):
    """Local mixup over the flattened copies·batch axis: each round blends,
    per image, a box of ``crop_size`` of the side about its center (clipped
    at the border) with the same box of its partner, at weight
    ``max(λ, 1 − λ)``; the rounds update the whole batch at once."""
    N, H, W, _ = flat.shape
    cut_h, cut_w = int(H * crop_size) // 2, int(W * crop_size) // 2
    rows = torch.arange(H, device=flat.device)[None, :, None]
    cols = torch.arange(W, device=flat.device)[None, None, :]
    out = flat
    for lam, perm, cy, cx in draws:
        lam = torch.maximum(lam, 1.0 - lam).reshape(N, 1, 1, 1).to(flat.dtype)
        cy, cx = cy.reshape(N, 1, 1), cx.reshape(N, 1, 1)
        box = ((rows >= cy - cut_h) & (rows < cy + cut_h)
               & (cols >= cx - cut_w) & (cols < cx + cut_w))
        out = torch.where(box[..., None], lam * out + (1.0 - lam) * out[perm], out)
    return out


class IDAA(Attack):
    """Official args: alpha=1 (the Adam step in ``w`` space), num_scale=10,
    gamma=0.1, mixup_num=3, mixup_alpha=0.4, crop_size=0.7, β1=0.99,
    β2=0.999; targeted; ``w`` starts at N(0, 1).  Labels are (source,
    target) pairs.  The ``num_scale + 1`` copies go through the surrogate as
    one batch; no update kernel (the Adam step is its own)."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.0,
                 decay=1.0, num_scale=10, gamma=0.1, mixup_num=3, mixup_alpha=0.4,
                 crop_size=0.7, aug_p=1.0, targeted=True, random_start=False,
                 norm="linfty", loss="crossentropy", attack="IDAA", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.num_scale = int(num_scale)
        self.gamma = float(gamma)
        self.mixup_num = int(mixup_num)
        self.mixup_alpha = float(mixup_alpha)
        self.crop_size = float(crop_size)
        self.aug_p = float(aug_p)
        self.beta1, self.beta2 = 0.99, 0.999

    def prepare_labels(self, label):
        """Both columns: the targeted loss reads the source and the target."""
        return torch.as_tensor(label, device=self.device).long()

    def init_delta(self, x, gen):
        """``w`` ~ N(0, 1)."""
        return self.draw_rows(gen, torch.randn, x.shape, device=x.device)

    def init_extra(self, x, y):
        return {"m": torch.zeros_like(x), "v": torch.zeros_like(x)}

    def num_copies(self):
        return self.num_scale + 1

    def _bounds(self, x):
        # the reference unpacks get_bound's (lower, upper) as ``ub, lb``,
        # which turns the tanh around; kept (the span is the whole box)
        ub = -torch.clamp(x, max=self.eps)
        lb = torch.clamp(img_max - x, max=self.eps)
        return lb, ub

    def _pert(self, w, lb, ub):
        return lb + (ub - lb) * (torch.tanh(w) / 2 + 0.5)

    # --- draw seams -------------------------------------------------------
    def op_draws(self, gen, j, S, H, W, step):
        """Op ``j``'s draws for a block of ``S`` images."""
        return op_draws(gen, IDAA_OPS[j], S, H, W, self.device)

    def aug_gate(self, gen, N, step):
        """Which images take their op (all at ``aug_p`` 1)."""
        if self.aug_p >= 1.0:
            return None
        return draw(gen, torch.rand, (N,), device=self.device) < self.aug_p

    def mix_draws(self, gen, N, H, W, step):
        return mix_draws(gen, N, H, W, self.mixup_alpha, self.mixup_num, self.device)

    def augment(self, flat, gen, step):
        """The op cycle, then local mixup, of the flattened copies."""
        N, H, W = flat.shape[:3]
        draws = [self.op_draws(gen, j, hi - lo, H, W, step) if hi > lo else None
                 for j, (lo, hi) in enumerate(op_blocks(N))]
        flat = op_cycle(flat, draws, self.aug_gate(gen, N, step))
        return local_mix(flat, self.mix_draws(gen, N, H, W, step), self.crop_size)

    def step(self, x, y, state: AttackState, gen, alpha=None) -> AttackState:
        n, B = self.num_scale + 1, x.shape[0]
        lb, ub = self._bounds(x)
        y_src, y_tgt = (y[:, 0], y[:, 1]) if self.targeted else (y, y)
        ws = state.delta.detach()[None].expand((n,) + x.shape).clone().requires_grad_(True)
        # the op blocks and the mixup partners run over the flattened copies
        # of the whole batch
        points = self.over_batch(
            lambda p: self.augment(p.reshape((-1,) + x.shape[1:]), gen,
                                   state.step).reshape(p.shape),
            x[None] + self._pert(ws, lb, ub), axis=1)
        lf = self.model.apply(points.reshape((n * B,) + x.shape[1:])).float()
        self.grad_evals += n

        def ce(labels):
            return self.batch_share(softmax_cross_entropy(lf, labels.repeat(n)).reshape(n, B))

        loss = ce(y_tgt)
        if self.targeted:
            loss = loss - self.gamma * ce(y_src)
        (g,) = torch.autograd.grad(loss, ws)
        # each (copy, image) L1-mean normalized before the copy average
        gn = g.abs().mean(dim=(2, 3, 4), keepdim=True)
        grad = (g / (gn + 1e-8)).mean(0)
        m = self.beta1 * state.extra["m"] + (1 - self.beta1) * grad
        v = self.beta2 * state.extra["v"] + (1 - self.beta2) * grad * grad
        # descent, no sign, no bias correction
        w = state.delta - self.alpha * m / (torch.sqrt(v) + 1e-8)
        return AttackState(delta=w, momentum=state.momentum, step=state.step + 1,
                           extra={"m": m, "v": v})

    def finalize(self, state: AttackState, x, y):
        lb, ub = self._bounds(x)
        return self._pert(state.delta, lb, ub)


class EverywhereAttack(Attack):
    """The reference's ``advanced_fgsm_every_memory`` with
    ``attack_type='CDTM'``: each iteration attacks the whole image and
    ``sample_num = 4`` of its 3×3 grid regions (the region kept, the rest
    filled with the ImageNet mean) in one batch, under clean-feature mixup
    at ``layers`` (a fresh batch permutation a layer, shared across the
    region groups; each group mixes with the clean features of its own
    region kind; one Bernoulli(0.1) a layer; channel ratios U(0, 0.75)),
    the resolution-preserving DI (margin 29, p 0.7), a 5×5 TI and
    L1-*sum* momentum, raising the summed target logit.

    The 3×3 masks leave the last ``H % 3`` rows and columns out
    (``H // 3`` blocks).  The clean features of the (9 + 1)·B combine batch
    are recorded once before the loop, which costs the reference one
    iteration: ``epoch − 1`` steps run.  ``num_blocks`` and ``N`` are dead
    in the reference's loop and kept for its signature.  Draw seams, as
    JAX names them: :meth:`region_select`, :meth:`layer_perm`,
    :meth:`mix_draws`, :meth:`di`.

    Official args: epoch=300, eps=16/255, alpha=1.6/255; targeted; delta
    starts at zero."""

    def __init__(self, model_name="resnet50", epoch=300, eps=16 / 255, alpha=1.6 / 255,
                 num_blocks=16, N=9, sample_num=4, mix_prob=0.1, mix_upper=0.75,
                 layers=("layer2", "layer3", "layer4"), kernel_size=5,
                 di_margin=29, di_prob=0.7, targeted=True, random_start=False,
                 norm="linfty", loss="crossentropy", attack="everywhere", **kwargs):
        kwargs.pop("decay", None)
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=1.0,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.num_blocks = int(num_blocks)
        self.N = int(N)
        self.sample_num = int(sample_num)
        self.mix_prob = float(mix_prob)
        self.mix_upper = float(mix_upper)
        self.layers = tuple(layers)
        self.kernel = gaussian_kernel(int(kernel_size))
        self.di_margin = int(di_margin)
        self.di_prob = float(di_prob)
        # the first iteration is consumed recording clean features
        self.epoch = max(self.epoch - 1, 1)

    _MEAN = (0.485, 0.456, 0.406)

    def _masks(self, H: int, W: int):
        hb, wb = H // 3, W // 3
        m = np.zeros((9, H, W, 1), np.float32)
        for i in range(9):
            up, left = (i // 3) * hb, (i % 3) * wb
            m[i, up:min(up + hb, H), left:min(left + wb, W)] = 1.0
        return torch.from_numpy(m).to(self.device)

    def num_copies(self):
        return self.sample_num + 1

    def _mean(self, x):
        return torch.tensor(self._MEAN, dtype=x.dtype, device=x.device)

    def _record_clean(self, x):
        """Clean features of [whole; 9 masked]·B at every mix layer, (10, B,
        h, w, c) in the compute dtype (fp32 without one)."""
        B = x.shape[0]
        masks = self._masks(x.shape[1], x.shape[2])[:, None]
        combine = torch.cat([x[None], masks * x[None] + (1.0 - masks) * self._mean(x)], 0)
        store = self.compute_dtype or torch.float32
        with torch.no_grad():
            feats = self.model.features(combine.reshape((-1,) + x.shape[1:]), self.layers)[1]
        return {f"clean_{layer}": f.reshape((10, B) + f.shape[1:]).to(store)
                for layer, f in feats.items()}

    def run(self, x, y, gen):
        state = self.init_state(x, y, gen)
        state.extra.update(self._record_clean(x))
        for _ in range(self.epoch):
            state = self.step(x, y, state, gen)
        return self.finalize(state, x, y)

    def post_grad(self, grad, state: AttackState):
        return smooth_conv(grad, self.kernel)

    def get_momentum(self, grad, momentum):
        denom = grad.abs().sum(dim=(1, 2, 3), keepdim=True)
        return momentum * self.decay + grad / (denom + 1e-12)

    # --- draw seams -------------------------------------------------------
    def region_select(self, gen, step):
        """The ``sample_num`` regions of this iteration, distinct, of 9."""
        return draw(gen, torch.randperm, 9, device=self.device)[: self.sample_num]

    def layer_perm(self, gen, i, B, step):
        """Layer ``i``'s batch permutation of the clean partners."""
        return self.draw_rows(gen, torch.randperm, B, device=self.device)

    def mix_draws(self, gen, i, n, B, C, dtype, step):
        """(whether layer ``i`` mixes, its channel ratios (n, B, 1, 1, C))."""
        do = draw(gen, torch.rand, (), device=self.device) < self.mix_prob
        ratio = self.draw_rows(gen, torch.rand, (n, B, 1, 1, C), batch_axis=1,
                               device=self.device).to(dtype) * self.mix_upper
        return do, ratio

    def di(self, flat, gen, step):
        return di_keepresolution(flat, gen, self.di_margin, self.di_prob)

    def get_grad(self, x, y, state: AttackState, gen):
        B, H, W, _ = x.shape
        n = self.sample_num + 1
        masks = self._masks(H, W)
        sel = self.region_select(gen, state.step).to(self.device)
        groups = torch.cat([torch.zeros(1, dtype=sel.dtype, device=sel.device), sel + 1])
        taps = {}
        for i, layer in enumerate(self.layers):
            # the partners' clean features: any image of the whole batch
            clean = self.whole_batch(state.extra[f"clean_{layer}"], axis=1)
            perm = self.layer_perm(gen, i, B, state.step)
            do, ratio = self.mix_draws(gen, i, n, B, clean.shape[-1], x.dtype, state.step)

            def tap(f, clean=clean, perm=perm, do=do, ratio=ratio):
                fb = f.reshape((n, B) + f.shape[1:])
                prev = clean[groups][:, perm].to(fb.dtype)
                r = ratio.to(fb.dtype)
                mixed = (1.0 - r) * fb + r * prev
                return torch.where(do, mixed, fb).reshape(f.shape)

            taps[layer] = tap
        delta = state.delta.detach().requires_grad_(True)
        xadv = x + delta
        sel_m = masks[sel][:, None]
        views = sel_m * xadv[None] + (1.0 - sel_m) * self._mean(x)
        flat = torch.cat([xadv[None], views], 0).reshape((-1,) + x.shape[1:])
        logits = self.model.apply(self.di(flat, gen, state.step), tap_fns=taps).float()
        self.grad_evals += n
        total = logits.gather(1, y.repeat(n)[:, None]).sum()
        (grad,) = torch.autograd.grad(total if self.targeted else -total, delta)
        return grad, {}
