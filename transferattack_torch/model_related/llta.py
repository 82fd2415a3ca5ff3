"""LLTA, LL2S and ATA-ViT (counterpart of ``model_related/llta.py``).

LLTA: per-image backward-decay factors γ on each non-first residual block
(DecayReLU, the ResNet's ``gammas``) are searched by importance-weighted
gaussian sampling, then gradients are averaged over sampled meta-tasks
(model augmentation: γ jitter; data augmentation: DIM's resize-pad).  The
draws go through the seams :meth:`LLTA.gamma_noise`,
:meth:`LLTA.model_task_draws`, :meth:`LLTA.data_task_draws` and
:meth:`LLTA.task_perm`.

LL2S: each iteration draws ``num_scale·ops_num`` assignments of one
redundancy operation a transformer layer (benign k/v tokens, sparse
attention, head shuffle, MoE FFN) from a REINFORCE-trained distribution,
sums their gradients, and steps its robust tokens.  Draws:
:meth:`LL2S.robust_init`, :meth:`LL2S.rest_ids`, :meth:`LL2S.op_ids`,
:meth:`LL2S.op_draws`.

ATA-ViT: a per-patch pixel budget from the transformer attribution's
attention entropy, the pixels chosen by input saliency, then 250 Adam steps
on the masked pixels (optax's update, written out: :func:`adam_step`).
"""
from __future__ import annotations

import math

import torch

from ..attack import AttackState, draw, softmax_cross_entropy
from ..gradient.mifgsm import MIFGSM
from ..input_transformation.dim import resize_pad, resize_pad_draws
from ..models.vit import ViTSurgery, with_surgery
from .sgm import surgery_model
from .vit_attacks import vit_model
from .vit_attacks2 import vit_shapes

GMIN, GMAX = 0.0, 1e5


class LLTA(MIFGSM):
    """Learning-to-learn transferable attack.  Per iteration:

    1. γ starts at 0.5 per image and decay block and is refined for
       ``inner_iters`` rounds of importance-weighted gaussian search that
       minimises the L2 norm of the input gradient (weights
       exp(−Δ)·1[Δ<0] / q);
    2. a support set of ``spt_size`` tasks (γ jitter, DI) and a query set
       of ``qry_size`` are drawn;
    3. for each of ``task_num`` meta-tasks, an FGSM step on a support
       batch drawn per image gives spt_delta, and the query loss's gradient
       at spt_delta adds to the gradient.

    The reference demands batchsize=1; per-image γ and support draws
    generalise it."""

    def __init__(self, model_name="resnet50", inner_iters=5, nsample=5,
                 task_num=5, sigma=0.05, spt_size=20, qry_size=10,
                 prob_m=0.5, region=0.1, prob_d=0.5, **kwargs):
        kwargs.setdefault("attack", "LLTA")
        super().__init__(surgery_model(model_name, kwargs), **kwargs)
        self.inner_iters = int(inner_iters)
        self.nsample = int(nsample)
        self.task_num = int(task_num)
        self.sigma = float(sigma)
        self.spt_size = int(spt_size)
        self.qry_size = int(qry_size)
        self.prob_m = float(prob_m)
        self.region = float(region)
        self.prob_d = float(prob_d)
        sizes = self.model.module.backbone.stage_sizes
        self.gamma_num = sum(n - 1 for n in sizes)

    # -- draws ---------------------------------------------------------

    def gamma_noise(self, gen, shape, rnd):
        """Round ``rnd``'s gaussian γ perturbations, (nsample, B, G)."""
        return (self.draw_rows(gen, torch.randn, shape, batch_axis=1, device=self.device)
                * self.sigma)

    def model_task_draws(self, gen, size, shape, which):
        """The γ jitter of a task set (``which``: 'spt' or 'qry'): U(0, 1)
        of (size, B, G) for the offset, of (size, B, 1) against prob_m."""
        B, G = shape
        return (self.draw_rows(gen, torch.rand, (size, B, G), batch_axis=1, device=self.device),
                self.draw_rows(gen, torch.rand, (size, B, 1), batch_axis=1, device=self.device))

    def data_task_draws(self, gen, x, size, which):
        """Per task: DIM's draws at rate 1/0.875, always applied, and a
        U(0, 1) against prob_d for whether the task uses them."""
        return [(resize_pad_draws(gen, x.shape[1], 1.0 / 0.875, 1.0, x.device),
                 draw(gen, torch.rand, (), device=x.device)) for _ in range(size)]

    def task_perm(self, gen, B, task):
        """Each image's qry_size support entries, drawn without
        replacement: (B, qry_size)."""
        # one draw an image of the whole batch, this rank's rows kept
        return self.rows_of(torch.stack([
            draw(gen, torch.randperm, self.spt_size, device=self.device)[: self.qry_size]
            for _ in range(self.batch_rows(B))]))

    # -- the search and the tasks ----------------------------------------

    def _set_logits(self, xs, gammas):
        """(S, B, ...) set forward through the decay surrogate."""
        S, B = xs.shape[0], xs.shape[1]
        logits = self.model.apply(xs.reshape((S * B,) + xs.shape[2:]),
                                  gammas=gammas.reshape(S * B, -1))
        self.grad_evals += S
        return logits.float()

    def _set_ce(self, xs, gammas, y):
        ce = softmax_cross_entropy(self._set_logits(xs, gammas), y.repeat(xs.shape[0])).sum()
        return -ce if self.targeted else ce

    def _l2grads(self, point, y, gammas):
        """Per-image L2 norm of the input gradient under each of a stack of
        γ (S, B, G), the S settings as one batch: (S, B)."""
        pts = point.expand((gammas.shape[0],) + point.shape).detach().requires_grad_(True)
        ce = softmax_cross_entropy(self._set_logits(pts, gammas),
                                   y.repeat(gammas.shape[0])).sum()
        (g,) = torch.autograd.grad(ce, pts)
        return g.flatten(2).norm(dim=2)

    def _optimize_gammas(self, point, y, gen):
        B = point.shape[0]
        gammas = torch.full((B, self.gamma_num), 0.5, device=point.device)
        for rnd in range(self.inner_iters):
            gd = self.gamma_noise(gen, (self.nsample, B, self.gamma_num), rnd)
            norms = self._l2grads(point, y, torch.cat(
                [gammas[None], torch.clamp(gammas[None] + gd, GMIN, GMAX)]))
            diff = norms[1:] - norms[:1]                       # (n, B)
            prob_p = (torch.exp(-diff) * (diff < 0))[..., None]
            prob_q = (torch.exp(-0.5 * (gd / self.sigma) ** 2)
                      / (self.sigma * math.sqrt(2 * math.pi)))
            w = prob_p / prob_q                                # (n, B, G)
            opt = (w * gd).sum(0) / (w.sum(0) + 1e-12)
            gammas = torch.clamp(gammas + opt, GMIN, GMAX)
        return gammas

    def _model_task_set(self, gammas, gen, size, which):
        u, m = self.model_task_draws(gen, size, tuple(gammas.shape), which)
        jitter = (u - 0.5) * 2 * self.region
        mask = (m < self.prob_m).to(gammas.dtype)
        return torch.clamp(gammas[None] + mask * jitter, GMIN, GMAX)

    def _data_task_set(self, x, gen, size, which):
        return torch.stack([torch.where(use < self.prob_d, resize_pad(x, **d), x)
                            for d, use in self.data_task_draws(gen, x, size, which)])

    def get_grad(self, x, y, state: AttackState, gen):
        B = x.shape[0]
        point = (x + state.delta).detach()
        gammas = self._optimize_gammas(point, y, gen)
        spt_g = self._model_task_set(gammas, gen, self.spt_size, "spt")
        spt_x = self._data_task_set(point, gen, self.spt_size, "spt")
        qry_g = self._model_task_set(gammas, gen, self.qry_size, "qry")
        qry_x = self._data_task_set(point, gen, self.qry_size, "qry")
        rows = torch.arange(B, device=x.device)[:, None]
        grads = torch.zeros_like(x)
        for task in range(self.task_num):
            idx = self.task_perm(gen, B, task)                 # (B, q)
            sel_g = spt_g.transpose(0, 1)[rows, idx].transpose(0, 1)
            sel_x = spt_x.transpose(0, 1)[rows, idx].transpose(0, 1)
            # FGSM on the support batch
            d = torch.zeros_like(sel_x).requires_grad_(True)
            (g_spt,) = torch.autograd.grad(self._set_ce(sel_x + d, sel_g, y), d)
            spt_delta = torch.clamp(self.eps * torch.sign(g_spt), -self.eps, self.eps)
            spt_delta = torch.clamp(sel_x + spt_delta, 0.0, 1.0) - sel_x
            # the query gradient at spt_delta
            d = spt_delta.detach().requires_grad_(True)
            (g_qry,) = torch.autograd.grad(self._set_ce(qry_x + d, qry_g, y), d)
            grads = grads + g_qry.sum(0)
        return grads, {}


class LL2S(MIFGSM):
    """Layer-level redundancy exploitation.  A (layers × 4) operation
    distribution, REINFORCE-updated each iteration with the prob-weighted
    losses (lr ``ops_lr``), picks per layer one of: REST (benign k/v tokens
    of the clean block 0 appended to the keys), sparse attention (a random
    mask at p=0.4), head shuffle (prob 0.5, 45% of the heads), MoE FFN (2–5
    experts, dropout 0.3: fc2 is linear, so one forward with the mean
    mask).  ``num_scale·ops_num`` assignments a iteration, their gradients
    summed with weight 1/num_scale, one backward each (JAX holds all of them
    in one vjp; the sum is the same).  Dynamic robust tokens, N(0, 10²)
    appended after the position embedding, take a signed step of their own."""

    SPARSE_P = 0.4
    SHUFFLE_PROB, SHUFFLE_RATIO = 0.5, 0.45
    MOE_N, MOE_PROB = 5, 0.3
    REST_P = 0.3

    def __init__(self, model_name="vit_base_patch16_224", num_scale=10,
                 ops_num=2, ops_lr=0.01, robust_tokens_type="dynamic",
                 num_robust_tokens=400, prompt_lr=1e-2, **kwargs):
        kwargs.setdefault("attack", "LL2S")
        super().__init__(vit_model(model_name, kwargs), **kwargs)
        self.num_scale = int(num_scale)
        self.ops_num = int(ops_num)
        self.ops_lr = float(ops_lr)
        self.robust_tokens_type = robust_tokens_type
        self.num_robust_tokens = int(num_robust_tokens)
        self.prompt_lr = float(prompt_lr)
        bb = self.model.module.backbone
        self.num_layers = bb.depth
        self.num_heads = bb.num_heads
        self.head_dim = bb.dim // bb.num_heads
        self.token_dim = bb.dim

    # -- draws ---------------------------------------------------------

    def robust_init(self, gen, shape):
        """The dynamic robust tokens' start, N(0, 1)·10 of (B, R, D)."""
        return self.draw_rows(gen, torch.randn, shape, device=self.device) * 10.0

    def rest_ids(self, gen, n_tokens: int, n_rest: int):
        """Each head's REST token ids, ``n_rest`` of 1..N−1: (h, n_rest)."""
        return torch.stack([draw(gen, torch.randperm, n_tokens - 1, device=self.device)[:n_rest]
                            for _ in range(self.num_heads)]) + 1

    def op_ids(self, gen, probs, n_assign: int):
        """An operation a layer for each assignment, drawn from ``probs``
        (layers, 4): (n_assign, layers)."""
        u = draw(gen, torch.rand, (n_assign, probs.shape[0], 1), device=self.device)
        return (u > probs.cumsum(-1)[None]).sum(-1).clamp(max=probs.shape[1] - 1)

    def op_draws(self, gen, assign: int, block: int, op: int, attn_shape, hid_shape):
        """The draws of layer ``block``'s operation ``op`` in assignment
        ``assign``: sparse attention's 0/1 keep mask of the map's shape; the
        head shuffle's (heads to overwrite, whether to); the MoE's mean
        dropout mask of the hidden activation's shape; REST's None."""
        dev = self.device
        if op == 1:
            return self.draw_rows(gen, torch.rand, attn_shape, device=dev) > self.SPARSE_P
        if op == 2:
            idx = draw(gen, torch.randperm, self.num_heads, device=dev)[
                :int(self.num_heads * self.SHUFFLE_RATIO)]
            return idx, bool(draw(gen, torch.rand, (), device=dev) < self.SHUFFLE_PROB)
        if op == 3:
            n_exp = int(draw(gen, torch.randint, 2, self.MOE_N + 1, (), device=dev))
            keep = self.draw_rows(gen, torch.rand, (n_exp,) + tuple(hid_shape), batch_axis=1,
                                  device=dev) > self.MOE_PROB
            return keep.sum(0).float() / n_exp
        return None

    # -- state -----------------------------------------------------------

    def _n_tokens(self):
        return (self.model.input_size // self.model.module.backbone.patch_size) ** 2 + 1

    def init_extra(self, x, y):
        extra = {"aug_param": torch.zeros((self.num_layers, 4), device=x.device)}
        if self.robust_tokens_type == "dynamic":
            # JAX's fixed seeds: a CPU generator, the draws moved, so every
            # device starts from the same tokens
            gen = torch.Generator().manual_seed(self.seed + 77)
            extra["robust_tokens"] = self.robust_init(
                gen, (x.shape[0], self.num_robust_tokens, self.token_dim))
            extra["robust_momentum"] = torch.zeros_like(extra["robust_tokens"])
        extra["rest_kv"] = self._rest_tokens(x, max(int(self.REST_P * self._n_tokens()), 1))
        return extra

    def _rest_tokens(self, x, n_rest: int):
        """(2, B, h, R, dh) benign k/v tokens of the clean forward's block 0,
        kept for the whole attack."""
        with torch.no_grad():
            qkv = self.model.features(x, ("blocks.0.attn.qkv",))[1]["blocks.0.attn.qkv"].float()
        b, n = qkv.shape[:2]
        kv = qkv.reshape(b, n, 3, self.num_heads, self.head_dim).permute(2, 0, 3, 1, 4)[1:]
        gen = torch.Generator().manual_seed(self.seed + 99)
        ids = self.rest_ids(gen, n, n_rest).to(x.device)          # (h, R)
        index = ids[None, None, :, :, None].expand(2, b, -1, -1, self.head_dim)
        return torch.gather(kv, 3, index)

    # -- the step --------------------------------------------------------

    def _op_view(self, ops, rest_kv, gen, assign: int):
        """The surrogate with layer b running operation ``ops[b]``."""
        def kv_extra(meta):
            use = float(ops[meta["block"]] == 0)
            # a -1e9 logit on the extra columns whenever the layer's op is
            # not REST: no attention mass there, whatever q is
            return rest_kv[0], rest_kv[1] * use, (use - 1.0) * 1e9

        def attn_post(a, meta):
            op = ops[meta["block"]]
            if op == 1:
                return a * self.op_draws(gen, assign, meta["block"], 1, a.shape, None).to(a.dtype)
            if op == 2:
                idx, do = self.op_draws(gen, assign, meta["block"], 2, a.shape, None)
                if do:
                    idx = idx.to(a.device)
                    return torch.index_copy(a, 1, idx, a.index_select(1, idx.sort().values))
            return a

        def mlp_hidden_post(h, meta):
            if ops[meta["block"]] != 3:
                return h
            return h * self.op_draws(gen, assign, meta["block"], 3, None, h.shape).to(h.dtype)

        return with_surgery(self.model, ViTSurgery(kv_extra=kv_extra, attn_post=attn_post,
                                                   mlp_hidden_post=mlp_hidden_post))

    def get_grad(self, x, y, state: AttackState, gen):
        aug_param, rest_kv = state.extra["aug_param"], state.extra["rest_kv"]
        robust = state.extra.get("robust_tokens")
        n_assign = self.num_scale * self.ops_num
        op_ids = self.op_ids(gen, torch.softmax(aug_param, dim=-1), n_assign).to(x.device)
        delta = state.delta.detach().requires_grad_(True)
        grad, losses = torch.zeros_like(x), []
        for i, ops in enumerate(op_ids.tolist()):
            logits = self._op_view(ops, rest_kv, gen, i).apply(
                x + delta, extra_tokens=robust).float()
            loss = self.get_loss(logits[None], y)
            (g,) = torch.autograd.grad(loss / self.num_scale, delta)
            grad, losses = grad + g, losses + [loss]
        self.grad_evals += n_assign

        # REINFORCE on the operation distribution
        param = aug_param.detach().requires_grad_(True)
        chain = torch.softmax(param, dim=-1)[torch.arange(self.num_layers, device=x.device)[None],
                                             op_ids].prod(dim=1)
        (g_aug,) = torch.autograd.grad(
            (chain * self.whole_loss(torch.stack(losses))).sum() / self.num_scale, param)
        updates = {"aug_param": aug_param + self.ops_lr * g_aug}
        if robust is not None:
            # the robust tokens' step, on the plain forward
            r = robust.detach().requires_grad_(True)
            logits = self.model.apply(x + state.delta, extra_tokens=r).float()
            self.grad_evals += 1
            (g_r,) = torch.autograd.grad(self.get_loss(logits[None], y), r)
            mom = state.extra["robust_momentum"] * self.decay + g_r
            updates["robust_momentum"] = mom
            updates["robust_tokens"] = robust - self.prompt_lr * torch.sign(mom)
        return grad, updates


def transformer_attribution(model, x, y, depth: int):
    """Chefer's transformer attribution (the relevance ATA-ViT ranks patches
    by): per block cam = E_heads[(∇A ⊙ A)⁺] of the class score, rolled out as
    ∏(cam + I) without row normalisation.  ∇A is the gradient at a zero
    offset added to each attention map.  (B, N, N), fp32."""
    shape = vit_shapes(model, x.shape[0])[0]
    n = shape[-1]
    dt = model.compute_dtype or torch.float32
    offs = [torch.zeros(shape, dtype=dt, device=x.device, requires_grad=True)
            for _ in range(depth)]
    maps = [None] * depth

    def attn_post(a, meta):
        a = a + offs[meta["block"]]
        maps[meta["block"]] = a.detach()
        return a

    logits = with_surgery(model, ViTSurgery(attn_post=attn_post)).apply(x).float()
    grads = torch.autograd.grad(logits.gather(1, y[:, None]).sum(), offs)
    eye = torch.eye(n, device=x.device)[None]
    joint = None
    for g, a in zip(grads, maps):
        cam = torch.clamp(g.float() * a.float(), min=0.0).mean(dim=1) + eye
        joint = cam if joint is None else cam @ joint
    return joint


def _bias(b: float, n: int, dtype):
    """``1 − b^n`` as optax computes it: the power rounded once to ``dtype``."""
    return 1 - torch.pow(torch.tensor(b, dtype=dtype), float(n))


def adam_step(p, g, mu, nu, t: int, lr: float, b1=0.9, b2=0.999, eps=1e-8):
    """One step of ``optax.adam`` at step ``t`` (0-based) and rate ``lr``:
    the moments, their bias correction by 1 − b^(t+1) (in the moments'
    dtype, as optax takes it: near 1 a last-bit difference in the power is
    1e-5 of the step), and ``p − lr·m̂/(√v̂ + eps)``.  Returns (p, mu, nu)."""
    mu = (1 - b1) * g + b1 * mu
    nu = (1 - b2) * g * g + b2 * nu
    m_hat = mu / _bias(b1, t + 1, mu.dtype).to(mu.device)
    v_hat = nu / _bias(b2, t + 1, nu.dtype).to(nu.device)
    return p - lr * m_hat / (torch.sqrt(v_hat) + eps), mu, nu


class ATA_ViT(MIFGSM):
    """Attention-aware patch attack on ViTs.

    1. Budget: the transformer attribution's per-patch attention entropy
       −Σ r·log₂ r shares a pixel budget (``budget_frac`` of the image, at
       most a whole patch each) across the patch grid;
    2. pixels: within each patch, the budgeted number with the largest
       input-saliency magnitude form the mask;
    3. 250 Adam steps (rate 1, ×1/3 at steps 50 and 150) on −log(1 − p_y)
       over the masked pixels, unbounded in [0, 1]: a patch attack, so
       the returned delta is not eps-bounded inside the mask.

    It steps through its own Adam, so the update kernel is not on its path.
    """

    def __init__(self, model_name="vit_base_patch16_224", epoch=250, lr=1.0,
                 budget_frac=1024.0 / (224 * 224), **kwargs):
        kwargs.setdefault("attack", "ATA_ViT")
        super().__init__(vit_model(model_name, kwargs), epoch=epoch, **kwargs)
        self.lr = float(lr)
        self.budget_frac = float(budget_frac)
        self.depth = self.model.module.backbone.depth

    def rate(self, t: int) -> float:
        """optax's ``piecewise_constant_schedule(lr, {50: 1/3, 150: 1/3})``."""
        return self.lr * (1.0 / 3.0) ** ((t >= 50) + (t >= 150))

    def _build_mask(self, x, y):
        P = self.model.module.backbone.patch_size
        B, H, W = x.shape[:3]
        gh, gw = H // P, W // P
        # 1. the per-patch budget from the attribution's entropy
        r = transformer_attribution(self.model, x, y, self.depth)
        self.grad_evals += 1
        rp = torch.clamp(r[:, 1:, 1:], 1e-10, 1.0)
        ent = -(rp * torch.log2(rp)).sum(dim=1)
        ent = ent / (ent.sum(-1, keepdim=True) + 1e-12)
        n_per_patch = torch.clamp(torch.floor(ent * (self.budget_frac * H * W)), 0, P * P)
        # 2. the most salient pixels of each patch
        img = x.detach().requires_grad_(True)
        ce = softmax_cross_entropy(self.model.apply(img).float(), y).sum()
        self.grad_evals += 1
        (g,) = torch.autograd.grad(ce, img)
        sal = g.abs().sum(-1).reshape(B, gh, P, gw, P).permute(0, 1, 3, 2, 4)
        order = torch.argsort(-sal.reshape(B, gh * gw, P * P), dim=-1, stable=True)
        rank = torch.argsort(order, dim=-1, stable=True)
        mask = (rank < n_per_patch[..., None]).to(x.dtype)
        return mask.reshape(B, gh, gw, P, P).permute(0, 1, 3, 2, 4).reshape(B, H, W)[..., None]

    def _patch_loss(self, x, patch, mask, y):
        inputs = torch.clamp(x * (1 - mask) + patch * mask, 0.0, 1.0)
        probs = torch.softmax(self.model.apply(inputs).float(), dim=-1)
        p = probs.gather(1, y[:, None])[:, 0]
        p = 1.0 - p if self.targeted else p
        return self.batch_share(-torch.log(1.0 - p + 1e-10))

    def run(self, x, y, gen):
        mask = self._build_mask(x, y)
        patch, mu, nu = x.clone(), torch.zeros_like(x), torch.zeros_like(x)
        for t in range(self.epoch):
            p = patch.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self._patch_loss(x, p, mask, y), p)
            self.grad_evals += 1
            patch, mu, nu = adam_step(patch, g, mu, nu, t, self.rate(t))
            patch = torch.clamp(patch, 0.0, 1.0)
        return torch.clamp(x * (1 - mask) + patch * mask, 0.0, 1.0) - x
