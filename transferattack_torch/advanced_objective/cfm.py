"""ATA, MFAA, YAILA, CFM, FTM and FFT (counterpart of
``advanced_objective/cfm.py``), with ``yaila_calculate_w`` and
``di_keepresolution``.

Feature-level objectives on the tap API: features read by forward hooks,
feature gradients by ``torch.autograd.grad`` at the hooked activation, and
features rewritten by tap functions (CFM's and FTM's mixing).  Draws go
through seams: MFAA's :meth:`MFAA.drop_mask` (JAX's), and the port's
:meth:`CFM.mix_draws`, :meth:`FTM.mix_draws`, :meth:`FFT.dropout_mask` and
:meth:`FFT.keepres_draws` where JAX draws inline.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..attack import Attack, AttackState, draw, softmax_cross_entropy
from ..gradient.mifgsm import MIFGSM
from ..input_transformation.dim import resize_pad, resize_pad_draws
from ..input_transformation.su import SU
from ..models import find_feature
from ..ops.image import scale_and_translate
from ..ops.kernels import gaussian_kernel, smooth_conv
from ..utils import img_max, img_min
from . import objective_loop
from .fia import l2_normalize, label_prob_sum
from .logit import picked_logits
from .tap import avg_pool_nhwc, powsign


class ATA(Attack):
    """Attention (grad-CAM) regularizer: loss = CE + λ·‖CAM(adv) − CAM(clean)‖²
    at layer4, ascended with the raw gradient.  The CAM of the adversary is
    differentiated through its own feature gradient (``create_graph``)."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 lamda=1.0, layer_name="layer4", targeted=False,
                 random_start=False, norm="linfty", loss="crossentropy",
                 attack="ATA", **kwargs):
        kwargs.pop("decay", None)
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=0.0,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.lamda = float(lamda)
        self.feature_layer = layer_name

    def _cam(self, point, y, create_graph: bool):
        """(grad-CAM, logits): relu(Σ_c w_c·f_c), w the spatial mean of the
        feature gradient of the label's softmax probability."""
        logits, feats = self.model.features(point, (self.feature_layer,))
        f = feats[self.feature_layer]
        (g,) = torch.autograd.grad(label_prob_sum(logits, y), f, create_graph=create_graph)
        self.grad_evals += 1
        w = g.float().mean(dim=(1, 2), keepdim=True)
        return F.relu((w * f.float()).sum(-1)), logits

    def run(self, x, y, gen):
        cam_ori = self._cam(x, y, False)[0].detach()

        def loss(d, state):
            cam_adv, logits = self._cam(x + d, y, True)
            return (self.batch_share(softmax_cross_entropy(logits, y))
                    + self.lamda * ((cam_adv - cam_ori) ** 2).sum())

        return objective_loop(self, x, y, gen, loss)


def _l2_normalize_per_sample(t, eps=1e-12):
    v = t.reshape(t.shape[0], -1)
    return (v / torch.sqrt((v * v).sum(1, keepdim=True) + eps)).reshape(t.shape)


class MFAA(Attack):
    """Multi-feature attention attack.  Guidance weights: the negated,
    per-sample normalized mean feature gradients of the label's logit over
    ``num_ens`` drop masks, at five taps (ResNet-50: layer4[-1],
    layer3[-1], layer3[-3], layer3[-5], layer2[-1]; ResNet-152: −8, −17,
    −27).  Each iteration runs the chain from layer4 down: a loss at one tap
    with its weights, whose feature gradient at the next shallower tap
    (normalized, plus that tap's guidance) weights the next loss; the last,
    at layer2, is ascended with momentum.  The reference forwards
    (clean, adv) and its losses read only the adversarial half, which shows
    as the 2 in each loss's ``numel`` divisor."""

    def __init__(self, model_name="resnet50", num_ens=30, probb=0.8,
                 taps=None, **kwargs):
        kwargs.setdefault("attack", "MFAA")
        super().__init__(model_name, **kwargs)
        self.num_ens = int(num_ens)
        self.probb = float(probb)
        self._taps = tuple(taps) if taps else self._default_taps()

    def _default_taps(self):
        sizes = list(self.model.module.backbone.stage_sizes)
        off = (8, 17, 27) if sizes == [3, 8, 36, 3] else (1, 3, 5)
        if sizes[2] < off[2] + 1:
            raise ValueError(f"MFAA needs >= {off[2] + 1} layer3 units (got stage sizes "
                             f"{sizes}); pass taps= explicitly for this surrogate")
        return (f"layer4_{sizes[3] - 1}", f"layer3_{sizes[2] - off[0]}",
                f"layer3_{sizes[2] - off[1]}", f"layer3_{sizes[2] - off[2]}",
                f"layer2_{sizes[1] - 1}")

    def drop_mask(self, gen, x, i):
        """Copy ``i``'s keep mask, each pixel value kept with probability ``probb``."""
        return (self.draw_rows(gen, torch.rand, x.shape, device=x.device) < self.probb).to(x.dtype)

    def _guidance(self, x, y, gen):
        names = list(dict.fromkeys(self._taps))
        acc = {n: 0.0 for n in names}
        for i in range(self.num_ens):
            logits, feats = self.model.features(x * self.drop_mask(gen, x, i), names)
            score = picked_logits(logits[None], y).sum()
            for n, g in zip(names, torch.autograd.grad(score, [feats[n] for n in names])):
                acc[n] = acc[n] + g.float()
            self.grad_evals += 1
        return {n: -_l2_normalize_per_sample(acc[n] / self.num_ens) for n in names}

    def get_grad(self, x, y, state: AttackState, gen):
        guidance = state.extra["guidance"]
        delta = state.delta.detach().requires_grad_(True)
        _, feats = self.model.features(x + delta, self._taps)
        L4, *middle, L2 = self._taps

        def cot(n, w):  # (adv · w).sum() / numel(concat(clean, adv)), the whole batch's
            numel = self.batch_rows(x.shape[0]) * feats[n][0].numel()
            return (w / (2.0 * numel)).to(feats[n].dtype)

        w, prev = guidance[L4], L4
        for nxt in (*middle, L2):
            (g,) = torch.autograd.grad(feats[prev], feats[nxt], grad_outputs=cot(prev, w),
                                       retain_graph=True, allow_unused=True)
            g = torch.zeros_like(feats[nxt]) if g is None else g
            self.grad_evals += 1
            w, prev = _l2_normalize_per_sample(g.float()) + guidance[nxt], nxt
        (grad,) = torch.autograd.grad(feats[L2], delta, grad_outputs=cot(L2, w))
        self.grad_evals += 1
        return grad, {}

    def run(self, x, y, gen):
        guidance = self._guidance(x, y, gen)
        state = self.init_state(x, y, gen)
        state.extra["guidance"] = guidance
        for _ in range(self.epoch):
            state = self.step(x, y, state, gen)
        return self.finalize(state, x, y)


def yaila_calculate_w(H, r, lam: float = 1.0):
    """The reference's dual-form ridge fit at normalize_H=True: rows of H
    L2-normalized, then w = Hᵀr − Hᵀ(HHᵀ + λI)⁻¹HHᵀr (= λ·Hᵀ(HHᵀ + λI)⁻¹r).
    H: (B, T, D) feature displacements; r: (B, T, 1) losses → (B, D)."""
    Hn = H / (H.norm(dim=2, keepdim=True) + 1e-12)
    A = torch.einsum("btd,bsd->bts", Hn, Hn) + lam * torch.eye(
        H.shape[1], dtype=H.dtype, device=H.device)[None]
    Ht_r = torch.einsum("btd,bto->bdo", Hn, r)
    z = torch.linalg.solve(A, torch.einsum("btd,bdo->bto", Hn, Ht_r))
    return (Ht_r - torch.einsum("btd,bto->bdo", Hn, z))[..., 0]


def jax_abs(p):
    """``|p|`` with JAX's derivative at 0, which is 1 (``torch.abs``'s is 0)."""
    return p * torch.where(p >= 0, 1.0, -1.0)


class YAILA(MIFGSM):
    """Yet another intermediate-level attack:

    1. a TAP-loss baseline: ``epoch + 1`` sign steps at lr 1/255 from zero,
       recording from the second on each image's feature displacement at
       the mid layer and its CE;
    2. the dual-form ridge fit of those (:func:`yaila_calculate_w`, λ = 1)
       in fp32;
    3. ``ila_epoch + 1`` sign steps from zero ascending the projection of
       the displacement on the fit's normalized weights.

    Both phases clip on their own.  Reference choices kept: eps defaults to
    0.03; the mid layer '3_1' is 1-indexed, the block ``layer3_0``."""

    def __init__(self, model_name="resnet50", mid_layer="3_1", lam=1.0,
                 ila_epoch=50, lr=1 / 255, tap_lam=0.005, tap_alpha=0.5,
                 tap_s=3, tap_yita=0.01, **kwargs):
        kwargs.setdefault("attack", "YAILA")
        kwargs.setdefault("eps", 0.03)
        super().__init__(model_name, **kwargs)
        bi, ui = mid_layer.split("_")
        self.mid_tap = f"layer{bi}_{int(ui) - 1}"
        self.lam = float(lam)
        self.ila_epoch = int(ila_epoch)
        self.lr = float(lr)
        self.tap_lam = float(tap_lam)
        self.tap_alpha = float(tap_alpha)
        self.tap_s = int(tap_s)
        self.tap_yita = float(tap_yita)

    def _forward_parts(self, xadv):
        """(logits, the four stage features, the mid block's) in one forward."""
        logits, feats = self.model.apply_with_feats(xadv, ("stage", self.mid_tap))
        mid = find_feature(feats, self.mid_tap)
        if mid is None:
            raise KeyError(f"no block tap {self.mid_tap!r}")
        return logits, [find_feature(feats, f"stage{i}") for i in (1, 2, 3, 4)], mid

    def _sign_step(self, delta, x, grad):
        d = torch.clamp(delta + self.lr * torch.sign(grad), -self.eps, self.eps)
        return torch.clamp(x + d, 0.0, 1.0) - x

    def _ascend(self, x, steps, loss_fn):
        """``steps`` sign steps from zero; returns delta and what ``loss_fn``
        returned beside its loss at each step."""
        delta, aux = torch.zeros_like(x), []
        for _ in range(steps):
            d = delta.requires_grad_(True)
            loss, extra = loss_fn(d)
            (grad,) = torch.autograd.grad(loss, d)
            self.grad_evals += 1
            aux.append(extra)
            delta = self._sign_step(d.detach(), x, grad)
        return delta, aux

    def run(self, x, y, gen):
        B = x.shape[0]
        with torch.no_grad():
            _, stages0, mid0 = self._forward_parts(x)
        mid0 = mid0.reshape(B, -1)

        n_all = self.batch_rows(B)  # the means are over the whole batch

        def tap_loss(d):
            xadv = x + d
            logits, stages, mid = self._forward_parts(xadv)
            ce = softmax_cross_entropy(logits, y)
            loss = self.batch_share(ce)
            for f0, f in zip(stages0, stages):
                diff = powsign(f0, self.tap_alpha) - powsign(f, self.tap_alpha)
                loss = loss + self.tap_lam * (diff ** 2).sum() / n_all
            loss = loss + self.tap_yita * jax_abs(avg_pool_nhwc(x - xadv, self.tap_s)).sum() / n_all
            return loss, (ce.detach(), (mid.reshape(B, -1) - mid0).detach())

        _, rec = self._ascend(x, self.epoch + 1, tap_loss)
        r = torch.stack([ce for ce, _ in rec[1:]], 1)[..., None]  # (B, T, 1)
        H = torch.stack([dm for _, dm in rec[1:]], 1)              # (B, T, D)
        w = yaila_calculate_w(H.float(), r.float(), self.lam)  # in fp32
        w = w / (w.norm(dim=1, keepdim=True) + 1e-12)
        del H, rec

        def proj(d):
            mid = self._forward_parts(x + d)[2]
            return ((mid.reshape(B, -1) - mid0) * w).sum() / n_all, None

        delta, _ = self._ascend(x, self.ila_epoch + 1, proj)
        return torch.clamp(x + delta, img_min, img_max) - x


class CFM(Attack):
    """Clean feature mixup: the targeted logit attack (300 iterations,
    alpha 2/255, DI and TI) whose stage features (layers 2–4) mix, each with
    probability 0.1 an image, with the clean features of another image of
    the batch at channel ratios U(0, 0.75).  The clean features are taken
    once a call (JAX retakes them each step: the same values)."""

    def __init__(self, model_name="resnet50", epoch=300, eps=16 / 255, alpha=2 / 255,
                 decay=1.0, mix_prob=0.1, mix_upper=0.75, mix_lower=0.0,
                 layers=("layer2", "layer3", "layer4"), resize_rate=1.1,
                 diversity_prob=0.7, kernel_size=5, targeted=True,
                 random_start=False, norm="linfty", loss="crossentropy",
                 attack="CFM", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.mix_prob = float(mix_prob)
        self.mix_upper = float(mix_upper)
        self.mix_lower = float(mix_lower)
        self.layers = tuple(layers)
        self.resize_rate = float(resize_rate)
        self.diversity_prob = float(diversity_prob)
        self.kernel = gaussian_kernel(int(kernel_size))

    def get_loss(self, logits, y):
        total = picked_logits(logits, y).sum()
        return total if self.targeted else -total

    def get_momentum(self, grad, momentum):
        return grad + self.decay * momentum

    def post_grad(self, grad, state: AttackState):
        return smooth_conv(grad, self.kernel)

    def init_extra(self, x, y):
        with torch.no_grad():
            return {"clean": self.model.features(x, self.layers)[1]}

    def di_draws(self, gen, x):
        return resize_pad_draws(gen, x.shape[1], self.resize_rate, self.diversity_prob,
                                x.device)

    def mix_draws(self, gen, x, state):
        """(DI draws, one (mix?, ratios, partners) a layer): whether each
        image mixes, its channel ratios (B, 1, 1, C) and whose clean
        feature it takes."""
        B = x.shape[0]
        mix = []
        for layer in self.layers:
            C = state.extra["clean"][layer].shape[-1]
            apply = self.draw_rows(gen, torch.rand, (B,), device=x.device) < self.mix_prob
            ratio = self.mix_lower + (self.mix_upper - self.mix_lower) * self.draw_rows(
                gen, torch.rand, (B, 1, 1, C), device=x.device)
            mix.append((apply, ratio,
                        self.draw_rows(gen, torch.randperm, B, device=x.device)))
        return self.di_draws(gen, x), mix

    def get_grad(self, x, y, state: AttackState, gen):
        di, mix = self.mix_draws(gen, x, state)
        # the partners' clean features: any image of the whole batch
        clean = {k: self.whole_batch(v) for k, v in state.extra["clean"].items()}
        taps = {}
        for layer, (apply, ratio, perm) in zip(self.layers, mix):
            def tap(f, c=clean[layer], apply=apply, ratio=ratio, perm=perm):
                mixed = (1 - ratio) * f + ratio * c[perm]
                return torch.where(apply[:, None, None, None], mixed, f)
            taps[layer] = tap
        delta = state.delta.detach().requires_grad_(True)
        logits = self.model.apply(resize_pad(x + delta, **di), tap_fns=taps)
        self.grad_evals += 1
        (grad,) = torch.autograd.grad(self.get_loss(logits.float()[None], y), delta)
        return grad, {}


class FTM(CFM):
    """Feature tuning mixup: CFM whose stage features, each with
    probability 0.1 an image, take a learned offset; each offset steps along
    its own gradient at ``ftm_lr`` with probability 0.5 an iteration."""

    def __init__(self, *args, ftm_lr=0.01, update_prob=0.5, attack="FTM", **kwargs):
        kwargs["attack"] = attack
        super().__init__(*args, **kwargs)
        self.ftm_lr = float(ftm_lr)
        self.update_prob = float(update_prob)

    def init_extra(self, x, y):
        return {f"pert_{layer}": torch.zeros(self.model.feature_shape(x.shape, layer),
                                             device=x.device) for layer in self.layers}

    def mix_draws(self, gen, x, state):
        """(DI draws, whether each image takes a layer's offset (B,) a layer,
        whether a layer's offset updates a layer)."""
        B = x.shape[0]
        apply = [self.draw_rows(gen, torch.rand, (B,), device=x.device) < self.mix_prob
                 for _ in self.layers]
        update = [draw(gen, torch.rand, (), device=x.device) < self.update_prob
                  for _ in self.layers]
        return self.di_draws(gen, x), apply, update

    def get_grad(self, x, y, state: AttackState, gen):
        di, apply, update = self.mix_draws(gen, x, state)
        perts = [state.extra[f"pert_{layer}"].detach().requires_grad_(True)
                 for layer in self.layers]
        taps = {layer: (lambda f, p=p, a=a: torch.where(a[:, None, None, None], f + p, f))
                for layer, p, a in zip(self.layers, perts, apply)}
        delta = state.delta.detach().requires_grad_(True)
        logits = self.model.apply(resize_pad(x + delta, **di), tap_fns=taps)
        self.grad_evals += 1
        grad, *pgrads = torch.autograd.grad(self.get_loss(logits.float()[None], y),
                                            [delta, *perts], allow_unused=True)
        updates = {}
        for layer, p, g, do in zip(self.layers, perts, pgrads, update):
            g = torch.zeros_like(p) if g is None else g
            updates[f"pert_{layer}"] = torch.where(do, p.detach() + self.ftm_lr * g, p.detach())
        return grad, updates


def keepres_draws(gen, size: int, margin: int = 22, prob: float = 0.7, device=None) -> dict:
    """One draw of the resolution-preserving DI: the shrunk side ``rnd`` in
    ``[size − margin, size)``, the integer offsets, and whether to apply."""
    rnd = draw(gen, torch.randint, size - margin, size, (), device=device).float()
    top = torch.floor(draw(gen, torch.rand, (), device=device) * (size - rnd + 1))
    left = torch.floor(draw(gen, torch.rand, (), device=device) * (size - rnd + 1))
    apply = draw(gen, torch.rand, (), device=device) <= prob
    return {"rnd": rnd, "top": top, "left": left, "apply": apply}


def keepres(x, rnd, top, left, apply):
    """The apply step: ``x`` shrunk to ``rnd`` pixels at offset (top, left)
    of a zero canvas of its own size, or ``x`` where ``apply`` is false."""
    H, W = x.shape[1], x.shape[2]
    out = scale_and_translate(x, (H, W), (rnd / H, rnd / H), (top, left))
    return torch.where(torch.as_tensor(apply, device=x.device), out, x)


def di_keepresolution(x, gen, margin: int = 22, prob: float = 0.7):
    """The reference FFT's resolution-preserving DI, linear as DIM is."""
    return keepres(x, **keepres_draws(gen, x.shape[1], margin, prob, x.device))


class FFT(SU):
    """Feature fine-tuning:

    1. the SU baseline toward the target (coef 0.001, scale (0.1, 0.0)) under
       ``loss_base`` (default logit_margin);
    2. FIA-style aggregate feature gradients of the label's logit at the mid
       layer over ``num_ens`` dropout copies, dropped in normalized space
       (x′ = mean + M⊙(x − mean)): on the clean image toward the original
       label and on the baseline adversary toward the target, combined as
       agg_adv − β·agg_clean;
    3. ``ft_epoch`` steps at alpha/2 ascending Σ combined ⊙ feature under
       the resolution-preserving DI and TI, the whole perturbation kept in
       the eps-ball by their own clip."""

    def __init__(self, model_name="resnet50", epoch=300, alpha=2 / 255,
                 num_ens=30, drop_rate=0.3, beta_combine=0.2, ft_epoch=10,
                 loss_base="logit_margin", mid_layer="layer3",
                 attack="FFT", **kwargs):
        kwargs["attack"] = attack
        kwargs.setdefault("targeted", True)
        super().__init__(model_name, epoch=epoch, alpha=alpha,
                         coef=0.001, scale=(0.1, 0.0), **kwargs)
        self.num_ens = int(num_ens)
        self.drop_rate = float(drop_rate)
        self.beta_combine = float(beta_combine)
        self.ft_epoch = int(ft_epoch)
        self.alpha_ft = float(alpha) / 2.0
        self.loss_base = str(loss_base)
        self.mid_layer = mid_layer
        if self.loss_base not in ("CE", "logit", "logit_margin"):
            raise ValueError("Only CE, logit, logit_margin are supported")

    def class_loss(self, logits, yy):
        if self.loss_base == "logit":
            return -logits.gather(1, yy[:, None])[:, 0].mean()
        if self.loss_base == "logit_margin":
            top2 = torch.topk(logits, 2, dim=1).values
            margin = (top2[:, 0] - top2[:, 1]).detach()[:, None]
            return softmax_cross_entropy(logits / margin, yy).mean()
        return softmax_cross_entropy(logits, yy).mean()

    def prepare_labels(self, label):
        """Both columns: the clean pass needs the original label, the
        adversarial pass the target."""
        y = torch.as_tensor(label, device=self.device).long()
        return y if y.ndim == 2 else torch.stack([y, y], dim=1)

    def dropout_mask(self, gen, x):
        """Each pixel value kept with probability 1 − ``drop_rate``."""
        keep = self.draw_rows(gen, torch.rand, x.shape, device=x.device) < 1.0 - self.drop_rate
        return keep.to(x.dtype)

    def keepres_draws(self, gen, x):
        return keepres_draws(gen, x.shape[1], device=x.device)

    def _agg_grad(self, point, labels, gen):
        mean = self.model.module.preprocess.mean
        agg = 0.0
        for _ in range(self.num_ens):
            dropped = mean + self.dropout_mask(gen, point) * (point - mean)
            logits, feats = self.model.features(dropped, (self.mid_layer,))
            (g,) = torch.autograd.grad(picked_logits(logits[None], labels).sum(),
                                       feats[self.mid_layer])
            self.grad_evals += 1
            agg = agg + g.float()
        return l2_normalize(agg)

    def run(self, x, y, gen):
        y_ori, y_tar = y[:, 0], y[:, 1]
        init_delta = super().run(x, y_tar, gen).detach()
        agg_clean = self._agg_grad(x, y_ori, gen)
        combined = self._agg_grad(x + init_delta, y_tar, gen) - self.beta_combine * agg_clean
        data_adv = x + init_delta
        delta, mom = torch.zeros_like(x), torch.zeros_like(x)
        for _ in range(self.ft_epoch):
            d = delta.requires_grad_(True)
            pts = keepres(data_adv + d, **self.keepres_draws(gen, x))
            feat = self.model.feature(pts, self.mid_layer)[1]
            (grad,) = torch.autograd.grad((combined * feat).sum(), d)
            self.grad_evals += 1
            mom = self.get_momentum(smooth_conv(grad, self.kernel), mom)
            d = torch.clamp(init_delta + d.detach() + self.alpha_ft * torch.sign(mom),
                            -self.eps, self.eps) - init_delta
            delta = torch.clamp(d, img_min - data_adv, img_max - data_adv)
        return torch.clamp(x + init_delta + delta, img_min, img_max) - x
