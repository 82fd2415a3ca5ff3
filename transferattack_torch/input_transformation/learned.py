"""The learned-transformation attacks (counterpart of
``input_transformation/learned.py``; the reference's
``input_transformation/{atta,stm,pam,aitl,lpm}.py``).

Each leans on an auxiliary network: ATTA's transformation CNN, STM's style
network, PAM's semantic predictor, AITL's encoder, decoder and predictor.
Each loads ``$TA_TPU_WEIGHTS_DIR/<name>.npz`` in the JAX package's flat
layout through the weights bridge; without it the attack warns, records the
fallback and runs on a seeded init (PAM: ratios of 1; AITL: its random
combos unrefined), as JAX does.  The auxiliary networks run in fp32 under a
low-precision surrogate, as JAX's do.  LPM scores candidate patch masks with
a genetic search on the host, in numpy, as JAX does; its candidates' inner
attacks stack on the batch axis.

JAX draws inline where the port has seams: STM's :meth:`STM.style_draws`,
AITL's :meth:`AITL.transform_lists` and :meth:`AITL.list_draws`, LPM's
:meth:`LPM.score_all`.
"""
from __future__ import annotations

import functools
import os
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..attack import AttackState, l1_normalize, mean_over_draws, softmax_cross_entropy
from ..gradient.mifgsm import MIFGSM
from ..models import (IMAGENET_MEAN, IMAGENET_STD, aux_path, load_aux, load_npz, make_model,
                      nhwc, record_fallback)
from ..models.mobilenet import MobileNetV2
from .aitl_ops import apply_op, op_draws


# -- ATTA -----------------------------------------------------------------

class ATTAModel(nn.Module):
    """The adversarial-transformation CNN: ImageNet normalization, a 3×3
    conv, the reference's ``LeakyReLU(True)`` (a negative slope of 1: the
    identity), a 15×15 conv.  JAX's ``conv_0``/``conv_2`` are ``conv.0``/
    ``conv.2``."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(3, 3, 3, padding=1), nn.Identity(),
                                  nn.Conv2d(3, 3, 15, padding=7))
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).reshape(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).reshape(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x):
        return self.conv((x - self.mean) / self.std)


class ATTA(MIFGSM):
    """Official args: gamma=1.0 — CE at the adversary plus γ·CE at its
    learned transformation, both points through the surrogate as one
    batch."""

    def __init__(self, model_name="resnet50", gamma=1.0, **kwargs):
        kwargs.setdefault("attack", "ATTA")
        super().__init__(model_name, **kwargs)
        self.gamma = float(gamma)
        self.atta = load_aux(ATTAModel(), "atta_model", 7, self.device)

    def get_grad(self, x, y, state: AttackState, gen):
        delta = state.delta.detach().requires_grad_(True)
        adv = x + delta
        logits = self.get_logits(torch.stack([adv, nhwc(self.atta, adv)]))
        self.grad_evals += 2
        loss = self.get_loss(logits[:1], y) + self.gamma * self.get_loss(logits[1:], y)
        return torch.autograd.grad(loss, delta)[0], {}


# -- STM ------------------------------------------------------------------

def instance_norm(h, eps=1e-5):
    """InstanceNorm2d without affine parameters, NCHW: per image and
    channel, biased variance."""
    mu = h.mean(dim=(2, 3), keepdim=True)
    var = ((h - mu) ** 2).mean(dim=(2, 3), keepdim=True)
    return (h - mu) / torch.sqrt(var + eps)


class ReflectConv(nn.Conv2d):
    """A conv on an input reflect-padded by ``kernel // 2``."""

    def forward(self, x):
        p = self.kernel_size[0] // 2
        return super().forward(F.pad(x, (p, p, p, p), mode="reflect"))


class ConvInRelu(nn.Module):
    """Reflect-pad conv → InstanceNorm → ReLU."""

    def __init__(self, cin, cout, kernel, stride=1):
        super().__init__()
        self.conv = ReflectConv(cin, cout, kernel, stride)

    def forward(self, x, style):
        return F.relu(instance_norm(self.conv(x)))


def _modulate(h, gamma, beta):
    return gamma[:, :, None, None] * h + beta[:, :, None, None]


class UpsampleConvInRelu(nn.Module):
    """Optional nearest ×2 → reflect conv → InstanceNorm → the style's γ/β
    → optional ReLU."""

    def __init__(self, cin, cout, kernel, upsample=0, activation=True):
        super().__init__()
        self.fc_beta, self.fc_gamma = nn.Linear(100, cout), nn.Linear(100, cout)
        self.conv = ReflectConv(cin, cout, kernel)
        self.upsample, self.activation = upsample, activation

    def forward(self, x, style):
        if self.upsample:
            x = F.interpolate(x, scale_factor=self.upsample, mode="nearest")
        x = _modulate(instance_norm(self.conv(x)), self.fc_gamma(style), self.fc_beta(style))
        return F.relu(x) if self.activation else x


class GhiasiResidualBlock(nn.Module):
    """Two style-modulated reflect-pad convs around a skip."""

    def __init__(self, channels):
        super().__init__()
        for name in ("fc_beta1", "fc_gamma1", "fc_beta2", "fc_gamma2"):
            setattr(self, name, nn.Linear(100, channels))
        self.conv1 = ReflectConv(channels, channels, 3)
        self.conv2 = ReflectConv(channels, channels, 3)

    def forward(self, x, style):
        h = F.relu(_modulate(instance_norm(self.conv1(x)), self.fc_gamma1(style),
                             self.fc_beta1(style)))
        h = _modulate(instance_norm(self.conv2(h)), self.fc_gamma2(style), self.fc_beta2(style))
        return x + h


class StyleNet(nn.Module):
    """Ghiasi's style-transfer network: three conv layers, five
    style-modulated residual blocks, three upsample-conv layers, a sigmoid;
    NCHW image and a (B, 100) style in.  JAX's ``layers_i`` is
    ``layers.i``."""

    def __init__(self):
        super().__init__()
        self.layers = nn.ModuleList(
            [ConvInRelu(3, 32, 9), ConvInRelu(32, 64, 3, 2), ConvInRelu(64, 128, 3, 2)]
            + [GhiasiResidualBlock(128) for _ in range(5)]
            + [UpsampleConvInRelu(128, 64, 3, upsample=2),
               UpsampleConvInRelu(64, 32, 3, upsample=2),
               UpsampleConvInRelu(32, 3, 9, activation=False)])

    def forward(self, x, style):
        for layer in self.layers:
            x = layer(x, style)
        return torch.sigmoid(x)


class STM(MIFGSM):
    """Style-transfer mixup: ``x_s = γ·x + (1 − γ)·styled + U(±β·eps)``, the
    gradients at ``num_style`` styled points averaged (``sample_chunk`` of
    them through the surrogate as one batch).  A style is ``N(0, 1) @ Aᵀ +
    mean`` of the style-embedding distribution (``stm_embeddings.npz``,
    else the standard normal)."""

    def __init__(self, model_name="resnet50", num_style=20, gamma=0.5, beta=2.0,
                 sample_chunk=4, **kwargs):
        kwargs.setdefault("attack", "STM")
        super().__init__(model_name, **kwargs)
        self.num_style = int(num_style)
        self.gamma_mix = float(gamma)
        self.beta = float(beta)
        self.sample_chunk = int(sample_chunk)
        self.stylenet = load_aux(StyleNet(), "stm_stylenet", 17, self.device)
        path = aux_path("stm_embeddings")
        if path is not None:
            emb = load_npz(path)
            mean, A = emb["pbn_embedding_mean"], emb["A"]
        else:
            record_fallback("stm_embeddings")
            warnings.warn("stm_embeddings.npz not found; the standard normal style.")
            mean, A = np.zeros((1, 100)), np.eye(100)
        self.style_mean = torch.tensor(np.asarray(mean, np.float32).reshape(1, 100),
                                       device=self.device)
        self.style_A = torch.tensor(np.asarray(A, np.float32).reshape(100, 100),
                                    device=self.device)

    def style_draws(self, gen, x, state: AttackState, k: int):
        """``k`` styles' standard normals (k, B, 100) and noises
        (k, B, H, W, C), U(±β·eps)."""
        r = self.eps * self.beta
        z = self.draw_rows(gen, torch.randn, (k, x.shape[0], 100), batch_axis=1, device=x.device)
        noise = (self.draw_rows(gen, torch.rand, (k,) + tuple(x.shape), batch_axis=1,
                                device=x.device) * (2 * r) - r)
        return z, noise

    def get_grad(self, x, y, state: AttackState, gen):
        xadv = x + state.delta

        def styled_points(g, k):
            z, noise = self.style_draws(g, x, state, k)
            style = z.reshape(-1, 100) @ self.style_A.T + self.style_mean
            with torch.no_grad():
                styled = nhwc(self.stylenet, xadv.repeat(k, 1, 1, 1), style)
            mixed = self.gamma_mix * xadv + (1 - self.gamma_mix) * styled.reshape(noise.shape)
            return self.input_grads(mixed + noise, y, state, g)

        return mean_over_draws(styled_points, gen, self.num_style, self.sample_chunk), {}


# -- PAM ------------------------------------------------------------------

class SemanticPredictor(nn.Module):
    """PAM's predictor: conv 5×5 → avgpool 4 → conv 5×5 → avgpool 4 →
    fc(196 → 8) → sigmoid·0.1 + 0.9, the per-image ratios of the 8
    baselines.  Its fc fits 224² inputs only."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 3, 5, padding=2)
        self.conv2 = nn.Conv2d(3, 1, 5, padding=2)
        self.fc = nn.Linear(196, 8)

    def forward(self, x):
        h = F.avg_pool2d(F.relu(self.conv1(x)), 4)
        h = F.avg_pool2d(F.relu(self.conv2(h)), 4)
        return torch.sigmoid(self.fc(h.flatten(1))) * 0.1 + 0.9


# the 8 augmentation paths' baseline colours
PAM_BASELINES = ((0.0, 0.0, 0.0), (0.5, 0.5, 0.5), (1.0, 1.0, 1.0), (0.5, 0.5, 0.0),
                 (1.0, 1.0, 0.5), (1.0, 0.5, 1.0), (0.5, 1.0, 1.0), (0.0, 0.5, 0.5))


class PAM(MIFGSM):
    """Path augmentation: each iteration the plain gradient plus 32 times
    the mean gradient over the 8-path × 4-scale copies
    ``x/2^i + base_p·ratio_p·(1 − 1/2^i)``; the plain CE is not negated when
    targeted, the copies' is (JAX's, kept).  The plain point and the 32·B
    copies go through the surrogate as one batch.  The predictor loads from
    ``pam_semantic_predictor.npz``; without it every ratio is 1.
    :meth:`train_sp` trains one and writes that file."""

    def __init__(self, model_name="resnet50", num_aug_path=8, num_scale=4,
                 train_epoch=15, **kwargs):
        kwargs.setdefault("attack", "PAM")
        super().__init__(model_name, **kwargs)
        self.num_aug_path = int(num_aug_path)
        self.num_scale = int(num_scale)
        self.train_epoch = int(train_epoch)
        if aux_path("pam_semantic_predictor") is not None:
            self.sp = load_aux(SemanticPredictor(), "pam_semantic_predictor", 0, self.device)
        else:
            record_fallback("pam_semantic_predictor")
            warnings.warn("PAM: pam_semantic_predictor.npz missing; using ratios=1")
            self.sp = None
        self.baselines = torch.tensor(PAM_BASELINES, device=self.device)

    def ratios(self, x):
        if self.sp is None:
            return torch.ones((x.shape[0], self.num_aug_path), device=x.device)
        with torch.no_grad():
            return self.sp(x.permute(0, 3, 1, 2))

    def copies(self, xadv, ratios):
        """(32, B, H, W, C): path-major, scale-minor."""
        out = []
        for p in range(self.num_aug_path):
            base = self.baselines[p].reshape(1, 1, 1, 3) * ratios[:, p].reshape(-1, 1, 1, 1)
            for i in range(1, self.num_scale + 1):
                out.append(xadv * (1.0 / 2**i) + base * (1 - 1.0 / 2**i))
        return torch.stack(out)

    def sp_loss(self, sp: nn.Module, x, y):
        """The predictor's objective on NHWC ``x`` (``pam.py:136-211``): image
        0 mixed with each of the 8 baselines at the predicted ratios, and
        the sum over the 8 copies of the squared margin between the logit
        of ``y[0]`` and the runner-up."""
        pred = sp(x.permute(0, 3, 1, 2))[0].reshape(-1, 1, 1, 1)  # (8, 1, 1, 1)
        x_aug = x[:1] * (1 - pred) + self.baselines.reshape(-1, 1, 1, 3) * pred
        logits = self.get_logits(x_aug[None])[0]
        rows = torch.arange(logits.shape[0], device=logits.device)
        yrep = y[:1].expand(logits.shape[0])
        true = logits[rows, yrep]
        second = logits.index_put((rows, yrep), torch.full_like(true, -torch.inf)).max(dim=1).values
        return torch.sum((true - second) ** 2)

    def train_sp(self, input_dir: str, lr: float = 1e-4, batch_size: int = 1,
                 save_name: str = "pam_semantic_predictor") -> nn.Module:
        """``train_SP`` (``pam.py:136-211``): ``train_epoch`` epochs of Adam
        (optax's: betas 0.9 and 0.999, eps 1e-8) on :meth:`sp_loss` over the
        ``AdvDataset`` of ``input_dir``, the label of a targeted run its
        second column; writes ``<save_name>.npz`` to the weights directory,
        sets ``self.sp`` and returns it.  The predictor starts from the
        port's own draw (a CPU generator seeded 0; JAX: ``PRNGKey(0)``)."""
        from ..generation.train import adam
        from ..models import init_weights, weights_root
        from ..utils.bridge import save_flat_variables
        from ..utils.data import AdvDataset

        sp = SemanticPredictor()
        init_weights(sp, torch.Generator().manual_seed(0))
        sp = sp.to(self.device).requires_grad_(True)
        opt = adam(sp.parameters(), lr)
        ds = AdvDataset(input_dir=input_dir)
        for _ in range(self.train_epoch):
            for xs, ys, _names in ds.as_batches(batch_size):
                y = torch.as_tensor(ys, device=self.device).long()
                if y.ndim == 2:
                    y = y[:, 1] if self.targeted else y[:, 0]
                loss = self.sp_loss(sp, torch.from_numpy(xs).to(self.device), y)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
        self.sp = sp.eval().requires_grad_(False)
        save_flat_variables(self.sp, os.path.join(weights_root(), f"{save_name}.npz"))
        return self.sp

    def get_grad(self, x, y, state: AttackState, gen):
        ratios = self.ratios(x)
        delta = state.delta.detach().requires_grad_(True)
        xadv = x + delta
        n = self.num_aug_path * self.num_scale
        logits = self.get_logits(torch.cat([xadv[None], self.copies(xadv, ratios)]))
        self.grad_evals += n + 1
        ce_copies = self.batch_share(softmax_cross_entropy(logits[1:], y))
        loss = (self.batch_share(softmax_cross_entropy(logits[0], y))
                + n * (-ce_copies if self.targeted else ce_copies))
        return torch.autograd.grad(loss, delta)[0], {}


# -- AITL -----------------------------------------------------------------

class AITLEncoder(nn.Module):
    """3 × (Linear → ReLU → Dropout → BatchNorm1d), eval mode: the 80-dim
    one-hot combo to a 128-dim latent.  JAX's ``fc{i}_0``/``fc{i}_3`` are
    ``fc{i}.0``/``fc{i}.3``."""

    def __init__(self, hidden=128):
        super().__init__()
        for i, cin in ((1, 80), (2, hidden), (3, hidden)):
            setattr(self, f"fc{i}", nn.Sequential(nn.Linear(cin, hidden), nn.ReLU(),
                                                  nn.Dropout(), nn.BatchNorm1d(hidden)))

    def forward(self, x):
        return self.fc3(self.fc2(self.fc1(x)))


class AITLDecoder(nn.Module):
    """Only ``fc4`` takes part in the forward: latent → 80 logits (4 × 20)."""

    def __init__(self, hidden=128):
        super().__init__()
        self.fc4 = nn.Linear(hidden, 80)

    def forward(self, x):
        return self.fc4(x)


class AITLPredictor(nn.Module):
    """MobileNetV2 (its classifier 1280 → 128) on the raw NCHW image, then
    an MLP over [image features ∥ latent] to the predicted success (fc1,
    fc5, fc6; the reference's fc2-4 are dead)."""

    def __init__(self, hidden=128):
        super().__init__()
        self.backbone = MobileNetV2(num_classes=hidden)
        self.fc1 = nn.Sequential(nn.Linear(2 * hidden, hidden), nn.ReLU())
        self.fc5 = nn.Sequential(nn.Linear(hidden, hidden), nn.ReLU())
        self.fc6 = nn.Linear(hidden, 1)

    def forward(self, x, feature_trans):
        feats = self.backbone(x).expand(feature_trans.shape[0], -1)
        return self.fc6(self.fc5(self.fc1(torch.cat([feats, feature_trans], -1))))


class AITL(MIFGSM):
    """Adaptive input-transformation learning: once a batch, ``num_lists``
    random combos of ``num_ops`` of the 20 ops (:meth:`transform_lists`),
    each refined by ``refine_steps`` sign-ascent steps (γ = 15) of the
    encoder's latent on the predictor's estimate and decoded back to ops;
    each iteration the L1-normalized gradients at the combos' transformed
    points are averaged (the lists' points through the surrogate as one
    batch), and the momentum adds that without normalizing again.  Without
    all three checkpoints the combos stay as drawn."""

    def __init__(self, model_name="resnet50", num_lists=5, num_ops=4,
                 gamma=15.0, refine_steps=3, **kwargs):
        kwargs.setdefault("attack", "AITL")
        super().__init__(model_name, **kwargs)
        self.num_lists = int(num_lists)
        self.num_ops = int(num_ops)
        self.gamma = float(gamma)
        self.refine_steps = int(refine_steps)
        names = ("aitl_encoder", "aitl_decoder", "aitl_predictor")
        if all(aux_path(n) is not None for n in names):
            self.encoder, self.decoder, self.predictor = (
                load_aux(net, n, 0, self.device)
                for net, n in zip((AITLEncoder(), AITLDecoder(), AITLPredictor()), names))
        else:
            record_fallback("aitl_encoder/decoder/predictor")
            warnings.warn("AITL: encoder/decoder/predictor checkpoints missing; transform "
                          "combos stay at their random initialization (fallback).")
            self.encoder = self.decoder = self.predictor = None

    def transform_lists(self, x):
        """The batch's initial combos, (num_lists, num_ops) op indices in
        [0, 20), from a generator seeded by ``seed`` and a salt of the
        data: batches differ, iterations within one agree."""
        # in fp64, so that the card's and the CPU's sums give one salt
        salt = int(torch.remainder(self.whole_batch(x).double().abs().sum() * 1e4, 1e6))
        gen = torch.Generator().manual_seed((self.seed + 131) * 1_000_003 + salt)
        return torch.randint(0, 20, (self.num_lists, self.num_ops), generator=gen)

    def refine_lists(self, x, idx0):
        """Each combo's latent moved ``refine_steps`` sign steps up the
        predictor's estimate at ``x[:1]``, decoded to 0-based op indices."""
        onehot = F.one_hot(idx0.long().to(x.device), 20).float().reshape(idx0.shape[0], -1)
        img = self.whole_batch(x)[:1].permute(0, 3, 1, 2)
        with torch.no_grad():
            h = self.encoder(onehot)
        for _ in range(self.refine_steps):
            hh = h.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self.predictor(img, hh).sum(), hh)
            h = h + self.gamma * torch.sign(g)
        with torch.no_grad():
            logits = self.decoder(h).reshape(idx0.shape[0], -1, 20)
        return logits.argmax(-1)

    def init_extra(self, x, y):
        idx0 = self.transform_lists(x)
        if self.encoder is not None:
            idx0 = self.refine_lists(x, idx0)
        return {"aitl_lists": (idx0 + 1).tolist()}

    def list_draws(self, gen, x, state: AttackState, lists):
        """Each list's ops' draws: ``[[draws of op j] for each list]``."""
        return [[op_draws(gen, op, x.shape, x.device, self.data_split) for op in ops]
                for ops in lists]

    def get_grad(self, x, y, state: AttackState, gen):
        lists = state.extra["aitl_lists"]
        draws = self.list_draws(gen, x, state, lists)
        points = (x + state.delta).detach()[None].repeat(len(lists), 1, 1, 1, 1)
        points.requires_grad_(True)
        views = []
        for i, ops in enumerate(lists):
            pt = points[i]
            for op, d in zip(ops, draws[i]):
                pt = apply_op(pt, op, d, functools.partial(self.whole_batch, grad=True))
            views.append(pt)
        logits = self.get_logits(torch.stack(views))
        self.grad_evals += len(lists)
        loss = sum(self.get_loss(part, y) for part in logits.chunk(len(lists)))
        (grads,) = torch.autograd.grad(loss, points)
        return sum(l1_normalize(g) for g in grads) / len(lists), {}

    def get_momentum(self, grad, momentum):
        # each list's gradient is normalized already
        return momentum * self.decay + grad


# -- LPM ------------------------------------------------------------------

class LPM(MIFGSM):
    """Learnable patch-wise masks, at batch 1:

    - a genetic search (population 40, 10 generations; rank, inbreeding
      crossover, mutation, greedy unique selection, in numpy from
      ``RandomState(seed + idx)``) over binary 7×7 patch masks;
    - each candidate's fitness: a 10-iteration masked MI-FGSM on the
      surrogate (the mask multiplies the whole adversarial image), scored
      unmasked on the gray models as var + mean of their −CE (minimized).
      ``score_chunk`` candidates go through one inner attack stacked on the
      batch axis (a short chunk padded with its first row);
    - the final attack: each iteration the summed gradients of ``m_num``
      masks, cycling the ranked population.

    densenet201 stands in for the reference's densenet161, as in JAX.
    """

    requires_batchsize = 1
    # its ``__call__`` runs the genetic mask search on the host (JAX's flag)
    host_state = True

    def __init__(self, model_name="resnet50",
                 gray_models=("resnet50", "vgg16", "densenet201"),
                 patch_grid=7, pop_size=40, de_iters=10, score_chunk=20,
                 m_num=12, inner_epoch=10, **kwargs):
        kwargs.setdefault("attack", "LPM")
        super().__init__(model_name, **kwargs)
        self.patch_grid = int(patch_grid)
        self.pop_size = int(pop_size)
        self.de_iters = int(de_iters)
        self.score_chunk = int(score_chunk)
        self.m_num = int(m_num)
        self.inner_epoch = int(inner_epoch)
        self.gray = [make_model(n, pretrained=kwargs.get("pretrained", True),
                                input_size=kwargs.get("input_size"), device=self.device)
                     for n in gray_models]

    def mask_full(self, bits, H: int, W: int):
        """(n, H, W, 1) pixel masks of (n, g²) patch bits; H and W must be
        multiples of the grid."""
        g = self.patch_grid
        if H % g or W % g:
            raise ValueError(f"LPM: image {H}x{W} is not divisible by the {g}x{g} grid")
        cells = torch.as_tensor(bits, dtype=torch.float32, device=self.device)
        cells = cells.reshape(-1, g, g)
        m = cells.repeat_interleave(H // g, dim=1).repeat_interleave(W // g, dim=2)
        return m[..., None]

    def masked_grad(self, x, y, delta, masks):
        """Each mask's gradient at ``delta`` (all (n, H, W, C)), the n
        masked points through the surrogate as one batch."""
        d = delta.detach().requires_grad_(True)
        logits = self.model.apply((x + d) * masks)
        self.grad_evals += 1
        ce = softmax_cross_entropy(logits, y.expand(logits.shape[0])).sum()
        return torch.autograd.grad(-ce if self.targeted else ce, d)[0]

    def score_chunk_of(self, x, y, bits):
        """The fitness of each row of ``bits`` (n, g²): n candidates' inner
        attacks stacked on the batch axis."""
        n = bits.shape[0]
        masks = self.mask_full(bits, x.shape[1], x.shape[2])
        xs = x.expand(n, -1, -1, -1).contiguous()
        delta, mom = torch.zeros_like(xs), torch.zeros_like(xs)
        for _ in range(self.inner_epoch):
            mom = self.get_momentum(self.masked_grad(xs, y, delta, masks), mom)
            delta = self.update_delta(delta, xs, mom)
        with torch.no_grad():
            xadv = xs + delta  # scored unmasked
            losses = torch.stack([-softmax_cross_entropy(g.apply(xadv), y.expand(n))
                                  for g in self.gray])
        self.forward_evals += len(self.gray)
        return (losses.var(0, unbiased=False) + losses.mean(0)).cpu().numpy()

    def score_all(self, x, y, bits):
        """Every candidate's fitness, in chunks of ``score_chunk``."""
        outs = []
        for s in range(0, len(bits), self.score_chunk):
            chunk = bits[s:s + self.score_chunk]
            padn = self.score_chunk - len(chunk)
            if padn:
                chunk = np.concatenate([chunk, np.repeat(chunk[:1], padn, 0)])
            outs.append(self.score_chunk_of(x, y, chunk)[:self.score_chunk - padn])
        return np.concatenate(outs)

    def final_attack(self, x, y, chrom):
        """``epoch`` iterations, each the sum of ``m_num`` masks' gradients
        (the ranked population cycled)."""
        P = chrom.shape[0]
        masks = self.mask_full(chrom, x.shape[1], x.shape[2])
        xs = x.expand(self.m_num, -1, -1, -1)
        delta, mom = torch.zeros_like(x), torch.zeros_like(x)
        for t in range(self.epoch):
            sel = [(t * self.m_num + j) % P for j in range(self.m_num)]
            grads = self.masked_grad(xs, y, delta.expand_as(xs), masks[sel])
            mom = self.get_momentum(grads.sum(0, keepdim=True), mom)
            delta = self.update_delta(delta, x, mom)
        return delta

    # the host-side GA operators, JAX's (the reference's MyDE), bit for bit

    def ga_crossover(self, chrom, rng):
        P, L = self.pop_size, chrom.shape[1]
        superior = max(int(0.3 * P), 2)
        cross_n = max(int(0.3 * P), 1)
        sup = chrom[:superior]
        out = np.zeros((cross_n, L), int)
        for i in range(cross_n):
            n1 = rng.randint(0, superior, 2)
            while n1[0] == n1[1]:
                n1 = rng.randint(0, superior, 2)
            check_1, check_2 = 1, 0
            for j in range(L):
                a, b = sup[n1[0]][j], sup[n1[1]][j]
                if a == 1 and b == 1:
                    out[i][j] = 1
                elif a == 0 and b == 0:
                    out[i][j] = 0
                elif a == 1 and b == 0:
                    out[i][j] = sup[n1[check_1]][j]
                    check_1 = 1 - check_1
                else:
                    out[i][j] = sup[n1[check_2]][j]
                    check_2 = 1 - check_2
        return out

    def ga_mutation(self, L, rng):
        n = max(int(self.pop_size * 0.7), 1)
        zeros_len = int(0.1 * L)
        rows = np.concatenate([np.zeros((n, zeros_len)), np.ones((n, L - zeros_len))], axis=1)
        for i in range(n):
            rows[i] = rng.permutation(rows[i])
        return rows.astype(int)

    def ga_select(self, chrom, Y, offspring, f_off):
        sel = np.vstack([offspring, chrom])
        selY = np.concatenate([f_off, Y])
        a, idx = np.unique(selY, return_index=True)
        uniq = sel[idx]
        P = self.pop_size
        if len(a) >= P:
            return uniq[:P].copy(), a[:P].copy()
        newC, newY = chrom.copy(), Y.copy()
        newC[: len(a)], newY[: len(a)] = uniq, a
        newC[len(a):], newY[len(a):] = uniq[-1], a[-1]
        return newC, newY

    def __call__(self, data, label, generator=None, idx: int = 0):
        x = torch.as_tensor(data, dtype=torch.float32, device=self.device).contiguous()
        y = self.prepare_labels(label)
        if x.shape[0] != 1:
            raise ValueError("LPM requires batchsize 1")
        rng = np.random.RandomState(self.seed + idx)
        g2 = self.patch_grid ** 2
        chrom = rng.randint(0, 2, (self.pop_size, g2))
        Y = self.score_all(x, y, chrom)
        for _ in range(self.de_iters):
            order = np.argsort(Y)
            chrom, Y = chrom[order], Y[order]
            off = np.vstack([self.ga_crossover(chrom, rng), self.ga_mutation(g2, rng)])
            chrom, Y = self.ga_select(chrom, Y, off, self.score_all(x, y, off))
        return self.final_attack(x, y, chrom[np.argsort(Y)])
