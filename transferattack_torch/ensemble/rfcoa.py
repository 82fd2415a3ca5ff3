"""RFCoA, the robust-feature collaborative attack (counterpart of
``ensemble/rfcoa.py``; the reference's ``ensemble/rfcoa/rfcoa.py``).

Targeted.  A VGG-16 autoencoder encodes the image; the target class's
robust feature is blended into the latent by a learned weight ``alpha``,
the decoded image is composited into the clean one through a learned pixel
``mask``, and 300 Adam steps on both minimise the ensemble's targeted loss
plus the cognition terms (L1 and TV of the mask, minus SSIM).  The result is
``clip(adv, 0, 1) − x``, which is not bounded by eps: only [0, 1] holds.

The autoencoder loads from ``$TA_TPU_WEIGHTS_DIR/rfcoa_autoencoder.npz``
(JAX's ``params/encoder/enc_i``, ``params/decoder/dec_i`` and ``dec_out``)
through the weights bridge, or runs on a seeded init.  The per-class robust
features are the JAX package's vendored arrays, in this package's own
byte-for-byte copy ``assets/rfcoa/<cls>.npz`` ((1, 512, 7, 7) NCHW), read
with numpy; then ``$TA_TPU_WEIGHTS_DIR/rfcoa_<cls>.npz``; then N(0, 1)
from a generator seeded ``cls``.  The Adam steps are optax's, written
out (:func:`~..model_related.llta.adam_step`); the update kernel is not on
this path.
"""
from __future__ import annotations

import os
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..advanced_objective.cfm import jax_abs
from ..attack import draw, softmax_cross_entropy
from ..model_related.llta import adam_step
from ..models import init_weights, load_npz, nhwc, record_fallback, weights_root
from ..ops.image import scale_and_translate
from ..utils import generation_target_classes
from ..utils.bridge import load_flat_variables
from .ens import _MultiModelAttack

VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M"]
FEATURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "assets", "rfcoa")


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class VGGEncoder(nn.Module):
    """VGG-16's 13 convs with ReLU and its five 2×2 max pools: NCHW image
    to a (512, H/32, W/32) latent.  JAX's ``enc_i`` is ``enc.i``."""

    def __init__(self):
        super().__init__()
        chans = [c for c in VGG16_CFG if c != "M"]
        self.enc = nn.ModuleList(_conv3(cin, cout) for cin, cout in zip([3] + chans, chans))

    def forward(self, x):
        i = 0
        for v in VGG16_CFG:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(self.enc[i](x))
                i += 1
        return x


class VGGDecoder(nn.Module):
    """The 13 convs in reverse with a nearest ×2 upsample before every third
    (and before ``dec_out``), then a sigmoid: latent to NCHW image."""

    def __init__(self):
        super().__init__()
        chans = list(reversed([c for c in VGG16_CFG if c != "M"]))
        self.dec = nn.ModuleList(_conv3(cin, cout) for cin, cout in zip([512] + chans, chans))
        self.dec_out = _conv3(chans[-1], 3)

    def forward(self, z):
        for i, conv in enumerate(self.dec):
            if i % 3 == 0 and i > 0:
                z = F.interpolate(z, scale_factor=2, mode="nearest")
            z = F.relu(conv(z))
        z = F.interpolate(z, scale_factor=2, mode="nearest")
        return torch.sigmoid(self.dec_out(z))


def ssim(a, b, c1=0.01**2, c2=0.03**2):
    """SSIM from each image's global statistics (biased variances), over
    NHWC batches, averaged over the batch."""
    dims = (1, 2, 3)
    mu_a, mu_b = a.mean(dims), b.mean(dims)
    var_a, var_b = a.var(dims, unbiased=False), b.var(dims, unbiased=False)
    cov = ((a - mu_a.reshape(-1, 1, 1, 1)) * (b - mu_b.reshape(-1, 1, 1, 1))).mean(dims)
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    return (num / den).mean()


def total_variation(t):
    """Anisotropic TV of an NHWC batch, each difference as ``d·sign(d)``:
    ``|d|`` with a zero derivative at 0 (torch's), where a flat mask would
    otherwise take ``abs``'s unit derivative in JAX."""
    dh = t[:, 1:] - t[:, :-1]
    dw = t[:, :, 1:] - t[:, :, :-1]
    return (dh * torch.sign(dh)).sum() + (dw * torch.sign(dw)).sum()


def robust_feature(cls: int, root: str) -> tuple:
    """(the (1, 7, 7, 512) NHWC feature of target class ``cls``, where it
    came from)."""
    for path in (os.path.join(FEATURE_DIR, f"{cls}.npz"),
                 os.path.join(root, f"rfcoa_{cls}.npz")):
        if os.path.exists(path):
            with np.load(path) as f:
                arr = f["array"]
            if arr.ndim == 4 and arr.shape[1] == 512:
                arr = arr.transpose(0, 2, 3, 1)
            return torch.from_numpy(np.ascontiguousarray(arr, np.float32)), path
    return None, os.path.join(root, f"rfcoa_{cls}.npz")


class RFCoA(_MultiModelAttack):
    """Official args: epoch=300, targeted, the ensemble of resnet50, vgg16
    and densenet121 whenever ``model_name`` is not a list.  ``grad_evals``
    counts one a member for each backward through the ensemble (the
    saliency map, then each Adam step); ``losses`` holds the last call's
    loss at its first and its last step."""

    # its ``__call__`` drives the Adam mask/alpha loop on the host (JAX's flag)
    host_state = True

    def __init__(self, model_name=None, epoch=300, eps=16 / 255, targeted=True,
                 random_start=True, norm="linfty", loss="crossentropy",
                 attack="RFCoA", **kwargs):
        if model_name is None or isinstance(model_name, str):
            model_name = ["resnet50", "vgg16", "densenet121"]
        super().__init__(model_name, epoch=epoch, eps=eps, targeted=targeted,
                         random_start=random_start, norm=norm, loss=loss,
                         attack=attack, **kwargs)
        self.encoder, self.decoder = VGGEncoder(), VGGDecoder()
        self._feat_root = weights_root()
        path = os.path.join(self._feat_root, "rfcoa_autoencoder.npz")
        if os.path.exists(path):
            packed = load_npz(path)
            for part, net in (("encoder", self.encoder), ("decoder", self.decoder)):
                prefix = f"params/{part}/"
                load_flat_variables(net, {"params/" + k[len(prefix):]: v
                                          for k, v in packed.items() if k.startswith(prefix)})
        else:
            record_fallback("rfcoa_autoencoder")
            warnings.warn("RFCoA: rfcoa_autoencoder.npz not found; random AE.")
            gen = torch.Generator().manual_seed(11)
            init_weights(self.encoder, gen)
            init_weights(self.decoder, gen)
        for net in (self.encoder, self.decoder):
            net.eval().requires_grad_(False).to(self.device)

    def robust_feature(self, idx: int, z_shape) -> torch.Tensor:
        """Target class ``idx``'s robust feature, (1, h, w, 512) NHWC, or
        without one N(0, 1) of the latent's shape ``z_shape``."""
        cls = generation_target_classes[idx]
        feature, path = robust_feature(cls, self._feat_root)
        if feature is None:
            record_fallback(path)
            warnings.warn(f"RFCoA: {path} missing; using random robust feature.")
            feature = torch.randn(tuple(z_shape), generator=torch.Generator().manual_seed(cls))
        return feature.to(self.device)

    def init_params(self, gen, x_shape, z_shape):
        """The starting (alpha, mask): U[0, 1] of the latent's and the
        image's shape."""
        return (draw(gen, torch.rand, z_shape, device=self.device),
                draw(gen, torch.rand, x_shape, device=self.device))

    def ensemble_ce(self, img, y):
        """The members' mean CE at ``img``, each member's CE a batch mean."""
        ce = sum(softmax_cross_entropy(m.apply(img), y).mean() for m in self.members)
        return ce / self.K

    def __call__(self, data, label, generator=None, idx: int = 0):
        x = torch.as_tensor(data, dtype=torch.float32, device=self.device).contiguous()
        label = torch.as_tensor(label, device=self.device).long()
        if label.ndim == 2:
            y_src, y_tgt = label[:, 0], label[:, 1]
        else:
            y_src = label
            y_tgt = torch.full_like(y_src, generation_target_classes[idx])
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(self.seed + idx)

        with torch.no_grad():
            org = nhwc(self.encoder, x)
        feature = self.robust_feature(idx, org.shape)
        if feature.shape[1:3] != org.shape[1:3]:
            # off the 224² path (latent 7×7): JAX's bilinear resize, which
            # antialiases when it shrinks
            fh, fw = feature.shape[1:3]
            oh, ow = org.shape[1:3]
            feature = scale_and_translate(feature, (oh, ow), (oh / fh, ow / fw), (0.0, 0.0))
        feature = feature.expand(org.shape)

        # the spatial attention map: the ensemble CE's latent gradient at the
        # clean image's latent
        z = org.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(self.ensemble_ce(nhwc(self.decoder, z), y_src), z)
        self.grad_evals += self.K
        sam = torch.sigmoid(g.abs())

        alpha, mask = self.init_params(generator, x.shape, org.shape)
        self.losses = [None, None]
        state = {"alpha": [alpha, torch.zeros_like(alpha), torch.zeros_like(alpha)],
                 "mask": [mask, torch.zeros_like(mask), torch.zeros_like(mask)]}
        rates = {"mask": 0.002, "alpha": 0.04}
        for t in range(self.epoch):
            a = state["alpha"][0].detach().requires_grad_(True)
            m = state["mask"][0].detach().requires_grad_(True)
            decoded = nhwc(self.decoder, a * feature + (1 - sam) * org)
            decoded = m * decoded + (1 - m) * x
            adv = sum(5 * softmax_cross_entropy(lg, y_tgt).mean()
                      - 2 * softmax_cross_entropy(lg, y_src).mean()
                      for lg in (mem.apply(decoded) for mem in self.members)) / self.K
            # |mask| with JAX's derivative at 0 (1): a mask clipped to 0
            loss = (adv + 0.005 * jax_abs(m).sum() + 0.002 * total_variation(m)
                    - 200 * ssim(decoded, x))
            grads = dict(zip(("alpha", "mask"), torch.autograd.grad(loss, (a, m))))
            self.grad_evals += self.K
            for i, at in enumerate((0, self.epoch - 1)):  # the first and the last step's loss
                if t == at:
                    self.losses[i] = float(loss.detach())
            for k, (p, mu, nu) in state.items():
                p, mu, nu = adam_step(p, grads[k], mu, nu, t, rates[k])
                state[k] = [torch.clamp(p, 0.0, 1.0), mu, nu]
        alpha, mask = state["alpha"][0], state["mask"][0]
        with torch.no_grad():
            # the final composite takes sam·org, the loop (1 − sam)·org
            decoded = nhwc(self.decoder, alpha * feature + sam * org)
            adv = mask * decoded + (1 - mask) * x
        return torch.clamp(adv, 0.0, 1.0) - x
