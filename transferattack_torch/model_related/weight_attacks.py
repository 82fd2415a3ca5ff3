"""Attacks that edit the surrogate's weights (counterpart of
``model_related/weight_attacks.py``).

MUP: each iteration, the conv kernels' elements of least Taylor score
|w·∂L/∂w| (the smallest 15%) are masked before the attack gradient.
AWT: a SAM (sharpness-aware) update of the weights each iteration, then a
PGN-style neighbourhood gradient through the tuned weights; the weights,
the SGD buffer and the leftover gradient live in the attack's state and
start from the surrogate's own weights on every call.
FAUG: gaussian noise added at the stem conv's output through a tap.

The weights are differentiated through ``Surrogate.apply(params=)``
(``torch.func.functional_call``): the surrogate's module stays frozen and is
never written, so every batch starts from its weights.  They are in the
surrogate's dtype (bf16 under ``compute_dtype='bfloat16'``, as JAX casts
them), and so are the Taylor scores and the SAM step.
"""
from __future__ import annotations

import torch

from ..attack import Attack, AttackState
from ..gradient.mifgsm import MIFGSM
from ..gradient.pgn import IMAGE_DIMS


def _is_conv_kernel(name: str, w) -> bool:
    return w.ndim == 4 and name.endswith("weight")


def param_grads(atk, params, points, y):
    """Gradient of ``atk``'s loss summed over ``points`` (a list of
    (B, H, W, C) batches, through the surrogate as one batch) in each of
    ``params``, over the whole batch (on a rank, summed over the ranks:
    every row reads the weights)."""
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    logits = atk.model.apply(torch.cat(points),
                             params={k: atk.replicated(v) for k, v in p.items()}).float()
    atk.grad_evals += len(points)
    loss = sum(atk.get_loss(part[None], y) for part in logits.chunk(len(points)))
    return dict(zip(p, torch.autograd.grad(loss, list(p.values()))))


class MUP(MIFGSM):
    """Mask unimportant parameters: mask_ratio=0.15, taylor scores,
    alpha=2/255.  The reference demands batchsize=1; per-batch scores
    generalise it.  Each iteration's scores use a fresh parameter gradient
    (the reference rebuilds each pruned weight as a new ``nn.Parameter``)."""

    def __init__(self, model_name="resnet50", mask_ratio=0.15, mask_type="taylor",
                 **kwargs):
        kwargs.setdefault("attack", "MUP")
        kwargs.setdefault("alpha", 2 / 255)
        super().__init__(model_name, **kwargs)
        self.mask_ratio = float(mask_ratio)
        self.mask_type = mask_type

    def _pruned_params(self, x, y, state):
        params = self.model.parameters()
        grads = param_grads(self, params, [x + state.delta], y)
        pruned = {}
        for name, w in params.items():
            if not _is_conv_kernel(name, w):
                continue
            g = grads[name]
            if self.mask_type == "taylor":
                scores = (w * g).abs()
            elif self.mask_type == "grad":
                scores = g.abs()
            else:  # l1: each spatial kernel's norm, broadcast back
                scores = w.abs().sum(dim=(2, 3), keepdim=True).expand_as(w)
            # the int(numel·p)-th order statistic, not an interpolated quantile
            flat = scores.reshape(-1).sort().values
            thresh = flat[int(flat.shape[0] * self.mask_ratio)]
            pruned[name] = w * (scores > thresh).to(w.dtype)
        return pruned

    def get_grad(self, x, y, state: AttackState, gen):
        pruned = self._pruned_params(x, y, state)
        delta = state.delta.detach().requires_grad_(True)
        logits = self.model.apply(x + delta, params=pruned).float()
        self.grad_evals += 1
        (grad,) = torch.autograd.grad(self.get_loss(logits[None], y), delta)
        return grad, {}


class AWT(Attack):
    """Adversarial weight tuning: SAM(lr, rho, momentum=0.5) on the surrogate
    weights each iteration, then PGN-style neighbour gradients."""

    def __init__(self, model_name="resnet50", epoch=10, eps=16 / 255, alpha=1.6 / 255,
                 beta=3.0, gamma=0.5, num_neighbor=20, decay=1.0, sam_lr=0.002,
                 sam_rho=0.005, targeted=False, random_start=False, norm="linfty",
                 loss="crossentropy", sample_chunk=4, attack="AWT", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.zeta = beta * self.eps
        self.gamma = float(gamma)
        self.num_neighbor = int(num_neighbor)
        self.sam_lr = float(sam_lr)
        self.sam_rho = float(sam_rho)
        self.sample_chunk = int(sample_chunk)

    def init_extra(self, x, y):
        params = self.model.parameters()
        zeros = {k: torch.zeros_like(v) for k, v in params.items()}
        # the leftover parameter gradient: the reference never zeroes grads
        # before the first closure call, so iteration i's ascent direction
        # is g2 of iteration i − 1 plus its own closure gradient
        return {"params": params, "sgd_buf": zeros, "grad_residue": zeros}

    def _sam_update(self, params, buf, residue, x, delta, y):
        def closure_grads(p):  # CE at x + delta plus CE at x, one batch
            return param_grads(self, p, [x + delta, x], y)

        g_fresh = closure_grads(params)
        g = {k: residue[k] + g_fresh[k] for k in params}
        # each leaf's square sum accumulates in fp32, as XLA reduces; the
        # norm is then in the weights' dtype, as JAX's
        gn = torch.sqrt(sum((v.float() ** 2).sum() for v in g.values())) + 1e-12
        perturbed = {k: w + self.sam_rho * g[k] / gn.to(w.dtype) for k, w in params.items()}
        g2 = closure_grads(perturbed)
        # SGD(momentum=0.5) from the original weights (SAM's second step)
        buf = {k: 0.5 * buf[k] + g2[k] for k in params}
        params = {k: w - self.sam_lr * buf[k] for k, w in params.items()}
        return params, buf, g2

    def neighbor_noise(self, gen, x, state, idx):
        """Neighbour ``idx``'s draw, uniform in the zeta-ball."""
        u = self.draw_rows(gen, torch.rand, x.shape, device=x.device)
        return u * (2 * self.zeta) - self.zeta

    def _grads_at(self, params, points, y):
        """Each point's own input gradient, (k, B, H, W, C) as one batch."""
        pts = points.detach().requires_grad_(True)
        k = pts.shape[0]
        logits = self.model.apply(pts.reshape((-1,) + pts.shape[2:]), params=params)
        self.grad_evals += k
        logits = logits.float().reshape((k, -1) + logits.shape[1:])
        loss = sum(self.get_loss(part, y) for part in logits.chunk(k))
        return torch.autograd.grad(loss, pts)[0]

    def get_grad(self, x, y, state: AttackState, gen):
        """The neighbours' mixed gradient through the weights after this
        iteration's SAM update, which goes into the state."""
        params, buf, residue = self._sam_update(
            state.extra["params"], state.extra["sgd_buf"], state.extra["grad_residue"],
            x, state.delta, y)
        total = torch.zeros_like(x)
        chunk = min(self.sample_chunk, self.num_neighbor)
        for start in range(0, self.num_neighbor, chunk):
            idx = range(start, min(start + chunk, self.num_neighbor))
            noise = torch.stack([self.neighbor_noise(gen, x, state, i) for i in idx])
            x_near = x + state.delta + noise
            g1 = self._grads_at(params, x_near, y)
            g1n = g1 / (g1.abs().mean(dim=IMAGE_DIMS, keepdim=True) + 1e-12)
            g2 = self._grads_at(params, x_near - self.alpha * g1n, y)
            total = total + ((1 - self.gamma) * g1 + self.gamma * g2).sum(0)
        return total / self.num_neighbor, {"params": params, "sgd_buf": buf,
                                           "grad_residue": residue}


class FAUG(MIFGSM):
    """Feature augmentation: additive N(0, (0.3·std(f))²) noise at the stem
    conv's output (before its BatchNorm) from step burn_in=1 on;
    alpha=2/255."""

    def __init__(self, model_name="resnet50", noise_type="normal", mean1=0.0,
                 std1=0.3, lower1=-0.2, upper1=0.2, burn_in_steps=1,
                 tap_layer="conv1", **kwargs):
        kwargs.setdefault("attack", "FAUG")
        kwargs.setdefault("alpha", 2 / 255)
        super().__init__(model_name, **kwargs)
        self.noise_type = noise_type
        self.mean1, self.std1 = float(mean1), float(std1)
        self.lower1, self.upper1 = float(lower1), float(upper1)
        self.burn_in = int(burn_in_steps)
        self.tap_layer = tap_layer

    def unit_noise(self, gen, shape, dtype, state):
        """Standard-normal draw, scaled by std1·std(feature) afterwards."""
        return self.draw_rows(gen, torch.randn, shape, device=self.device).to(dtype)

    def get_grad(self, x, y, state: AttackState, gen):
        def tap(feat):
            if self.noise_type == "normal":
                std = self.std1 * self.batch_var(feat.detach().float()).sqrt()
                noise = self.mean1 + std * self.unit_noise(gen, feat.shape, torch.float32,
                                                           state)
            else:
                u = self.draw_rows(gen, torch.rand, feat.shape, device=self.device)
                noise = self.lower1 + u * (self.upper1 - self.lower1)
            return feat + noise.detach()

        # before burn-in the forward is the plain one (JAX adds 0 · noise)
        taps = {self.tap_layer: tap} if state.step >= self.burn_in else None
        delta = state.delta.detach().requires_grad_(True)
        logits = self.model.apply(x + delta, tap_fns=taps).float()
        self.grad_evals += 1
        (grad,) = torch.autograd.grad(self.get_loss(logits[None], y), delta)
        return grad, {}
