"""Attack engine (counterpart of ``transferattack_tpu/attack.py``).

The JAX engine is a pure function whose loop is one jit-compiled
``lax.scan``; here the same hooks run eagerly in a Python loop over
``epoch``.  The state is a dataclass of tensors, the JAX PRNG key chain is a
``torch.Generator`` created in ``__call__`` from ``seed + idx``, and the
surrogate's weights live in its ``nn.Module``, so the hooks take no
``variables`` argument.

Public tensors keep the JAX layout: ``(B, H, W, C)`` float in [0, 1].
Delta, momentum and x stay contiguous NHWC fp32, which is what the update
kernel reads.

A long run can be cut into segments (:meth:`Attack.run_from`) with the loop
state and the generator's state saved between them
(:meth:`Attack.call_resumable`), which gives the delta of one uninterrupted
run.  ``data_split`` and ``copies_group`` are set by
:mod:`transferattack_torch.parallel` when ranks of ``torch.distributed``
share the batch or the augmented copies.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import glob
import os
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from .models import Surrogate, resolve_device, resolve_model, round_variables_to_bf16
from .ops.fused_update import fused_sign_update
from .utils import img_max, img_min

Tensor = torch.Tensor


@dataclasses.dataclass
class AttackState:
    """Loop state; ``extra`` holds per-attack auxiliary tensors."""

    delta: Tensor
    momentum: Tensor
    step: int = 0
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


def l1_normalize(g: Tensor) -> Tensor:
    """Normalize by the mean absolute value over all non-batch axes."""
    denom = g.abs().mean(dim=tuple(range(1, g.ndim)), keepdim=True)
    return g / (denom + 1e-12)


def mean_over_draws(fn, gen: torch.Generator, n: int, chunk: int = 1) -> Tensor:
    """Mean of ``n`` samples of ``fn``, drawn from ``gen`` (JAX's
    ``mean_over_keys``).

    ``fn(gen, k)`` draws ``k`` samples and returns their values stacked on a
    leading axis.  ``chunk > 1`` (when it divides ``n``) asks for that many
    samples a call, so that their gradients run as one larger batch; the
    samples are drawn in the same order either way.
    """
    k = chunk if chunk > 1 and n % chunk == 0 else 1
    total = fn(gen, k).sum(0)
    for _ in range(n // k - 1):
        total = total + fn(gen, k).sum(0)
    return total / n


def draw(gen: torch.Generator, fn, *args, device=None, **kwargs) -> Tensor:
    """``fn(*args, generator=gen)`` (``torch.rand``, ``randn``, ``randint``,
    ``randperm``) drawn on the generator's own device and moved to
    ``device``: one seeded generator gives the same draws to an attack on
    any device (on the attack's own device the move is free)."""
    return fn(*args, generator=gen, device=gen.device, **kwargs).to(device)


def draw_rows(split, gen: torch.Generator, fn, *args, batch_axis: int = 0, copies: int = 1,
              device=None, **kwargs) -> Tensor:
    """:func:`draw` of a draw shaped by the batch: its size (the last
    positional argument, a shape or ``randperm``'s length) holds the batch's
    rows on ``batch_axis``, ``copies`` times over, copy-major.  ``split``
    (an attack's ``data_split``) makes it the one-process draw, over the
    whole batch's rows from the same generator in the same order, of which
    this rank's rows are returned (rule 1 of
    :mod:`transferattack_torch.parallel`); ``None`` is plain :func:`draw`."""
    if split is None:
        return draw(gen, fn, *args, device=device, **kwargs)
    if copies > 1:
        size = list(args[-1])
        size[batch_axis:batch_axis + 1] = [copies, size[batch_axis] // copies]
        return draw_rows(split, gen, fn, *args[:-1], tuple(size), batch_axis=batch_axis + 1,
                         device=device, **kwargs).reshape(args[-1])
    size = split.global_size(args[-1], batch_axis)
    return split.rows(draw(gen, fn, *args[:-1], size, device=device, **kwargs), batch_axis)


def global_l1_normalize(g: Tensor, split=None) -> Tensor:
    """Normalize by the global L1 norm (PC-I-FGSM's ``torch.norm(grad, p=1)``).
    ``split`` (an attack's ``data_split``) sums the norm over the real rows
    of every rank that holds a part of the batch."""
    if split is None:
        return g / (g.abs().sum() + 1e-12)
    return g / (split.sum_real(g.abs(), axis=0) + 1e-12)


def cosine_similarity(a: Tensor, b: Tensor) -> Tensor:
    """Per-example cosine similarity, broadcastable back over image dims."""
    af = a.reshape(a.shape[0], -1)
    bf = b.reshape(b.shape[0], -1)
    cos = (af * bf).sum(dim=1) / (af.norm(dim=1) * bf.norm(dim=1) + 1e-20)
    return cos.reshape((-1,) + (1,) * (a.ndim - 1))


def softmax_cross_entropy(logits: Tensor, labels: Tensor) -> Tensor:
    """Per-example CE. ``logits``: (..., B, C); ``labels``: (B,) int."""
    logp = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)
    return -(logp * onehot).sum(dim=-1)


def member_passes(members: Sequence[Surrogate]) -> Tuple[Surrogate, ...]:
    """An ensemble's members as an attack takes passes through one of them
    alone under a low-precision ``compute_dtype``.  JAX casts the ensemble's
    variables and sets the compute dtype on the ensemble only, so a member
    alone runs fp32 activations on bf16-rounded weights, while the
    mean-logit ensemble runs bf16 on them.  A module holds one dtype, so
    each member gets an fp32 copy of its module with its variables rounded
    to bf16 (:func:`~transferattack_torch.models.round_variables_to_bf16`,
    which also gives BatchNorm the multiplier of jitted Flax)."""
    out = []
    for s in members:
        module = copy.deepcopy(s.module).float()
        round_variables_to_bf16(module)
        out.append(dataclasses.replace(s, module=module, compute_dtype=None))
    return tuple(out)


class Attack:
    """Base class for transfer attacks.

    Defaults follow the reference protocol (eps=16/255, alpha=1.6/255,
    epoch=10, untargeted).  ``compute_dtype='bfloat16'`` runs the surrogate
    in bf16, BN buffers included, while delta, momentum and the loss stay
    fp32 (an ensemble's members alone: :func:`member_passes`); ``None`` is
    full fp32, and ``'float64'`` the surrogate in fp64.  ``device`` defaults
    to ``'cuda'`` and raises when no card is present.
    """

    # the batch size the attack runs at, whatever the CLI's ``--batchsize``
    # (LPM's 1); None takes any
    requires_batchsize: Optional[int] = None
    # this rank's part of a batch split over ranks (``parallel.DataSplit``,
    # set by ``ShardedAttackRunner`` for one call); None: the whole batch
    data_split = None
    # JAX's flag: the key prepares each batch on the host in a ``__call__``
    # of its own, so ``ShardedAttackRunner`` runs it whole on every rank
    # through that entry point
    host_state = False
    # a process group whose ranks each take a contiguous slice of the
    # flattened (copies · batch) axis of ``get_logits`` (JAX's
    # ``copies_sharding``); None: every copy here
    copies_group = None

    def __init__(
        self,
        model_name: Union[str, Sequence[str], Any] = "resnet50",
        epoch: int = 10,
        eps: float = 16 / 255,
        alpha: float = 1.6 / 255,
        decay: float = 1.0,
        targeted: bool = False,
        random_start: bool = False,
        norm: str = "linfty",
        loss: str = "crossentropy",
        seed: int = 0,
        attack: str = "Attack",
        compute_dtype=None,
        device="cuda",
        **model_kwargs,
    ):
        if norm not in ("linfty", "l2"):
            raise ValueError(f"Unsupported norm {norm}")
        self.attack = attack
        self.device = resolve_device(device)
        if isinstance(compute_dtype, str):
            compute_dtype = getattr(torch, compute_dtype)
        self.compute_dtype = compute_dtype
        self.model = resolve_model(model_name, device=self.device, **model_kwargs)
        self.model.module.eval().requires_grad_(False)
        if self.compute_dtype is not None:
            # a surrogate of its own (a built one may be shared); the members
            # alone take fp32 passes under a dtype narrower than fp32 only
            if self.model.members and self.compute_dtype.itemsize < 4:
                self.model = dataclasses.replace(
                    self.model, members=member_passes(self.model.members))
            self.model.module.to(self.compute_dtype)
            self.model.compute_dtype = self.compute_dtype
        self.epoch = int(epoch)
        self.eps = float(eps)
        self.alpha = float(alpha)
        self.decay = float(decay)
        self.targeted = bool(targeted)
        self.random_start = bool(random_start)
        self.norm = norm
        self.loss_name = loss
        self.seed = int(seed)
        # backward passes of B images through one model (an ensemble pass
        # counts one a member), and forward-only member passes where a key
        # makes them beside its gradients (the ensemble keys)
        self.grad_evals = 0
        self.forward_evals = 0

    # ------------------------------------------------------------------
    # what crosses the rows of a batch (``data_split``'s rules 1-3)
    # ------------------------------------------------------------------

    def draw_rows(self, gen: torch.Generator, fn, *args, batch_axis: int = 0,
                  copies: int = 1, device=None, **kwargs) -> Tensor:
        """A draw shaped by the batch (:func:`draw_rows`): this rank's rows
        of the one-process draw."""
        return draw_rows(self.data_split, gen, fn, *args, batch_axis=batch_axis,
                         copies=copies, device=device, **kwargs)

    def draw_copy_rows(self, gen: torch.Generator, fn, shape, device=None) -> Tensor:
        """A draw whose axis 0 holds copies of the batch's rows, copy-major
        (an activation of the flattened copies): :meth:`draw_rows`."""
        copies = 1 if self.data_split is None else shape[0] // self.data_split.n_local
        return self.draw_rows(gen, fn, shape, copies=copies, device=device)

    def whole_batch(self, t: Tensor, grad: bool = False, axis: int = 0) -> Tensor:
        """``t``'s rows (on ``axis``) over the whole batch, where partners
        are taken from it: ``t`` itself, or on a rank the real rows of every
        rank gathered (``DataSplit.whole``; ``grad`` hands each rank its
        rows' gradient from every rank's loss)."""
        return t if self.data_split is None else self.data_split.whole(t, grad, axis)

    def batch_rows(self, n: int) -> int:
        """The whole batch's rows, of which this rank holds ``n``."""
        return n if self.data_split is None else self.data_split.n_global

    def rows_of(self, t: Tensor, axis: int = 0) -> Tensor:
        """This rank's rows (on ``axis``) of ``t``, made over the whole
        batch's :meth:`batch_rows` (``DataSplit.rows``); ``t`` itself
        without a split."""
        return t if self.data_split is None else self.data_split.rows(t, axis)

    def over_batch(self, fn, t: Tensor, axis: int = 0) -> Tensor:
        """``fn(t)`` where ``fn`` couples the rows of ``t`` (on ``axis``),
        as IDAA's op blocks and local mixup do: on a rank, ``fn`` of the
        whole batch's rows, gathered with their gradient, as one process
        computes it, and this rank's rows of the result (rule 2)."""
        if self.data_split is None:
            return fn(t)
        return self.rows_of(fn(self.data_split.whole(t, grad=True, axis=axis)), axis)

    def batch_mean(self, values: Tensor, axis: int = -1) -> Tensor:
        """The mean of ``values`` (``axis``: the batch's rows) over the
        whole batch, where a statistic of the batch enters the loss
        non-linearly: on a rank, summed over every rank's real rows
        (``DataSplit.mean_rows``)."""
        if self.data_split is None:
            return values.mean()
        return self.data_split.mean_rows(values, axis)

    def batch_share(self, values: Tensor, axis: int = -1) -> Tensor:
        """A loss that is a mean over the batch (``values``, ``axis``: the
        batch's rows): on a rank, its share of the whole batch's mean
        (``DataSplit.share``), whose gradient is the one-process one."""
        if self.data_split is None:
            return values.mean()
        return self.data_split.share(values, axis)

    def batch_sum(self, values: Tensor, axis: int = -1) -> Tensor:
        """The sum of ``values`` (``axis``: the batch's rows) over the whole
        batch, where such a sum enters the loss non-linearly (a norm over
        the batch): on a rank, over every rank's real rows
        (``DataSplit.sum_real``)."""
        return values.sum() if self.data_split is None else self.data_split.sum_real(values, axis)

    def batch_var(self, t: Tensor) -> Tensor:
        """The variance of every element of ``t`` (rows on axis 0) over the
        whole batch: on a rank, its moments over every rank's real rows."""
        if self.data_split is None:
            return t.var(unbiased=False)
        mean = self.batch_mean(t, axis=0)
        return self.batch_mean((t - mean) ** 2, axis=0)

    def whole_loss(self, shares: Tensor) -> Tensor:
        """The whole batch's loss values, detached, from this rank's shares
        of them (:meth:`batch_share`, :meth:`get_loss`): summed over the
        ranks (``DataSplit.reduce``), where a key reads a loss's value."""
        if self.data_split is None:
            return shares.detach()
        return self.data_split.reduce(shares.detach())

    def replicated(self, t: Tensor) -> Tensor:
        """A tensor every row of the batch reads (a warp map, a weight
        perturbation): on a rank, its gradient is summed over every rank's
        rows (``copy_to_group``)."""
        if self.data_split is None:
            return t
        from .parallel import copy_to_group

        return copy_to_group(t, self.data_split.group)

    # ------------------------------------------------------------------
    # hooks — override in subclasses
    # ------------------------------------------------------------------

    def init_delta(self, x: Tensor, gen: torch.Generator) -> Tensor:
        """Zero or random-start init."""
        if not self.random_start:
            return torch.zeros_like(x)
        # drawn on the generator's device, so a CPU generator serves the card
        if self.norm == "linfty":
            delta = (self.draw_rows(gen, torch.rand, x.shape, device=x.device)
                     * (2 * self.eps) - self.eps)
        else:
            delta = self.draw_rows(gen, torch.randn, x.shape, device=x.device)
            flat = delta.reshape(x.shape[0], -1)
            n = flat.norm(dim=1, keepdim=True)
            r = self.draw_rows(gen, torch.rand, (x.shape[0], 1), device=x.device)
            delta = (flat / (n + 1e-12) * r * self.eps).reshape(x.shape)
        return torch.clamp(x + delta, img_min, img_max) - x

    def init_extra(self, x: Tensor, y: Tensor) -> Dict[str, Any]:
        """Initial per-attack auxiliary state (empty by default)."""
        return {}

    def num_copies(self) -> int:
        """Number of augmented copies ``transform`` produces."""
        return 1

    def transform(self, x: Tensor, state: AttackState, gen: torch.Generator) -> Tensor:
        """Input augmentation: (B, H, W, C) → (num_copies, B, H, W, C)."""
        return x[None]

    def get_logits(self, xs: Tensor) -> Tensor:
        """``xs``: (n, B, H, W, C) → fp32 logits (n, B, num_classes)."""
        n, b = xs.shape[0], xs.shape[1]
        flat = xs.reshape((n * b,) + xs.shape[2:])
        if self.copies_group is None:
            logits = self.model.apply(flat)
        else:
            from .parallel import split_rows

            logits = split_rows(self.model.apply, flat, self.copies_group)
        logits = logits.float()
        return logits.reshape((n, b) + logits.shape[1:])

    def get_loss(self, logits: Tensor, y: Tensor) -> Tensor:
        """Scalar loss, negated for targeted attacks.  It is a mean over
        the batch: on a rank that holds a part of it, its share of the
        whole batch's mean (:meth:`batch_share`)."""
        ce = self.batch_share(softmax_cross_entropy(logits, y))
        return -ce if self.targeted else ce

    def get_grad(self, x: Tensor, y: Tensor, state: AttackState,
                 gen: torch.Generator):
        """Gradient of the loss w.r.t. delta; returns ``(grad, extra_updates)``."""
        return self.input_grad(x + state.delta, y, state, gen), {}

    def input_grad(self, point: Tensor, y: Tensor, state: AttackState,
                   gen: torch.Generator) -> Tensor:
        """Gradient of the loss w.r.t. an input point.  Delta enters
        additively, so this is also the gradient w.r.t. delta at
        ``point = x + delta``.  The surrogate's parameters are frozen, so
        the backward computes the input gradient only."""
        return self.input_grads(point[None], y, state, gen)[0]

    def input_grads(self, points: Tensor, y: Tensor, state: AttackState,
                    gen: torch.Generator) -> Tensor:
        """:meth:`input_grad` at each of a stack of points ``(k, B, H, W, C)``,
        through the surrogate as one batch.  The loss is the sum of each
        point's own loss (a mean over the stack would scale every gradient by
        ``1/k``); eval-mode BatchNorm couples no images, so each gradient is
        the one ``input_grad`` gives.  ``grad_evals`` counts the batches of B
        images taken through the surrogate's backward, once a member of an
        ensemble."""
        points = points.detach().requires_grad_(True)
        xs = [self.transform(p, state, gen) for p in points]
        logits = self.get_logits(xs[0] if len(xs) == 1 else torch.cat(xs))
        self.grad_evals += logits.shape[0] * max(len(self.model.members), 1)
        loss = sum(self.get_loss(part, y) for part in logits.chunk(len(xs)))
        (grad,) = torch.autograd.grad(loss, points)
        return grad

    def post_grad(self, grad: Tensor, state: AttackState) -> Tensor:
        """Gradient post-processing hook."""
        return grad

    def get_momentum(self, grad: Tensor, momentum: Tensor) -> Tensor:
        """L1-mean-normalized accumulation."""
        return momentum * self.decay + l1_normalize(grad)

    def update_delta(self, delta: Tensor, x: Tensor, grad_dir: Tensor,
                     alpha: Optional[float] = None) -> Tensor:
        """Step + project; ``alpha`` (a scalar) overrides ``self.alpha``."""
        alpha = self.alpha if alpha is None else float(alpha)
        if self.norm == "linfty":
            return fused_sign_update(delta, grad_dir.contiguous(), x, alpha,
                                     self.eps, img_min, img_max)
        # per-sample L2-normalized step, then eps-ball renorm projection
        shape = (-1,) + (1,) * (grad_dir.ndim - 1)
        gn = grad_dir.reshape(grad_dir.shape[0], -1).norm(dim=1).reshape(shape)
        d = delta + alpha * grad_dir / (gn + 1e-20)
        n = d.reshape(d.shape[0], -1).norm(dim=1).reshape(shape)
        delta = d * torch.clamp(self.eps / (n + 1e-12), max=1.0)
        return torch.clamp(x + delta, img_min, img_max) - x

    def step(self, x: Tensor, y: Tensor, state: AttackState, gen: torch.Generator,
             alpha: Optional[float] = None) -> AttackState:
        """One attack iteration; ``alpha`` overrides the step size."""
        grad, extra_up = self.get_grad(x, y, state, gen)
        grad = self.post_grad(grad, state)
        momentum = self.get_momentum(grad, state.momentum)
        delta = self.update_delta(state.delta, x, momentum, alpha)
        return AttackState(delta=delta, momentum=momentum, step=state.step + 1,
                           extra={**state.extra, **extra_up})

    # ------------------------------------------------------------------
    # driver
    # ------------------------------------------------------------------

    def init_state(self, x: Tensor, y: Tensor, gen: torch.Generator) -> AttackState:
        return AttackState(delta=self.init_delta(x, gen),
                           momentum=torch.zeros_like(x),
                           extra=self.init_extra(x, y))

    def run(self, x: Tensor, y: Tensor, gen: torch.Generator) -> Tensor:
        """The full attack: ``epoch`` steps, then the final projection."""
        state = self.run_from(x, y, self.init_state(x, y, gen), gen, self.epoch)
        return self.finalize(state, x, y)

    def run_from(self, x: Tensor, y: Tensor, state: AttackState, gen: torch.Generator,
                 n_steps: int) -> AttackState:
        """``n_steps`` iterations from any state.  Runs in segments give the
        state of one long run, given the generator in the state it had."""
        for _ in range(n_steps):
            state = self.step(x, y, state, gen)
        return state

    def finalize(self, state: AttackState, x: Tensor, y: Tensor) -> Tensor:
        """Final projection; returns delta."""
        return torch.clamp(x + state.delta, img_min, img_max) - x

    def supports_resume(self) -> bool:
        """Whether :meth:`call_resumable` can cut the run into segments: the
        stock loop (a key with a ``run`` of its own manages its own
        trajectory) and no per-batch host preparation (a ``__call__`` of its
        own), JAX's rule."""
        return type(self).run is Attack.run and type(self).__call__ is Attack.__call__

    def call_resumable(self, data, label, ckpt_dir: str, every: int,
                       generator: Optional[torch.Generator] = None, idx: int = 0) -> Tensor:
        """:meth:`__call__` in segments of ``every`` iterations, the loop state
        and the generator's state saved to ``ckpt_dir/batch_{idx:05d}``
        between them.  A call that finds that file resumes from it; the last
        segment deletes it (and ``ckpt_dir`` once empty).  The delta is the
        uninterrupted call's.  A key that cannot resume, or an ``every``
        outside ``(0, epoch)``, runs as :meth:`__call__`."""
        if not self.supports_resume() or not 0 < every < self.epoch:
            return self(data, label, generator=generator, idx=idx)
        x = torch.as_tensor(data, dtype=torch.float32, device=self.device).contiguous()
        y = self.prepare_labels(label)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(self.seed + idx)
        path = os.path.join(os.path.abspath(ckpt_dir), f"batch_{idx:05d}")
        state = self.init_state(x, y, generator)
        if os.path.exists(path):
            state = load_state(path, generator, self.device)
        while state.step < self.epoch:
            state = self.run_from(x, y, state, generator, min(every, self.epoch - state.step))
            if state.step < self.epoch:
                save_state(path, state, generator)
        for done in [path, *glob.glob(f"{path}.tmp*")]:  # and a save cut by a kill
            with contextlib.suppress(FileNotFoundError):
                os.remove(done)
        with contextlib.suppress(OSError):  # not empty: other batches' files
            os.rmdir(os.path.dirname(path))
        return self.finalize(state, x, y)

    def __call__(self, data, label, generator: Optional[torch.Generator] = None,
                 idx: int = 0) -> Tensor:
        """``data``: (B, H, W, C) float in [0, 1] (array or tensor).  Returns
        delta as a tensor on the attack's device."""
        x = torch.as_tensor(data, dtype=torch.float32, device=self.device).contiguous()
        y = self.prepare_labels(label)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(self.seed + idx)
        return self.run(x, y, generator)

    def prepare_labels(self, label) -> Tensor:
        """Targeted batches carry (ground-truth, target) pairs; attack the
        target column."""
        y = torch.as_tensor(label, device=self.device).long()
        if self.targeted and y.ndim == 2:
            y = y[:, 1]
        return y


def save_state(path: str, state: AttackState, gen: torch.Generator) -> None:
    """``torch.save`` of the loop state and the generator's state, written
    under a temporary name and moved onto ``path``, so that a process killed
    while saving leaves the last whole checkpoint."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save({"delta": state.delta, "momentum": state.momentum, "step": state.step,
                "extra": state.extra, "generator": gen.get_state()}, tmp)
    os.replace(tmp, path)


def load_state(path: str, gen: torch.Generator, device) -> AttackState:
    """The state :func:`save_state` wrote, on ``device``; sets ``gen`` to the
    state it had then."""
    ck = torch.load(path, map_location=device, weights_only=True)
    gen.set_state(ck["generator"].cpu())
    return AttackState(delta=ck["delta"], momentum=ck["momentum"], step=int(ck["step"]),
                       extra=ck["extra"])
