"""Data-parallel attacks over ``torch.distributed`` (counterpart of
``transferattack_tpu/parallel/__init__.py``).

JAX runs one controller over a device mesh: the sharded attack is the same
global program, so its delta is the one-device delta.  Here there is one
process a card (``torchrun``), or N CPU processes over gloo for the tests
and the dry run, and each rank runs the attack eagerly on its own rows of
the batch.  A rank sees only those rows, so what of the global program
crosses rows is restored by hand, through :class:`DataSplit` and the seams
of :class:`~transferattack_torch.attack.Attack` that read it:

(a) the loss is a mean over the batch: each rank's loss is its real rows'
    sum over ``n_global`` (``DataSplit.share``, read by ``Attack.get_loss``
    through ``Attack.batch_share``), so that its input gradient is the
    one-process one, and the padding's is 0; a tensor every row reads
    (DeCowA's warp map, AWT's weight step) sums its gradient over the ranks
    (``Attack.replicated``: ``copy_to_group``);
(b) a reduction over the whole batch (``global_l1_normalize``: DTA,
    PC-I-FGSM, CWA) sums over the real rows of every rank
    (``DataSplit.sum_real``);
1.  a draw shaped by the batch is drawn at the one-process shape, from the
    same generator in the same order on every rank, and this rank's rows
    taken (``Attack.draw_rows``, ``DataSplit.rows``): never at the padded
    shape, whose draw would shift every later draw of the call;
2.  partners taken from the batch (Admix's ``randperm(B)``) index the whole
    batch's real rows, all-gathered (``Attack.whole_batch``,
    ``DataSplit.whole``), detached or with a backward that sums every
    rank's share and hands each rank its own rows;
3.  a statistic over the batch (POTRIP's clamped triplet mean, TRAP's norms
    over the batch, L2T's REINFORCE losses) is summed over every rank's real
    rows (``Attack.batch_mean``, ``batch_sum``, ``whole_loss``;
    ``DataSplit.mean_rows``, ``sum_real``, ``reduce``).

So every key splits but those with host-side preparation in a ``__call__``
of their own (``Attack.host_state``, JAX's flag), which run whole on every
rank through that entry point.  Each split key is held against one process
by ``tests/test_torch_port_parallel.py`` and ``test_torch_port_parallel2.py``.

The augmented copies of an attack can be split over a group too
(``Attack.copies_group``, JAX's ``copies_sharding``), and ensemble members
placed on ranks of their own (:mod:`.ensemble_mesh`).  The collectives that
autograd goes through are the pair of tensor parallelism
(:func:`copy_to_group`, :func:`reduce_from_group`) and
:func:`gather_from_group`.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from .ensemble_mesh import (  # noqa: F401
    DataModelGroups,
    ShardedEnsemble,
    StackedEnsemble,
    data_model_groups,
    mesh_ensemble_surrogate,
    stack_param_sets,
)

DIST_TIMEOUT = datetime.timedelta(seconds=60)


def init_from_env(device="cuda") -> torch.device:
    """Join the process group that ``torchrun`` (or a caller) describes in
    the environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``): NCCL for CUDA, gloo for the CPU.  A CUDA rank takes
    ``cuda:{LOCAL_RANK}``.  Without ``WORLD_SIZE`` no group is made; a world
    of 1 is valid.  Returns the rank's device."""
    dev = torch.device(device)
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return dev
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", dev.index or 0)))
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", timeout=DIST_TIMEOUT, device_id=dev)
    else:
        dist.init_process_group("gloo", timeout=DIST_TIMEOUT)
    return dev


def world_size(group=None) -> int:
    """The ranks of ``group`` (the default group), 1 without a process group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank_of(group=None) -> int:
    """This process's rank in ``group``, 0 without a process group."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def pad_to_multiple(x, multiple: int):
    """Pad axis 0 to a multiple of ``multiple`` by repeating the last row
    (an array or a tensor); returns ``(padded, n)``, ``n`` the rows before."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x[-1:].expand((rem,) + tuple(x.shape[1:]))]), n
    return np.concatenate([x, np.repeat(x[-1:], rem, axis=0)], axis=0), n


@dataclasses.dataclass(frozen=True)
class DataSplit:
    """A rank's part of a batch split over ``group``: ``n_local`` rows
    (padding included) from row ``start`` of the padded batch, of which the
    first ``n_real`` are rows of the batch, which has ``n_global`` rows over
    the group."""

    group: object
    n_local: int
    n_real: int
    n_global: int
    start: int = 0

    @classmethod
    def of(cls, n: int, group=None) -> "DataSplit":
        """This rank's part of a batch of ``n`` rows padded to a multiple of
        the group's size (:func:`pad_to_multiple`), in contiguous rows."""
        world, rank = world_size(group), rank_of(group)
        per = -(-n // world)
        return cls(group, per, min(max(n - rank * per, 0), per), n, rank * per)

    def share(self, values: torch.Tensor, axis: int = -1) -> torch.Tensor:
        """This rank's share of the whole batch's mean of ``values``, whose
        ``axis`` holds this rank's rows (rule (a)): the mean over its real
        rows scaled by ``n_real / n_global``, so that its gradient is the
        one-process one on the real rows and 0 on the padding, which then
        reaches nothing that every row shares.  Without padding it is the
        rows' mean times ``n_local / n_global``: at a world of 1, the mean."""
        real = values.narrow(axis, 0, self.n_real)
        if self.n_real == 0:  # padding only: 0, and no gradient
            return real.sum()
        return real.mean() * (self.n_real / self.n_global)

    def global_size(self, size, axis: int = 0):
        """``size`` (a shape, or ``randperm``'s length) with this rank's
        ``n_local`` rows on ``axis`` made the whole batch's ``n_global``
        (rule 1); raises if ``size`` does not hold this rank's rows there."""
        shape = [size] if isinstance(size, int) else list(size)
        if shape[axis] != self.n_local:
            raise ValueError(f"a draw of shape {tuple(shape)} has no batch of "
                             f"{self.n_local} rows on axis {axis}")
        shape[axis] = self.n_global
        return shape[0] if isinstance(size, int) else tuple(shape)

    def rows(self, t: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """This rank's rows on ``axis`` of ``t``, which holds the whole
        batch's ``n_global`` there, padded as :func:`pad_to_multiple` pads
        the batch (rule 1)."""
        t = t.movedim(axis, 0)
        short = self.start + self.n_local - t.shape[0]
        if short > 0:
            t = torch.cat([t, t[-1:].expand((short,) + tuple(t.shape[1:]))])
        return t[self.start:self.start + self.n_local].movedim(0, axis)

    def whole(self, t: torch.Tensor, grad: bool = False, axis: int = 0) -> torch.Tensor:
        """The whole batch's ``n_global`` real rows of ``t`` (rows on
        ``axis``), gathered from every rank (rule 2).  With ``grad``, the
        gradient each rank's loss gives the gathered rows is summed over the
        group and handed back to the rank that holds them; else they are
        detached."""
        t = t.movedim(axis, 0)
        if grad:  # the gather's backward takes this rank's slice of the sum
            full = copy_to_group(gather_from_group(t, self.group), self.group)
        else:
            t = t.detach().contiguous()
            parts = [torch.empty_like(t) for _ in range(world_size(self.group))]
            dist.all_gather(parts, t, group=self.group)
            full = torch.cat(parts)
        return full[:self.n_global].movedim(0, axis)

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group, the same on every rank; the backward
        hands each rank the gradient of the sum (``reduce_from_group``)."""
        return reduce_from_group(t, self.group)

    def sum_real(self, values: torch.Tensor, axis: int = -1) -> torch.Tensor:
        """The sum of ``values`` over every rank's real rows (``axis``): a
        global L1 norm (rule (b)), a norm over the batch (rule 3)."""
        return self.reduce(values.narrow(axis, 0, self.n_real).sum())

    def mean_rows(self, values: torch.Tensor, axis: int = -1) -> torch.Tensor:
        """The whole batch's mean of ``values`` (``axis``: this rank's
        rows), the same on every rank (rule 3): :meth:`share` summed over
        the group."""
        return self.reduce(self.share(values, axis))


# ----------------------------------------------------------------------
# collectives that autograd goes through
# ----------------------------------------------------------------------


class _CopyToGroup(torch.autograd.Function):
    """Identity forward, all-reduce backward: an input every rank of the
    group uses for a part of the output gets the whole gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward: the gradient of the sum
    is the same on every rank, and each rank's part takes it once."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    """All-gather on axis 0 forward; backward, this rank's slice of the
    gradient (the same on every rank, since each computes the same loss
    from the gathered tensor)."""

    @staticmethod
    def forward(ctx, x, group):
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        ctx.rank, ctx.n = rank, x.shape[0]
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _GatherFromGroup.apply(x, group)


def split_rows(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
               group) -> torch.Tensor:
    """``fn(x)`` with each rank of ``group`` computing ``fn`` on a contiguous
    slice of ``x``'s rows (padded to a multiple of the group's size), the
    outputs gathered: every rank gets all of ``fn(x)``, and the gradient
    of ``x`` is whole on every rank.  ``fn`` must act on rows alone."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    padded, n = pad_to_multiple(copy_to_group(x, group), world)
    per = padded.shape[0] // world
    out = fn(padded[rank * per:(rank + 1) * per].contiguous())
    return gather_from_group(out, group)[:n]


# ----------------------------------------------------------------------
# the runner
# ----------------------------------------------------------------------


def shards(attack) -> bool:
    """Whether :class:`ShardedAttackRunner` splits ``attack``'s batch over
    ranks: every key but those that prepare a batch on the host in a
    ``__call__`` of their own (``host_state``, JAX's flag)."""
    return not attack.host_state


class ShardedAttackRunner:
    """Run an attack data-parallel over the ranks of ``group`` (the default
    group).

    The batch is padded to a multiple of the group's size and each rank
    runs ``attack.run`` on its contiguous rows (contiguous NHWC, as the
    update kernel reads them), under the global-batch semantics of
    :class:`DataSplit`; the deltas are all-gathered and the padding sliced
    off, so every rank returns the whole batch's delta.  Keys that do not
    shard (:func:`shards`), and every key without a process group, run
    whole through the attack's own entry point.  A collective that fails
    raises: a split key never falls back to the whole batch.  At a world of
    1 the delta is the attack's own, bit for bit.
    """

    def __init__(self, attack, group=None):
        self.attack = attack
        self.group = group
        self.shard = shards(attack)

    def dispatch(self, x, y, generator: Optional[torch.Generator] = None, idx: int = 0):
        """Queue the attack on the device; returns a handle whose call
        gives the delta (the CLI writes the previous batch meanwhile)."""
        atk = self.attack
        if not (self.shard and dist.is_initialized()):
            delta = atk(x, y, generator=generator, idx=idx)
            return lambda: delta
        x = torch.as_tensor(x, dtype=torch.float32, device=atk.device)
        y = atk.prepare_labels(y)
        if generator is None:
            generator = torch.Generator(device=atk.device).manual_seed(atk.seed + idx)
        world = dist.get_world_size(self.group)
        xp, n = pad_to_multiple(x, world)
        yp, _ = pad_to_multiple(y, world)
        split = DataSplit.of(n, self.group)
        rows = slice(split.start, split.start + split.n_local)
        atk.data_split = split
        try:
            local = atk.run(xp[rows].contiguous(), yp[rows], generator)
        finally:
            atk.data_split = None
        parts = [torch.empty_like(local) for _ in range(world)]
        dist.all_gather(parts, local.contiguous(), group=self.group)
        delta = torch.cat(parts)[:n]
        return lambda: delta

    def __call__(self, x, y, generator: Optional[torch.Generator] = None, idx: int = 0):
        return self.dispatch(x, y, generator=generator, idx=idx)()
