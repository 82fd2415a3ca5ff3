"""Data-parallel attacks over ``torch.distributed`` (counterpart of
``transferattack_tpu/parallel/__init__.py``).

JAX runs one controller over a device mesh: the sharded attack is the same
global program, so its delta is the one-device delta.  Here there is one
process a card (``torchrun``), or N CPU processes over gloo for the tests
and the dry run, and each rank runs the attack eagerly on its own rows of
the batch.  A rank sees only those rows, so three things of the global
program are restored by hand:

(a) the loss is a mean over the batch: each rank scales its loss by
    ``n_local / n_global`` (``DataSplit.loss_scale``, read by
    ``Attack.get_loss``), so that its input gradient is the one-process one;
(b) a reduction over the whole batch (``global_l1_normalize``: DTA,
    PC-I-FGSM) sums over the real rows of every rank (``DataSplit.sum_rows``);
(c) a key whose draws are shaped by the batch, or that takes partners from
    it (Admix's ``randperm(B)``, per-image draws from one generator), cannot
    give a rank the draws its rows see in one process, so it runs whole on
    every rank through its own entry point, as JAX's host-state keys do.

Which keys shard is :data:`SHARDED_KEYS`; every other key goes whole.  Each
key there is held against one process by ``tests/test_torch_port_parallel.py``.

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
import functools
import os
from typing import Callable, Optional, Tuple

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

# the registry keys whose delta, split over ranks by ShardedAttackRunner, is
# the one-process delta (rules (a) and (b) of the module docstring): each
# draws nothing shaped by the batch and couples no images.  Every other key
# runs whole on each rank: the neighbourhood samplers (VMI, GRA, PGN, ...)
# and Admix, DeCowA, SSM, ... draw per image (rule (c)); POTRIP clamps a
# batch mean, PAM reads image 0's label; the rest were not held against one
# process (the feature, surgery, ViT and ensemble keys)
SHARDED_KEYS = frozenset({
    "fgsm", "ifgsm", "mifgsm", "nifgsm", "emifgsm", "pifgsm", "aifgtm", "ifgssm",
    "adamsi_fgm", "gnp", "mig", "dta", "iefgsm", "pcifgsm", "gifgsm", "anda",
    "dim", "dem", "tim", "sim", "bsr", "ops", "atta", "fap",
    "logit", "logit_margin", "fuzziness_tuned", "ir", "p2fa", "taig",
    "dra", "dsm", "mta", "ma", "qaa", "lgv", "mba", "sasd_ws",
})

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
    (padding included), of which the first ``n_real`` are rows of the
    batch, which has ``n_global`` rows over the group."""

    group: object
    n_local: int
    n_real: int
    n_global: int

    @property
    def loss_scale(self) -> float:
        """What turns this rank's batch mean into its share of the whole
        batch's mean (rule (a))."""
        return self.n_local / self.n_global

    def sum_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the real rows of every rank (rule (b))."""
        total = t[:self.n_real].sum()
        dist.all_reduce(total, group=self.group)
        return total


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


@functools.lru_cache(maxsize=1)
def _sharded_classes() -> Tuple[type, ...]:
    from .. import load_attack_class

    return tuple({load_attack_class(k) for k in SHARDED_KEYS})


def shards(attack) -> bool:
    """Whether :class:`ShardedAttackRunner` splits ``attack``'s batch over
    ranks: its class is one of :data:`SHARDED_KEYS`' (not a subclass)."""
    return type(attack) in _sharded_classes()


class ShardedAttackRunner:
    """Run an attack data-parallel over the ranks of ``group`` (the default
    group).

    The batch is padded to a multiple of the group's size and each rank
    runs ``attack.run`` on its contiguous rows (contiguous NHWC, as the
    update kernel reads them), under the global-batch semantics of
    :class:`DataSplit`; the deltas are all-gathered and the padding sliced
    off, so every rank returns the whole batch's delta.  Keys that do not
    shard (:func:`shards`), and every key without a process group, run
    whole through the attack's own entry point.  At a world of 1 the delta
    is the attack's own, bit for bit.
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
        world, rank = dist.get_world_size(self.group), dist.get_rank(self.group)
        xp, n = pad_to_multiple(x, world)
        yp, _ = pad_to_multiple(y, world)
        per = xp.shape[0] // world
        rows = slice(rank * per, (rank + 1) * per)
        atk.data_split = DataSplit(self.group, per, min(max(n - rank * per, 0), per), n)
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
