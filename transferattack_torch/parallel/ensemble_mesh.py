"""Ensemble members on ranks of their own (counterpart of
``transferattack_tpu/parallel/ensemble_mesh.py``).

JAX places K members over a ``model`` mesh axis: each model shard computes
its own members' logits, and the member mean is a ``psum``.  Here the ranks
of a ``torch.distributed`` group take that axis:

- :class:`ShardedEnsemble` (JAX's ``ShardMapEnsemble``): K heterogeneous
  members, the rank at model index s holding and running members
  ``s·K/S … (s+1)·K/S − 1``.  ``mode='mean'`` all-reduces the member sum;
  ``mode='ind'`` all-gathers the members' logits to (K, B, C).
- :class:`StackedEnsemble`: K homogeneous members as one stack of
  parameters (``torch.func.stack_module_state``), the forward
  ``torch.func.vmap`` over ``functional_call``; on a model group each rank
  holds its K/S slice of the stack.

``torch.distributed.all_reduce`` is not seen by autograd, and the
autograd-aware all-reduce of ``torch.distributed.nn`` all-reduces in its
backward too: the gradient reaching it is the same on every model rank, so
it would come out S times too large, while each rank's input gradient would
still hold only its own members' share.  So the forward is the pair of
tensor parallelism: :func:`copy_to_group` on the input (identity forward,
all-reduce backward) and :func:`reduce_from_group` on the member sum
(all-reduce forward, identity backward).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

__all__ = [
    "DataModelGroups",
    "ShardedEnsemble",
    "StackedEnsemble",
    "data_model_groups",
    "mesh_ensemble_surrogate",
    "stack_param_sets",
]


@dataclasses.dataclass(frozen=True)
class DataModelGroups:
    """This rank's groups on a (data, model) grid of the world's ranks."""

    data: object
    model: object


def data_model_groups(n_model: int) -> DataModelGroups:
    """The counterpart of JAX's ``data_model_mesh``: the ranks as a grid of
    ``world // n_model`` rows (the data axis) by ``n_model`` columns (the
    model axis), rank ``r`` at row ``r // n_model``; a group for each column
    and each row.  Every rank must call it (``dist.new_group`` is
    collective)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % n_model != 0:
        raise ValueError(f"{world} ranks not divisible by model axis {n_model}")
    grid = np.arange(world).reshape(world // n_model, n_model)
    mine = {}
    for axis, lines in (("data", grid.T), ("model", grid)):
        for line in lines:
            group = dist.new_group(line.tolist())
            if rank in line:
                mine[axis] = group
    return DataModelGroups(**mine)


def _my_slice(k: int, group) -> slice:
    s, n = dist.get_rank(group), dist.get_world_size(group)
    if k % n != 0:
        raise ValueError(f"K={k} members must divide over model axis size {n}")
    per = k // n
    return slice(s * per, (s + 1) * per)


def _combine(local: torch.Tensor, k: int, mode: str, group) -> torch.Tensor:
    """(k_local, B, C) logits of this rank's members → the ensemble's."""
    from . import gather_from_group, reduce_from_group

    if group is None:
        return local.mean(0) if mode == "mean" else local
    if mode == "ind":
        return gather_from_group(local, group)
    return reduce_from_group(local.sum(0), group) / k


class ShardedEnsemble(nn.Module):
    """K heterogeneous members over the ranks of ``group``, each rank
    holding and running its K/S of them; a drop-in for
    :class:`~transferattack_torch.models.EnsembleModule`."""

    def __init__(self, members: Sequence[nn.Module], group, mode: str = "mean"):
        super().__init__()
        if mode not in ("mean", "ind"):
            raise NotImplementedError(mode)
        self.K, self.group, self.mode = len(members), group, mode
        self.members = nn.ModuleList(list(members)[_my_slice(self.K, group)])

    def forward(self, x, **backbone_kwargs):
        from . import copy_to_group

        x = copy_to_group(x, self.group)
        local = torch.stack([m(x, **backbone_kwargs) for m in self.members])
        return _combine(local, self.K, self.mode, self.group)


def stack_param_sets(modules: Sequence[nn.Module]) -> Dict[str, torch.Tensor]:
    """The parameters and buffers of K modules of one architecture, each
    stacked on a new leading axis (``torch.func.stack_module_state``)."""
    params, buffers = torch.func.stack_module_state(list(modules))
    return {k: v.detach() for k, v in {**params, **buffers}.items()}


class StackedEnsemble(nn.Module):
    """K homogeneous members: ``base``'s architecture run on each set of a
    :func:`stack_param_sets` stack, as one ``vmap`` over
    ``functional_call``.  With a ``group``, each rank keeps and runs its K/S
    slice of the stack and the members combine over the group."""

    def __init__(self, base: nn.Module, stacked: Dict[str, torch.Tensor], mode: str = "mean",
                 group=None):
        super().__init__()
        if mode not in ("mean", "ind"):
            raise NotImplementedError(mode)
        self.K = next(iter(stacked.values())).shape[0]
        self.mode, self.group = mode, group
        rows = slice(None) if group is None else _my_slice(self.K, group)
        # a template for functional_call; its own tensors are never read
        self.base = copy.deepcopy(base).to("meta")
        self.names = list(stacked)
        for i, name in enumerate(self.names):  # buffers follow .to() and dtype casts
            self.register_buffer(f"stack_{i}", stacked[name][rows].contiguous())

    def forward(self, x, **backbone_kwargs):
        from . import copy_to_group

        if self.group is not None:
            x = copy_to_group(x, self.group)
        sets = {n: getattr(self, f"stack_{i}") for i, n in enumerate(self.names)}

        def one(tensors):
            return torch.func.functional_call(self.base, tensors, (x,), backbone_kwargs)

        return _combine(torch.func.vmap(one)(sets), self.K, self.mode, self.group)


def mesh_ensemble_surrogate(ensemble, groups):
    """An ensemble surrogate (``make_ensemble``) whose forward runs through a
    :class:`ShardedEnsemble` over ``groups.model`` (``groups`` a
    :class:`DataModelGroups`); the same member modules, mode, ``members``
    and compute dtype."""
    module = ShardedEnsemble(list(ensemble.module.members), groups.model,
                             mode=ensemble.module.mode)
    return dataclasses.replace(ensemble, name=ensemble.name + "@mesh", module=module)
