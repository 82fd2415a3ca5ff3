"""N ranks of ``torch.distributed`` on the CPU over gloo, and the checks
they run: the multi-rank tests and :func:`~transferattack_torch.graft_entry.dryrun_multichip`
hold each sharded path against one process with them.

The workers live here, inside the port, so that a spawned child imports
neither a test module nor JAX; they are started with ``spawn`` (never
``fork``: the parent may have threads), one thread each, and meet through
a ``file://`` rendezvous in a temporary directory, so that runs side by
side do not contend for a TCP port.

    from transferattack_torch.parallel import ranks
    deltas = ranks.spawn(ranks.run_cases, 2, ({"main": {"check": "runner",
                         "key": "mifgsm", "x": x, "y": y}},))
"""
from __future__ import annotations

import contextlib
import copy
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

JOIN_TIMEOUT = 60.0  # seconds a rank may take to exit once its result is in


@contextlib.contextmanager
def _env(**values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _rank_main(target, rank: int, world: int, init_file: str, args, results) -> None:
    torch.set_num_threads(1)
    try:
        from . import DIST_TIMEOUT

        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=world, timeout=DIST_TIMEOUT)
        try:
            out = target(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def spawn(target: Callable, world: int, args: Sequence = (), timeout: float = 60.0,
          workdir: Optional[str] = None) -> List[object]:
    """``target(*args)`` on each of ``world`` CPU ranks over gloo; returns
    each rank's result, rank 0 first.  A rank that raises, or a run that
    takes over ``timeout`` seconds, raises ``RuntimeError`` here and ends
    every rank."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(target, r, world, init_file, tuple(args), results))
                 for r in range(world)]
        with _env(OMP_NUM_THREADS="1"):
            for p in procs:
                p.start()
        out: Dict[int, object] = {}
        deadline = time.monotonic() + timeout
        try:
            while len(out) < world:  # drain the queue before joining
                try:
                    rank, ok, value = results.get(timeout=max(deadline - time.monotonic(), 0.1))
                except queue_mod.Empty:
                    raise RuntimeError(f"{world} ranks did not finish in {timeout} s") from None
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
                out[rank] = value
        finally:
            for p in procs:
                p.join(timeout=JOIN_TIMEOUT if len(out) == world else 1.0)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=JOIN_TIMEOUT)
        return [out[r] for r in range(world)]


# ----------------------------------------------------------------------
# the checks each rank runs
# ----------------------------------------------------------------------


# narrow models at 32² for the keys that need a Bottleneck ResNet or a ViT:
# name -> (module path, class name, keywords)
NARROW_MODELS = {
    "ranks_bottleneck": ("..models.resnet", "ResNet",
                         {"stage_sizes": (2, 1, 1, 1), "block_cls": "Bottleneck",
                          "num_classes": 10}),
    "ranks_vit": ("..models.vit", "VisionTransformer",
                  {"patch_size": 16, "dim": 64, "depth": 4, "num_heads": 2,
                   "num_classes": 10}),
}


def _narrow_factory(path: str, cls: str, kwargs: dict):
    import importlib

    mod = importlib.import_module(path, __package__)
    kw = {k: getattr(mod, v) if k == "block_cls" else v for k, v in kwargs.items()}
    return lambda **extra: getattr(mod, cls)(**kw, **extra)


@contextlib.contextmanager
def narrow_models():
    """:data:`NARROW_MODELS` in the port's model registry (at 32², sized
    where the class takes ``img_size``) inside the block."""
    from ..models import _MODEL_REGISTRY, IMAGENET_MEAN, IMAGENET_STD

    added = [n for n in NARROW_MODELS if n not in _MODEL_REGISTRY]
    for name in added:
        path, cls, kw = NARROW_MODELS[name]
        _MODEL_REGISTRY[name] = (_narrow_factory(path, cls, kw), 32, IMAGENET_MEAN,
                                 IMAGENET_STD, cls == "VisionTransformer")
    try:
        yield
    finally:
        for name in added:
            _MODEL_REGISTRY.pop(name, None)


def build_attack(key: str, model="toy_cnn", flat=None, input_size: Optional[int] = None,
                 **kwargs):
    """A registry attack on the CPU; ``flat`` (JAX's flat variables) loaded
    into its model through the weights bridge.  ``model`` may name one of
    :data:`NARROW_MODELS`."""
    narrow = isinstance(model, str) and model in NARROW_MODELS
    with narrow_models() if narrow else contextlib.nullcontext():
        return _build_attack(key, model, flat, input_size, **kwargs)


def _build_attack(key: str, model, flat, input_size: Optional[int], **kwargs):
    from .. import load_attack_class
    from ..models import make_model

    if flat is not None:
        from ..utils.bridge import load_flat_variables

        sur = make_model(model, pretrained=False, input_size=input_size, device="cpu")
        load_flat_variables(sur.module, flat)
        model = sur
    elif input_size is not None:
        kwargs["input_size"] = input_size
    return load_attack_class(key)(model_name=model, device="cpu", **kwargs)


def jittered_members(name: str, k: int, seed: int = 3, scale: float = 0.02):
    """``k`` copies of the registered model ``name`` on the CPU, each
    parameter moved by seeded gaussian noise of ``scale`` (LGV's case:
    homogeneous members)."""
    from ..models import make_model

    base = make_model(name, pretrained=False, device="cpu").module
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(k):
        m = copy.deepcopy(base)
        with torch.no_grad():
            for p in m.parameters():
                p.add_(scale * torch.randn(p.shape, generator=gen))
        out.append(m)
    return out


def check_runner(case) -> np.ndarray:
    """The runner's delta for ``case['key']`` over the world: members on a
    model axis of ``model_axis`` ranks, or the copies on an axis of
    ``copies_axis``, the batch on the rest."""
    from . import ShardedAttackRunner, data_model_groups, mesh_ensemble_surrogate

    atk = build_attack(case["key"], **case.get("build", {}))
    group = None
    if case.get("model_axis"):
        groups = data_model_groups(case["model_axis"])
        atk.model = mesh_ensemble_surrogate(atk.model, groups)
        group = groups.data
    elif case.get("copies_axis"):
        groups = data_model_groups(case["copies_axis"])
        atk.copies_group = groups.model
        group = groups.data
    return ShardedAttackRunner(atk, group)(case["x"], case["y"], idx=case.get("idx", 0)).numpy()


def check_input_grad(case):
    """Rule (a): this rank's input gradient at the clean point, its rows
    of the batch split as the runner splits it.  Returns (first row,
    gradient of the real rows)."""
    from . import DataSplit, pad_to_multiple

    atk = build_attack(case["key"], **case.get("build", {}))
    x = torch.as_tensor(case["x"])
    y = atk.prepare_labels(case["y"])
    xp, n = pad_to_multiple(x, dist.get_world_size())
    yp, _ = pad_to_multiple(y, dist.get_world_size())
    split = atk.data_split = DataSplit.of(n)
    rows = slice(split.start, split.start + split.n_local)
    gen = torch.Generator().manual_seed(0)
    state = atk.init_state(xp[rows], yp[rows], gen)
    g = atk.input_grad(xp[rows], yp[rows], state, gen)
    return split.start, g[:split.n_real].numpy()


def check_draw_rows(case):
    """Rule 1 at ``n`` rows over the world: this rank's rows of a U(0, 1)
    draw of ``shape`` (its batch on ``axis``), of a permutation, and the
    draw after them, each from one seeded generator.  Returns (rows,
    permutation rows, next draw, real rows)."""
    from ..attack import draw, draw_rows
    from . import DataSplit

    split = DataSplit.of(case["n"])
    shape = list(case["shape"])
    shape[case["axis"]] = split.n_local
    gen = torch.Generator().manual_seed(case.get("seed", 0))
    rows = draw_rows(split, gen, torch.rand, tuple(shape), batch_axis=case["axis"])
    perm = draw_rows(split, gen, torch.randperm, split.n_local)
    after = draw(gen, torch.rand, (4,))
    return rows.numpy(), perm.numpy(), after.numpy(), split.n_real


def check_partners(case):
    """Rule 2 with a gradient: ``Σ_i w_i ⟨x_i, x_perm(i)⟩`` over this rank's
    rows of the one-process permutation, the partners gathered with
    ``DataSplit.whole(grad=True)``; returns the gradient of this rank's real
    rows and the loss summed over the ranks."""
    from ..attack import draw_rows
    from . import DataSplit, pad_to_multiple

    x, n = pad_to_multiple(torch.as_tensor(case["x"]), dist.get_world_size())
    split = DataSplit.of(n)
    xl = x[split.start:split.start + split.n_local].clone().requires_grad_(True)
    perm = draw_rows(split, torch.Generator().manual_seed(case.get("seed", 0)),
                     torch.randperm, split.n_local)
    w = split.rows(torch.arange(1.0, n + 1, dtype=x.dtype))
    rows = (w[:, None] * xl * split.whole(xl, grad=True)[perm]).sum(1)
    loss = split.sum_real(rows)
    (g,) = torch.autograd.grad(loss, xl)
    return g[:split.n_real].numpy(), loss.item()


def ensemble_outputs(surrogate, x, y):
    """An ensemble's logits at ``x``, and the input gradient of its
    cross-entropy (of the mean logits, or summed over the members of
    ``mode='ind'``)."""
    from ..attack import softmax_cross_entropy

    x = torch.as_tensor(x).requires_grad_(True)
    logits = surrogate.apply(x)
    loss = softmax_cross_entropy(logits, torch.as_tensor(y)).sum()
    (grad,) = torch.autograd.grad(loss, x)
    return logits.detach().numpy(), grad.numpy()


def check_ensemble(case):
    """:func:`ensemble_outputs` of a :class:`ShardedEnsemble` of
    ``case['names']`` over a model axis of ``model_axis`` ranks, in
    ``mode``."""
    from ..models import make_ensemble
    from . import data_model_groups, mesh_ensemble_surrogate

    ens = make_ensemble(case["names"], mode=case["mode"], pretrained=False, device="cpu")
    sharded = mesh_ensemble_surrogate(ens, data_model_groups(case["model_axis"]))
    return ensemble_outputs(sharded, case["x"], case["y"])


def stacked_surrogate(name: str, k: int, group=None):
    """A surrogate whose module is a :class:`StackedEnsemble` of
    :func:`jittered_members`, its stack split over ``group``."""
    from ..models import make_model
    from . import StackedEnsemble, stack_param_sets

    members = jittered_members(name, k)
    sur = make_model(name, pretrained=False, device="cpu")
    sur.module = StackedEnsemble(members[0], stack_param_sets(members), group=group)
    sur.name = f"{name}x{k}"
    return sur


def check_stacked(case):
    """A :class:`StackedEnsemble` over a model axis of ``model_axis`` ranks:
    :func:`ensemble_outputs`, and the delta of ``key`` through the runner
    on it."""
    from . import ShardedAttackRunner, data_model_groups

    groups = data_model_groups(case["model_axis"])
    sur = stacked_surrogate(case["name"], case["k"], groups.model)
    out = ensemble_outputs(sur, case["x"], case["y"])
    atk = build_attack(case["key"], model=sur, **case.get("build", {}))
    return out + (ShardedAttackRunner(atk, groups.data)(case["x"], case["y"]).numpy(),)


CHECKS = {"runner": check_runner, "input_grad": check_input_grad,
          "ensemble": check_ensemble, "stacked": check_stacked,
          "draw_rows": check_draw_rows, "partners": check_partners}


def run_cases(cases: Dict[str, dict]) -> Dict[str, object]:
    """Each case's check on this rank, by name (the checks are collective:
    every rank runs the same cases in the same order)."""
    return {name: CHECKS[case["check"]](case) for name, case in cases.items()}
