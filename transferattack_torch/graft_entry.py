"""Driver hooks of the port (counterpart of the root ``__graft_entry__.py``):
a forward step on the flagship surrogate, and the multi-rank dry run.

    python -c "from transferattack_torch import graft_entry as g; g.dryrun_multichip(4)"

The dry run is on the CPU by design, as JAX's is (JAX forces a virtual CPU
mesh): N gloo processes stand for N cards, since NCCL takes one rank a card
and a machine with one card cannot hold two.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

EPS = 16 / 255
# the surrogates' precision in the dry run.  In fp32 the CPU's convolution
# takes another algorithm for 8 rows than for 32, and the sign of the step
# turns those last-bit differences into whole steps: SIM's (data, aug) split
# on 4 ranks differs from one process on 1.7e-4 of the elements, over JAX's
# bound, as does one process run in 2-image batches.  In fp64 that rounding
# is 2^29 times smaller, and a fault of the split still shows whole
FP64 = torch.float64


def entry(device=None):
    """``(forward, (x,))``: the port's ResNet-50 forward on seeded random
    weights and a zero (4, 224, 224, 3) batch, on the card unless
    ``device`` asks for another."""
    from .models import make_model, resolve_device

    dev = resolve_device("cuda" if device is None else device)
    surrogate = make_model("resnet50", pretrained=False, device=dev)

    def forward(x):
        return surrogate.module(x)

    return forward, (torch.zeros((4, 224, 224, 3), device=dev),)


def assert_delta_match(got, want, alpha: float, what: str,
                       max_flip_frac: float = 1e-4) -> dict:
    """JAX's bound on a split run against one process: at most
    ``max_flip_frac`` of the elements differ, each by at most a sign flip
    of the step (2·alpha; the split sums in another order, and the sign
    turns a difference at a zero gradient into a whole step).  Returns the
    fraction and the largest difference."""
    diff = np.abs(np.asarray(got) - np.asarray(want))
    bad = diff > 2e-5
    frac, worst = float(bad.mean()), float(diff[bad].max(initial=0.0))
    if frac > max_flip_frac:
        raise AssertionError(f"{what}: {frac:.2e} of elements differ (> {max_flip_frac:.0e})")
    if worst > 2 * alpha + 1e-6:
        raise AssertionError(f"{what}: a difference of {worst} is larger than a sign flip")
    return {"differ": frac, "max_abs_diff": worst}


def _dryrun_rank() -> Optional[dict]:
    """JAX's three checks on this rank; rank 0 holds each against one
    process and returns what it measured."""
    from . import load_attack_class
    from .parallel import ShardedAttackRunner, data_model_groups, mesh_ensemble_surrogate

    n = dist.get_world_size()
    main_rank = dist.get_rank() == 0
    out = {}
    b = 2 * n
    rng = np.random.RandomState(0)
    x = rng.rand(b, 64, 64, 3).astype(np.float32)
    y = rng.randint(0, 1000, size=(b,))

    # the batch on the data axis
    atk = load_attack_class("mifgsm")(model_name="resnet50", epoch=2, pretrained=False,
                                      input_size=64, device="cpu", compute_dtype=FP64)
    delta = ShardedAttackRunner(atk)(x, y).numpy()
    if delta.shape != x.shape or np.abs(delta).max() > EPS + 1e-6:
        raise AssertionError(f"data axis: delta of shape {delta.shape}, |delta|inf "
                             f"{np.abs(delta).max()}")
    if main_rank:
        out["data"] = assert_delta_match(delta, atk(x, y).numpy(), atk.alpha,
                                         "data axis vs one process")

    # (data, aug): SIM's copies split over pairs of ranks
    if n % 2 == 0:
        groups = data_model_groups(2)
        sim = load_attack_class("sim")(model_name=atk.model, epoch=2, num_scale=4,
                                       device="cpu", compute_dtype=FP64)
        sim.copies_group = groups.model
        delta = ShardedAttackRunner(sim, groups.data)(x, y).numpy()
        sim.copies_group = None
        if main_rank:
            out["data_aug"] = assert_delta_match(delta, sim(x, y).numpy(), sim.alpha,
                                                 "(data, aug) vs one process")

    # (data, model): ENS's members on a model axis of 4
    if n % 4 == 0:
        groups = data_model_groups(4)
        ens = load_attack_class("ens")(
            model_name=["resnet18", "resnet18", "resnet34", "resnet34"], epoch=2,
            pretrained=False, input_size=64, device="cpu", compute_dtype=FP64)
        serial = ens.model
        ens.model = mesh_ensemble_surrogate(serial, groups)
        delta = ShardedAttackRunner(ens, groups.data)(x, y).numpy()
        if np.abs(delta).max() > EPS + 1e-6:
            raise AssertionError(f"(data, model): |delta|inf {np.abs(delta).max()}")
        ens.model = serial
        if main_rank:
            out["data_model"] = assert_delta_match(delta, ens(x, y).numpy(), ens.alpha,
                                                   "(data, model) vs one process")
    return out if main_rank else None


def dryrun_multichip(n_devices: int, timeout: float = 600.0) -> dict:
    """One MI-FGSM run of 2 iterations on ResNet-50 at 64², 2 images a
    rank, split over ``n_devices`` CPU ranks, held against one process;
    with an even count SIM's copies split too, and with a multiple of 4
    ENS's four members on ranks of their own.  Returns rank 0's
    measurements; raises if a check fails."""
    from .parallel import ranks

    return ranks.spawn(_dryrun_rank, n_devices, timeout=timeout)[0]
