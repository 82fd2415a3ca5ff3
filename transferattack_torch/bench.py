"""Headline benchmark of the port: adversarial images per second.

    python -m transferattack_torch.bench

MI-FGSM against a ResNet-50 surrogate, bf16 compute with fp32 delta,
momentum and loss, batch 128, 224², 10 iterations (the configuration of the
JAX package's ``bench.py``), on inputs and labels made from a seed and
seeded random weights (throughput does not depend on the weights).  The
inputs stay on the card; one warm-up call, then 8 timed calls, each ended
by ``torch.cuda.synchronize()``.  Prints one JSON line:

    {"metric": "torch_mifgsm_resnet50_10iter_adv_images_per_sec",
     "value": <batch * 8 / the 8 calls' seconds together>,
     "unit": "images/sec",
     "spread": <(max - min) / median of the per-call rates>, "reps": 8,
     "device": {"name": ..., "power_limit": ...}}

The metric's name is not the JAX bench's, so the two chips' numbers never
share a row.  ``--device``, ``--model``, ``--batch`` and ``--size`` let a
CPU test run it on a toy model; the metric then names that model.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import List, Optional

import numpy as np
import torch

import transferattack_torch as tt
from transferattack_torch.models import resolve_device

REPS = 8  # timed calls, after one warm-up

def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--model", default="resnet50")
    p.add_argument("--batch", default=128, type=int)
    p.add_argument("--size", default=224, type=int)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cuda = device.type == "cuda"

    attacker = tt.load_attack_class("mifgsm")(
        model_name=args.model, epoch=10, compute_dtype="bfloat16", device=device)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(args.batch, args.size, args.size, 3).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, attacker.model.num_classes, size=args.batch))
    x, y = x.to(device), y.to(device)

    def call(i: int) -> float:
        t0 = time.perf_counter()
        attacker(x, y, idx=i)
        if cuda:
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    call(0)  # warm-up: builds the kernel, picks the cuDNN algorithms
    seconds = [call(i) for i in range(1, REPS + 1)]
    rates = [args.batch / s for s in seconds]
    if cuda:
        from transferattack_torch.utils.timing import card

        name, power_limit = (s.strip() for s in card().split(",", 1))
    else:
        name, power_limit = "cpu", None
    line = {"metric": f"torch_mifgsm_{args.model}_10iter_adv_images_per_sec",
            "value": args.batch * REPS / sum(seconds), "unit": "images/sec",
            "spread": (max(rates) - min(rates)) / statistics.median(rates),
            "reps": REPS,
            "device": {"name": name, "power_limit": power_limit}}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
