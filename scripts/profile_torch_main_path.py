#!/usr/bin/env python3
"""Device profile of the PyTorch port's main path on one CUDA card.

    python3 scripts/profile_torch_main_path.py [--out PATH]

One warm-up call of MI-FGSM (ResNet-50, bf16 compute, batch 128, 224²,
10 iterations, seeded random weights), then one call under
``torch.profiler``.  Prints the device time by kernel class, the device's
busy share of the call's wall time and the top kernels; ``--out`` also
writes the profiler's full table there.  Fails when the profiler saw no
device time.
"""
from __future__ import annotations

import argparse
import re
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import transferattack_torch as tt  # noqa: E402
from transferattack_torch.utils.timing import card  # noqa: E402

CLASSES = [  # first match wins
    ("fused_sign_update", re.compile(r"fused_sign_update")),
    ("conv dgrad (input gradient)", re.compile(r"dgrad", re.I)),
    ("conv fprop", re.compile(r"fprop|conv|xmma|implicit|cudnn", re.I)),
    ("batch norm", re.compile(r"batch_norm|bn_", re.I)),
    ("max pool", re.compile(r"max_pool", re.I)),
    ("gemm (fc)", re.compile(r"gemm|cutlass", re.I)),
    ("reduction", re.compile(r"reduce", re.I)),
    ("elementwise", re.compile(r"elementwise", re.I)),
]


def kernel_class(name: str) -> str:
    for label, pattern in CLASSES:
        if pattern.search(name):
            return label
    return "other"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="file for the profiler's full table")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_main_path: needs a CUDA card")
    smi = card()
    attack = tt.load_attack_class("mifgsm")(model_name="resnet50",
                                            compute_dtype="bfloat16", device="cuda")
    x = torch.from_numpy(np.random.RandomState(2).rand(128, 224, 224, 3)
                         .astype(np.float32)).cuda()
    with torch.no_grad():
        y = attack.model.apply(x).argmax(-1)
    attack(x, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        attack(x, y)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    by_class = defaultdict(float)
    for e in kernels:
        by_class[kernel_class(e.key)] += e.self_device_time_total
    busy = sum(by_class.values())
    if busy <= 0:
        raise SystemExit("profile_torch_main_path: the profiler recorded no device time")
    print(f"one MI-FGSM call, ResNet-50 bf16, batch 128, 224², 10 iterations, on {smi}")
    print(f"wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
          f"({100 * busy / wall_us:.2f}% busy, {100 - 100 * busy / wall_us:.2f}% idle)")
    for label, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {label:30s} {us / 1e3:10.3f} ms  {100 * us / busy:6.2f}%")
    print("top kernels by device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:110]}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=80))


if __name__ == "__main__":
    main()
