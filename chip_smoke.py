#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card, phase by phase.

    python3 chip_smoke.py        # from the root of the repository

The main path is MI-FGSM on a full-width ResNet-50 at 224², batch 128,
10 iterations, bf16 compute with fp32 delta, momentum and loss, on seeded
random weights.  Phases:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compile the CUDA kernel from ``transferattack_torch/ops/csrc``;
3. kernel: ``fused_sign_update`` bit-exact with its plain PyTorch version at
   the main-path shape and at a ragged one, and both timed;
4. fp32 parity: MI-FGSM on the card (TF32 off) against the same model on the
   CPU, 2 images, 3 iterations: deltas agree in sign on > 99% of elements;
5. main path: bounds, a loss that rose, exactly 10 kernel launches per call,
   white-box ASR and images per second.

Any failed phase ends the run with a non-zero exit.  Without a card it fails
at once.  The last line is the JSON summary.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

import transferattack_torch as tt
from transferattack_torch.attack import softmax_cross_entropy
from transferattack_torch.ops import _build
from transferattack_torch.ops.fused_update import (
    fused_sign_update,
    fused_sign_update_plain,
)

REPO = Path(__file__).resolve().parent
EPS, ALPHA = 16 / 255, 1.6 / 255
MAIN_SHAPE = (128, 224, 224, 3)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def update_inputs(shape, gen, dev):
    """delta in and out of the eps-ball, momentum with exact zeros, x with
    pixels on both bounds."""
    d = torch.randn(shape, generator=gen, device=dev) * 0.05
    m = torch.randn(shape, generator=gen, device=dev)
    m[torch.rand(shape, generator=gen, device=dev) < 0.05] = 0.0
    x = torch.rand(shape, generator=gen, device=dev)
    x[torch.rand(shape, generator=gen, device=dev) < 0.05] = 0.0
    x[torch.rand(shape, generator=gen, device=dev) < 0.05] = 1.0
    return d, m, x


def median_ms(fn, reps: int = 20, burst: int = 10, warmup: int = 3) -> float:
    """Median device time of one call of ``fn``, by CUDA events: ``reps``
    samples, each a burst of ``burst`` back-to-back calls, so the queue
    stays full and the host's launch latency is not timed."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(burst):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / burst)
    return statistics.median(times)


def main() -> None:
    check(torch.cuda.is_available(),
          "torch.cuda.is_available() is False: this script runs on a CUDA card")
    dev = torch.device("cuda", 0)

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    print(f"[1 device] torch.cuda.get_device_name(0): {name}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)

    # 2. build
    t0 = time.perf_counter()
    _build.load_library("fused_update")
    print(f"[2 build] {_build.library_path('fused_update').relative_to(REPO)} "
          f"built and loaded in {time.perf_counter() - t0:.2f} s")

    # 3. kernel against its plain version
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    for shape in (MAIN_SHAPE, (3, 37, 41, 3)):
        d, m, x = update_inputs(shape, gen, dev)
        out = fused_sign_update(d, m, x, ALPHA, EPS, 0.0, 1.0)
        ref = fused_sign_update_plain(d, m, x, ALPHA, EPS, 0.0, 1.0)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        max_err = max(max_err, err)
        check(torch.equal(out, ref), f"kernel differs from plain at {shape}: {err}")
        print(f"[3 kernel] {shape}: bit-exact with the plain version")
    d, m, x = update_inputs(MAIN_SHAPE, gen, dev)
    kernel_ms = median_ms(lambda: fused_sign_update(d, m, x, ALPHA, EPS, 0.0, 1.0))
    plain_ms = median_ms(lambda: fused_sign_update_plain(d, m, x, ALPHA, EPS, 0.0, 1.0))
    nbytes = 16 * d.numel()
    print(f"[3 kernel] {MAIN_SHAPE} fp32, median of 20 bursts of 10 on {card}: kernel "
          f"{kernel_ms:.4f} ms ({nbytes / kernel_ms / 1e9:.1f} TB/s of 16 B/element), "
          f"plain {plain_ms:.4f} ms")
    del d, m, x

    # 4. fp32 slice: the card against the CPU
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(1)
    xs = rng.rand(2, 224, 224, 3).astype(np.float32)
    ys = rng.randint(0, 1000, size=2)
    deltas = {}
    for where in ("cuda", "cpu"):
        attack = tt.load_attack_class("mifgsm")(model_name="resnet50", epoch=3,
                                                device=where)
        deltas[where] = attack(xs, ys).cpu().numpy()
    agree = float((np.sign(deltas["cuda"]) == np.sign(deltas["cpu"])).mean())
    check(agree > 0.99, f"fp32 delta sign agreement card vs CPU {agree}")
    print(f"[4 fp32] ResNet-50 MI-FGSM, 2 x 224², 3 iterations: delta sign "
          f"agreement card vs CPU {agree:.6f}")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

    # 5. main path
    attack = tt.load_attack_class("mifgsm")(model_name="resnet50",
                                            compute_dtype="bfloat16", device="cuda")
    x = torch.from_numpy(np.random.RandomState(2).rand(*MAIN_SHAPE).astype(np.float32))
    x = x.to(dev)
    with torch.no_grad():
        logits0 = attack.model.apply(x)
    y = logits0.argmax(-1)
    fused_sign_update.launches = 0
    delta = attack(x, y)
    torch.cuda.synchronize()
    launches = fused_sign_update.launches
    check(launches == attack.epoch == 10, f"{launches} kernel launches, expected 10")
    check(bool(torch.isfinite(delta).all()), "delta is not finite")
    check(tuple(delta.shape) == MAIN_SHAPE, f"delta shape {tuple(delta.shape)}")
    linf = float(delta.abs().max())
    check(0.0 < linf <= EPS + 1e-6, f"|delta|inf = {linf}")
    adv = x + delta
    check(float(adv.min()) >= -1e-6 and float(adv.max()) <= 1 + 1e-6,
          "x + delta leaves [0, 1]")
    with torch.no_grad():
        logits1 = attack.model.apply(adv)
    ce0 = float(softmax_cross_entropy(logits0, y).mean())
    ce1 = float(softmax_cross_entropy(logits1, y).mean())
    check(ce1 > ce0, f"cross-entropy did not rise: {ce0} -> {ce1}")
    asr = float((logits1.argmax(-1) != y).float().mean())
    print(f"[5 main path] MI-FGSM ResNet-50 bf16, batch 128, 224², 10 iterations: "
          f"{launches} kernel launches, |delta|inf*255 = {linf * 255:.4f}, "
          f"CE {ce0:.4f} -> {ce1:.4f}, white-box ASR {asr:.4f}")
    times = []  # the checked call above was the warm-up
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        attack(x, y)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(f"[5 main path] {MAIN_SHAPE[0] / statistics.median(times):.2f} img/s "
          f"(calls {', '.join(f'{t:.4f}' for t in times)} s) on {card}")

    print(json.dumps({"kernels": [{
        "name": "fused_sign_update",
        "route": "cuda",
        "source": "transferattack_torch/ops/csrc/fused_update.cu",
        "replaces": "transferattack_tpu/ops/pallas_update.py:33",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
