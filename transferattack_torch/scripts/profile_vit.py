"""ViT-family throughput dissection (counterpart of the JAX package's
``scripts/profile_vit.py``).

Separates "the ViT backward is slow" from "the TGR surgery is slow" by
timing MI-FGSM (no surgery) and TGR on the same ViT-B/16 with bf16 compute,
at each batch of ``--batches``, on seeded 224² inputs held on the card, and
optionally writing a ``torch.profiler`` trace of one more call of each.

    python -m transferattack_torch.scripts.profile_vit [--batches 32,128] [--trace-dir DIR]
        [--only mifgsm_vit,tgr]

A cold call is timed, one call estimates the time, then the calls are
calibrated to at least ``--target_s`` (10 s) and never fewer than 3, each
ending in ``torch.cuda.synchronize()``.  One JSON line a case and batch:
images per second, calls, the cold call's seconds, ms an iteration (the
timed seconds over calls × 10 iterations), the update kernel's launches in
one call, the peak device memory, and the card's name and power limit;
with ``--trace-dir`` also the trace's path (a Chrome trace, ``.json``).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

import transferattack_torch as tt
from transferattack_torch.ops.fused_update import fused_sign_update

CASES = (("mifgsm_vit", "mifgsm"), ("tgr", "tgr"))
MODEL = "vit_base_patch16_224"
TARGET_S = 10.0


def bench_one(key: str, model: str, batch: int, dev: torch.device, trace_dir: str = "",
              size: int = 224, target_s: float = TARGET_S, name: str = "") -> dict:
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(batch, size, size, 3).astype(np.float32)).to(dev)
    atk = tt.load_attack_class(key)(model_name=model, compute_dtype="bfloat16", device=dev)
    y = torch.from_numpy(rng.randint(0, atk.model.num_classes, size=(batch,))).to(dev)
    sync()
    t0 = time.perf_counter()
    atk(x, y, idx=9)
    sync()
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    atk(x, y, idx=10)
    sync()
    est = time.perf_counter() - t0
    reps = max(3, int(target_s / max(est, 1e-3)) + 1)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    fused_sign_update.launches = 0
    t0 = time.perf_counter()
    for i in range(reps):
        atk(x, y, idx=i)
    sync()
    dt = time.perf_counter() - t0
    rec = {"case": f"{name or key}/{model}", "batch": batch,
           "img_per_sec": round(batch * reps / dt, 2), "reps": reps,
           "compile_s": round(cold, 1), "ms_per_iter": round(1000 * dt / (reps * atk.epoch), 2),
           "launches": fused_sign_update.launches // reps,
           "peak_gib": (round(torch.cuda.max_memory_allocated(dev) / 2**30, 2)
                        if dev.type == "cuda" else None)}
    if trace_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            atk(x, y, idx=99)
            sync()
        os.makedirs(trace_dir, exist_ok=True)
        rec["trace"] = os.path.join(trace_dir, f"{name or key}_{model}_b{batch}.json")
        prof.export_chrome_trace(rec["trace"])
    return rec


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="MI-FGSM and TGR on ViT-B/16, ms an iteration")
    ap.add_argument("--batches", type=str, default="32,128")
    ap.add_argument("--trace-dir", type=str, default="")
    ap.add_argument("--only", type=str, default="", help="mifgsm_vit, tgr")
    ap.add_argument("--target_s", type=float, default=TARGET_S)
    ap.add_argument("--model", type=str, default=MODEL)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--device", type=str, default="cuda")
    return ap


def main(argv: Optional[List[str]] = None) -> List[dict]:
    from transferattack_torch.models import resolve_device

    args = get_parser().parse_args(argv)
    dev = resolve_device(args.device)
    where = dev.type
    if where == "cuda":
        from transferattack_torch.utils.timing import card
        where = card()
    records = []
    for b in [int(s) for s in args.batches.split(",")]:
        for name, key in CASES:
            if args.only and name not in args.only.split(","):
                continue
            try:
                rec = bench_one(key, args.model, b, dev, args.trace_dir, args.size,
                                args.target_s, name)
                rec["card"] = where
            except Exception as exc:  # noqa: BLE001 - one case's failure is its line
                rec = {"case": name, "batch": b, "error": str(exc)[:300]}
            records.append(rec)
            print(json.dumps(rec), flush=True)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return records


if __name__ == "__main__":
    main()
