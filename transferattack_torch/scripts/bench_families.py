"""Per-family throughput table (counterpart of the JAX package's
``scripts/bench_families.py``): the heavy estimator attacks, where the
copies and neighbour axes run as one batch.

    python -m transferattack_torch.scripts.bench_families [--batch 32] [--reps 3] [--only mifgsm,ssm]

Each case runs its key on its surrogate with bf16 compute on seeded
224² inputs held on the card (the case's model, or ``--model``; labels
``(y, y + 7)`` for the targeted keys) at the key's own batch cap where it
has one.  One cold call is timed, then one call estimates the time, then
the number of calls is calibrated to at least ``--target_s`` (10 s) of
device work, and never fewer than ``--reps``; each call ends in
``torch.cuda.synchronize()``.  One JSON line a family: the JAX bench's
fields (``attack``, ``note``, ``img_per_sec``, ``batch``, ``reps``,
``compile_s``: here the cold call's seconds), the update kernel's launches
in one call and the peak device memory of the timed calls, and the card's
name and power limit.  A failed case prints its error and the run goes on.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np
import torch

import transferattack_torch as tt
from transferattack_torch.ops.fused_update import fused_sign_update

CASES = [
    # (key, model, kwargs, note)
    ("mifgsm", "resnet50", {}, "baseline, 10 iters"),
    ("vmifgsm", "resnet50", {}, "20-neighbor variance tuning"),
    ("ssm", "resnet50", {}, "20 spectrum copies (DCT)"),
    ("bsr", "resnet50", {}, "20 block-shuffled copies"),
    ("ens", ["resnet50", "vgg16", "mobilenet_v2", "inception_v3"], {},
     "4-CNN logit-mean ensemble"),
    ("tgr", "vit_base_patch16_224", {}, "ViT surrogate, token-grad surgery"),
    ("l2t", "resnet50", {}, "3 learned 2-op aug chains (10-way op switch)"),
    ("idaa", "resnet50", {}, "10 warp copies + local mixup, targeted"),
    ("anda", "resnet50", {}, "25 translated views per iteration"),
    ("rap", "resnet50", {}, "official 400 epochs, 8-step inner adv after "
     "transpoint=100 -> 2500 fwd+bwd passes (250x mifgsm bound)"),
    ("foolmix", "resnet50", {}, "m=5 mix lines x (n=3+z=1) samples + k=5 "
     "dict grads per iter -> ~25x mifgsm bound"),
    ("decowa", "resnet50", {}, "20 elastic warps x (1+rho-step grad) per "
     "iter, host TPS solve -> ~40x bound"),
    ("mef", "resnet50", {}, "20 neighbors x 20 epochs = 400 passes "
     "-> ~40x mifgsm bound"),
    ("fgsra", "resnet50", {}, "20 freq-domain neighbors (DCT mask+noise) "
     "-> ~21x bound"),
    ("cfm", "resnet50", {}, "targeted T=300 protocol, 2 mixed copies via "
     "feature-mix taps -> ~60x bound"),
    ("odi", "resnet50", {}, "num_sample=10 3D renders/iter (barycentric "
     "rasterizer) + TI smoothing, targeted T=300"),
    ("everywhere", "resnet50", {}, "CDTM region views (3x3 grid) x CFM "
     "mixup per iter"),
    ("dra", "resnet50", {}, "checkpoint-surrogate family shape (DRA "
     "fine-tuned weights; random fallback offline) = mifgsm compute"),
    ("trap", "resnet50", {}, "300-epoch two-phase; gather-forward "
     "RandomAffine view each enhance iter (see BASELINE.md warp "
     "experiments)"),
    ("vdc", "vit_base_patch16_224", {}, "ViT virtual dense connection: "
     "attn+mlp cotangent injections"),
]
TARGET_S = 10.0


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_case(key: str, model, kwargs: dict, note: str, x, y, dev: torch.device,
               reps: int, target_s: float) -> dict:
    """One family's JSON record (see the module's docstring)."""
    atk = tt.load_attack_class(key)(model_name=model, compute_dtype="bfloat16", device=dev,
                                    **kwargs)
    batch = min(x.shape[0], atk.requires_batchsize or x.shape[0])
    classes = atk.model.num_classes
    xb, yb = x[:batch], y[:batch] % classes
    # targeted attacks take (source, target) label pairs
    yk = torch.stack([yb, (yb + 7) % classes], 1) if atk.targeted else yb

    def call(i: int):
        return atk(xb, yk, idx=i)

    sync(dev)
    t0 = time.perf_counter()
    call(9)
    sync(dev)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    call(10)
    sync(dev)
    est = time.perf_counter() - t0
    n = max(reps, int(target_s / max(est, 1e-3)) + 1)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    fused_sign_update.launches = 0
    t0 = time.perf_counter()
    for i in range(n):
        call(i)
    sync(dev)
    dt = time.perf_counter() - t0
    return {"attack": key, "note": note, "img_per_sec": round(batch * n / dt, 2),
            "batch": batch, "reps": n, "compile_s": round(cold, 1),
            "launches": fused_sign_update.launches // n,
            "peak_gib": (round(torch.cuda.max_memory_allocated(dev) / 2**30, 2)
                         if dev.type == "cuda" else None)}


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="per-family throughput, one JSON line a family")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", type=str, default="", help="a comma list of keys")
    ap.add_argument("--target_s", type=float, default=TARGET_S,
                    help="seconds of work the timed calls are calibrated to")
    ap.add_argument("--model", type=str, default="", help="every case on this surrogate")
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
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(args.batch, args.size, args.size, 3).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randint(0, 1000, size=(args.batch,))).to(dev)
    records = []
    for key, model, kwargs, note in CASES:
        if args.only and key not in args.only.split(","):
            continue
        try:
            rec = bench_case(key, args.model or model, kwargs, note, x, y, dev, args.reps,
                             args.target_s)
            rec["card"] = where
        except Exception as exc:  # noqa: BLE001 - one case's failure is its line
            rec = {"attack": key, "error": str(exc)[:200]}
        records.append(rec)
        print(json.dumps(rec), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return records


if __name__ == "__main__":
    main()
