"""Device profile of the input-transformation keys (and ANDA, MUMODIG) on
one CUDA card.

    python -m transferattack_torch.scripts.profile_input_keys [KEY ...] [--out DIR]

Each key (default: the 19 of ``chip_smoke.py`` phase 12; any other
registry key but AA, which needs an anchor set, may be named) at full width:
ResNet-50, bf16 compute, batch 32, 224², seeded random weights and inputs,
official hyperparameters except OPS at one iteration.  A cold call (the
first at the key's shapes) is timed, then a warm call runs under
``torch.profiler``.  Prints, for each key, both calls' seconds, the warm
call's device busy time and idle share, and its top kernels; ``--out``
writes each key's profiler table there.  Fails when the profiler saw no
device time.  The profiler's own bookkeeping is slow for the keys of many
launches (DeCowA, OPS, SU, ANDA: all 19 keys take about 14 minutes on an
H100), so name a few keys at a time.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import transferattack_torch as tt
from transferattack_torch.models import make_model
from transferattack_torch.utils.timing import card

KEYS = ("dim", "dem", "tim", "sim", "admix", "usmm", "ssm", "ssm_h", "ssm_p", "maskblock",
        "sia", "bsr", "mfi", "decowa", "ops", "su", "l2t", "anda", "mumodig")
CAPS = {"ops": {"epoch": 1}}


def profile_key(key: str, surrogate, x, y, out_dir=None) -> dict:
    atk = tt.load_attack_class(key)(model_name=surrogate, compute_dtype="bfloat16",
                                    device="cuda", **CAPS.get(key, {}))
    labels = (y + 500) % 1000 if atk.targeted else y
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    atk(x, labels)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        atk(x, labels)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels)
    if busy <= 0:
        raise SystemExit(f"profile_input_keys: {key}: the profiler recorded no device time")
    if out_dir:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        (Path(out_dir) / f"{key}.txt").write_text(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=60))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {"key": key, "grad_evals": atk.grad_evals // 2, "cold_s": cold, "warm_s": warm,
            "busy_ms": busy / 1e3, "idle": 1 - busy / 1e6 / warm,
            "top": [(e.key[:90], e.self_device_time_total / 1e3, e.count) for e in top]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("keys", nargs="*", default=list(KEYS))
    ap.add_argument("--out", help="directory for each key's profiler table")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_input_keys: needs a CUDA card")
    smi = card()
    surrogate = make_model("resnet50", device="cuda")
    surrogate.module.to(torch.bfloat16)
    surrogate.compute_dtype = torch.bfloat16
    x = torch.from_numpy(np.random.RandomState(23).rand(32, 224, 224, 3)
                         .astype(np.float32)).cuda()
    with torch.no_grad():
        y = surrogate.apply(x).argmax(-1)
    print(f"ResNet-50 bf16, batch 32, 224², official hyperparameters (OPS at epoch 1), on {smi}")
    for key in args.keys:
        r = profile_key(key, surrogate, x, y, args.out)
        print(f"{key}: {r['grad_evals']} gradient evaluations of 32 images; "
              f"cold {r['cold_s']:.3f} s, warm {r['warm_s']:.3f} s ({1e3 * r['warm_s'] / r['grad_evals']:.1f} ms an "
              f"evaluation); warm device busy {r['busy_ms']:.1f} ms, idle {100 * r['idle']:.1f}%")
        for name, ms, count in r["top"]:
            print(f"    {ms:9.3f} ms  x{count:<6d} {name}")
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
