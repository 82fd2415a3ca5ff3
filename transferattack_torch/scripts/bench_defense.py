"""Defense throughput on the card (counterpart of ``scripts/bench_defense.py``).

Times each defense's core at its official configuration on seeded inputs
held on the card and seeded weights (timing only: the fallbacks, and
DiffPure's full UNet seeded nonzero on the card), and prints one JSON line a
defense: batch, seconds an image, images per second, the
operations an image (``torch.utils.flop_counter`` over the warm-up call),
peak device memory, and the card's name and power limit.

* ``rs``: randomized smoothing's votes, σ 0.5, N 1000 in chunks of 50,
  ResNet-50 at 224², batch 8 (the reference's one published time: about
  1 h for 1000 images on an RTX 4090, ``defense/README.md:35``);
* ``at``: the fast-AT ResNet-50's predictions, batch 32;
* ``hgd``: DUNet and Inception-v3 at 299², batch 8; ``hgd4``: the
  four-member chain (DUNet before ResNet-152, Inception-ResNet-v2,
  Inception-v3 and ResNeXt-101 32x4d, logits summed);
* ``nrp``: the 23-RRDB purifier at 224², batch 8;
* ``diffpure``: the whole reverse SDE from t* 150 (150 UNet forwards) of
  the full ImageNet-256 guided-diffusion UNet at 256², batch 1, run step by
  step, so nothing is extrapolated.

Each is warmed up once (DiffPure: one UNet forward), then timed over
three calls (DiffPure: one), as JAX's bench times them, by the host clock
around calls that end in ``torch.cuda.synchronize()``.

    python -m transferattack_torch.scripts.bench_defense [--only rs,at,hgd,hgd4,nrp,diffpure]
"""
from __future__ import annotations

import argparse
import json
import time
import warnings
from typing import Callable, List, Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from ..defense.at import _load_hgd_member, hgd_logits, HGD_ENSEMBLE
from ..defense.diffpure import DiffPure
from ..defense.gd_unet import GuidedDiffusionUNet, init_nonzero
from ..defense.nrp import load_purifier
from ..defense.rs import Smooth
from ..models import make_model, nhwc
from ..utils.timing import card

DEFENSES = ("rs", "at", "hgd", "hgd4", "nrp", "diffpure")
REPS = 3


def timed(fn: Callable[[], object], warmup: Callable[[], object], reps: int):
    """(seconds a call over ``reps`` calls, TFLOP of one ``warmup`` call,
    peak GiB of the timed calls), under ``torch.inference_mode``."""
    with torch.inference_mode():
        with FlopCounterMode(display=False) as counter:
            warmup()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / reps
    return secs, counter.get_total_flops() / 1e12, torch.cuda.max_memory_allocated() / 2**30


def main(argv: Optional[List[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", type=str, default="", help="a comma list of " + ",".join(DEFENSES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_defense: needs a CUDA card")
    chosen = args.only.split(",") if args.only else list(DEFENSES)
    dev, smi = torch.device("cuda"), card()
    rng = np.random.RandomState(0)
    lines = []

    def images(b, side):
        return torch.from_numpy(rng.rand(b, side, side, 3).astype(np.float32)).to(dev)

    def emit(name, batch, secs, tflop_per_call, peak, note, reps=REPS):
        line = {"defense": name, "batch": batch, "sec_per_image": secs / batch,
                "img_per_sec": batch / secs, "tflop_per_image": tflop_per_call / batch,
                "peak_gib": peak, "reps": reps, "card": smi, "note": note}
        print(json.dumps(line), flush=True)
        lines.append(line)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # every network here runs on seeded weights
        if "rs" in chosen:
            x = images(8, 224)
            smooth = Smooth(make_model("resnet50", device=dev), sigma=0.5)
            gen = torch.Generator(device=dev).manual_seed(0)
            votes = lambda: smooth._count_votes(x, gen, 1000, 50)  # noqa: E731
            emit("rs", 8, *timed(votes, votes, REPS),
                 "sigma 0.5, N 1000 votes in chunks of 50, resnet50 fp32 at 224² (the "
                 "reference: about 3.6 s an image on an RTX 4090, defense/README.md:35)")
        if "at" in chosen:
            x = images(32, 224)
            model = make_model("resnet50", device=dev)
            classify = lambda: model.apply(x).argmax(-1)  # noqa: E731
            emit("at", 32, *timed(classify, classify, REPS),
                 "fast-AT resnet50 fp32 predictions at 224²")
        for name, members in (("hgd", [("hgd_inception_v3", "inception_v3")]),
                              ("hgd4", list(HGD_ENSEMBLE))):
            if name in chosen:
                x = images(8, 299)
                loaded = [_load_hgd_member(c, m, dev) for c, m in members]
                classify = lambda: hgd_logits(loaded, x).argmax(-1)  # noqa: E731
                emit(name, 8, *timed(classify, classify, REPS),
                     f"DUNet denoise + classify at 299², fp32: {', '.join(m for _, m in members)}")
                del loaded
        if "nrp" in chosen:
            x = images(8, 224)
            net = load_purifier(device=dev)
            purify = lambda: torch.clamp(nhwc(net, x), 0.0, 1.0)  # noqa: E731
            emit("nrp", 8, *timed(purify, purify, REPS), "NRP 23 RRDBs, fp32 at 224²")
            del net
        if "diffpure" in chosen:
            x = images(1, 256)
            dp = DiffPure(t_star=150, device=dev)  # the schedule; its UNet is replaced next
            with torch.device(dev):  # built and seeded on the card: a host init takes a minute
                unet = GuidedDiffusionUNet()
            dp.unet = init_nonzero(unet, torch.Generator(device=dev).manual_seed(0)) \
                .requires_grad_(False).to(memory_format=torch.channels_last)
            gen = torch.Generator(device=dev).manual_seed(0)
            secs, tflop, peak = timed(lambda: dp(x, gen), lambda: dp.unet_out(x, 0), 1)
            steps = len(dp.time_grid()[0])
            emit("diffpure", 1, secs, tflop * steps, peak,
                 f"the full 256² guided-diffusion UNet, fp32, reverse SDE from t* 150: {steps} "
                 "UNet forwards a call, all run", reps=1)
    torch.cuda.empty_cache()
    return lines


if __name__ == "__main__":
    main()
