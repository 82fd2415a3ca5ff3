"""A/B on the card: the CUDA fused bottleneck backward-input against its plain
PyTorch composition (cuBLAS and cuDNN).

Counterpart of ``scripts/bench_fused_bwd.py``: ResNet-50 stage-1 shapes
(56², 256/64/64 channels) at batch 128, bfloat16, from the same numpy
``RandomState(0)`` draws.  One JSON line per case: the chain's equality
(kernels against plain), then the chain, the isolated 3×3 and the isolated
1×1 (256 → 64; then the chain's two 1×1 launches, 256 → 64 with ``g·mask``
as a second output and 64 → 256 with the skip), each ``plain`` and
``cuda``, and the elementwise ``g·mask`` pass the chain no longer makes;
then a summary with the floor of the chain's bytes at the H100's 3.35 TB/s
and the card's name and power limit.  Times are medians of 20 bursts of 10
calls, by CUDA events.

    python -m transferattack_torch.scripts.bench_fused_bwd [--batch 128]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import fused_bwd as fb
from ..utils.timing import H100_BYTES_PER_S, card, median_ms

REPS, BURST = 20, 10
MAX_REL_ERR = 2e-2  # the chain rounds to bf16 three times, in another order


def bench(fn, label: str) -> float:
    ms = median_ms(fn, reps=REPS, burst=BURST)
    print(json.dumps({"case": label, "ms": ms, "reps": REPS * BURST}),
          flush=True)
    return ms


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_fused_bwd: needs a CUDA card")
    dev = torch.device("cuda")

    def put(a):
        return torch.from_numpy(np.asarray(a)).to(dev).to(torch.bfloat16)

    b, h, w = args.batch, 56, 56
    rng = np.random.RandomState(0)
    g = put(rng.randn(b, h, w, 256))
    masks = {
        "out": put(rng.rand(b, h, w, 256) > 0.5),
        "c2": put(rng.rand(b, h, w, 64) > 0.5),
        "c1": put(rng.rand(b, h, w, 64) > 0.5),
    }
    weights = {
        "w1": put(rng.randn(1, 1, 256, 64) * 0.05),
        "w2": put(rng.randn(3, 3, 64, 64) * 0.05),
        "w3": put(rng.randn(1, 1, 64, 256) * 0.05),
    }

    # equality on the card first (loose: bf16 rounding and sum order differ)
    ref = fb.bottleneck_bwd_input_plain(g, masks, weights).float()
    out = fb.bottleneck_bwd_input(g, masks, weights).float()
    err = float((ref - out).abs().max())
    scale = float(ref.abs().max()) or 1.0
    print(json.dumps({"case": "equality", "max_abs_err": err, "rel": err / scale}),
          flush=True)
    if not err <= MAX_REL_ERR * scale:
        raise SystemExit(f"bench_fused_bwd: chain differs from plain by {err / scale}")
    del ref, out

    t_plain = bench(lambda: fb.bottleneck_bwd_input_plain(g, masks, weights), "chain/plain")
    t_cuda = bench(lambda: fb.bottleneck_bwd_input(g, masks, weights), "chain/cuda")

    # isolated 3x3 segment
    d2 = put(rng.randn(b, h, w, 64))
    wcol = fb.flip_3x3_for_bwd(weights["w2"])
    bench(lambda: fb.fused_bwd_3x3_plain(d2, masks["c2"], wcol), "3x3/plain")
    bench(lambda: fb.fused_bwd_3x3(d2, masks["c2"], wcol), "3x3/cuda")

    # isolated 1x1 segment (conv3 backward: 256 -> 64)
    flat_g = g.view(b * h * w, 256)
    flat_m = masks["out"].view(b * h * w, 256)
    wt = weights["w3"][0, 0].T.contiguous()
    bench(lambda: fb.fused_bwd_1x1_plain(flat_g, flat_m, wt), "1x1/plain")
    bench(lambda: fb.fused_bwd_1x1(flat_g, flat_m, wt), "1x1/cuda")
    # the chain's two 1x1 launches: the first also writes g·mask, the last
    # (conv1 backward: 64 -> 256) takes it as the skip
    bench(lambda: fb.fused_bwd_1x1_plain(flat_g, flat_m, wt, return_gm=True), "1x1_gm/plain")
    bench(lambda: fb.fused_bwd_1x1(flat_g, flat_m, wt, return_gm=True), "1x1_gm/cuda")
    d1 = d2.view(b * h * w, 64)
    flat_c1 = masks["c1"].view(b * h * w, 64)
    w1t = weights["w1"][0, 0].T.contiguous()
    skip = flat_g * flat_m
    # the pass the chain no longer makes (411 MB in, 205 MB out)
    bench(lambda: torch.mul(flat_g, flat_m, out=skip), "gm_pass/plain")
    bench(lambda: fb.fused_bwd_1x1_plain(d1, flat_c1, w1t, skip), "1x1_skip/plain")
    bench(lambda: fb.fused_bwd_1x1(d1, flat_c1, w1t, skip), "1x1_skip/cuda")

    bytes_chain = 2 * (b * h * w * (256 * 3 + 64 * 3 + 256))  # bf16 in+out
    print(json.dumps({
        "case": "summary", "batch": b,
        "chain_plain_ms": t_plain,
        "chain_cuda_ms": t_cuda,
        "speedup": t_plain / t_cuda,
        "hbm_floor_ms": bytes_chain / H100_BYTES_PER_S * 1e3,
        "card": card(),
    }), flush=True)


if __name__ == "__main__":
    main()
