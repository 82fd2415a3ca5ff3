"""Kernel timing on a CUDA card, the card a time belongs to, and the card's bound.

Used by ``chip_smoke.py`` and the benches.  Nothing here runs on the CPU:
timing needs a card.
"""
from __future__ import annotations

import statistics
import subprocess
from typing import Callable, Tuple

import torch

# an NVIDIA H100 SXM at its 700 W limit, from the data sheet
H100_BYTES_PER_S = 3.35e12
H100_BF16_FLOPS = 989e12


def median_ms(fn: Callable[[], object], reps: int = 20, burst: int = 10,
              warmup: int = 3) -> float:
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


def card() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them (first card)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return smi.splitlines()[0]


def bound_ms(nbytes: float, flops: float = 0.0) -> Tuple[float, str]:
    """The least time an H100 could take: the larger of ``nbytes`` over its
    memory rate and ``flops`` over its bf16 tensor-core rate, and which of
    the two it is (``"bytes"`` or ``"operations"``)."""
    by_bytes = nbytes / H100_BYTES_PER_S * 1e3
    by_flops = flops / H100_BF16_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_flops else (by_flops, "operations")
