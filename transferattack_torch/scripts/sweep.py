"""Benchmark-table sweep driver (counterpart of the JAX package's
``scripts/sweep.py``).

Runs a list of attacks over an image set through the port's CLI and
evaluates each against the eight paper models, appending rows to
``results_eval.txt`` / ``results_eval.jsonl`` in the working directory: the
programmatic form of the reference's per-attack example scripts, whose
README tables are the published numbers.

    python -m transferattack_torch.scripts.sweep --input_dir ./data \\
        --out_root adv_data --attacks mifgsm,dim,tim,sim,admix --model resnet50 [--bf16]
    python -m transferattack_torch.scripts.sweep --smoke [--out_root DIR]

Each attack runs as ``python -m transferattack_torch.main --skip_existing``
into ``<out_root>/<attack>/<model>``, then ``--eval`` over it, with the JAX
sweep's flags and ``--device`` passed through.  ASR parity with BASELINE.md
needs converted pretrained weights in ``$TA_TPU_WEIGHTS_DIR``
(``python -m transferattack_torch.utils.convert``).

``--smoke`` proves the 224² path end to end: it writes 8 seeded 224² PNGs
and their ``labels.csv`` (with the port's own PNG writer), runs MI-FGSM on
ResNet-50 with ``--bf16`` at batch 8 through the CLI, then ``--eval
--eval_models resnet50``, checks that every written PNG moved and none
moved more than 16/255 + 1/255 (the uint8 round trip), and writes its JSON
summary to ``<out_root>/smoke.json`` (by default under the temporary
directory).  The surrogate falls back to seeded weights unless converted
ones are present: this checks the path, not ASR.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..utils.data import load_image
from ..utils.png import write_png

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
UNTARGETED_DEFAULT = (
    "fgsm,ifgsm,mifgsm,nifgsm,pifgsm,vmifgsm,vnifgsm,emifgsm,dim,tim,sim,"
    "admix,ssm,bsr,sia,fia,naa,taig"
)
SMOKE_IMAGES, SMOKE_EPS, SMOKE_QUANT = 8, 16 / 255, 1 / 255


def subprocess_cli(argv: Sequence[str], cwd: Optional[str] = None) -> None:
    """``python -m transferattack_torch.main <argv>`` in ``cwd``, the
    repository on the path."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p))
    cmd = [sys.executable, "-m", "transferattack_torch.main", *argv]
    print("==>", " ".join(cmd), flush=True)
    subprocess.run(cmd, check=True, cwd=cwd, env=env)


def inprocess_cli(argv: Sequence[str], cwd: Optional[str] = None) -> None:
    """The same CLI called in this process (no start-up per call), the
    fallback registry emptied first as a new process would find it."""
    from .. import main as cli
    from ..utils.weights_manifest import reset_fallbacks

    reset_fallbacks()
    print("==> transferattack_torch.main", " ".join(argv), flush=True)
    here = os.getcwd()
    if cwd:
        os.chdir(cwd)
    try:
        cli.main(list(argv))
    finally:
        os.chdir(here)


def smoke_images(side: int, n: int = SMOKE_IMAGES, seed: int = 0) -> List[np.ndarray]:
    """The JAX sweep's structured uint8 images: blobs over a gradient."""
    rng = np.random.default_rng(seed)
    grid = np.mgrid[0:side, 0:side]
    out = []
    for _ in range(n):
        yy, xx = grid / float(side)
        img = np.stack([yy, xx, (yy + xx) / 2], -1)
        for _ in range(4):
            cy, cx, r = rng.uniform(0, side, 2).tolist() + [rng.uniform(20, 60) * side / 224]
            img[(grid[0] - cy) ** 2 + (grid[1] - cx) ** 2 < r * r] = rng.uniform(0, 1, 3)
        out.append((img * 255).astype(np.uint8))
    return out


def run_smoke(out_root: str, model: str = "resnet50", side: int = 224, device: str = "cuda",
              classes: int = 1000, bf16: bool = True, cli: Callable = subprocess_cli) -> dict:
    """The smoke drive; returns its summary (also written to
    ``<out_root>/smoke.json``).  ``bf16=False`` runs the attack in fp32 (the
    CPU has no bf16 antialiased resize, which a small surrogate's
    preprocessing takes)."""
    out_root = os.path.abspath(out_root)
    data, out = os.path.join(out_root, "data"), os.path.join(out_root, "adv")
    os.makedirs(os.path.join(data, "images"), exist_ok=True)
    names = []
    for i, img in enumerate(smoke_images(side)):
        names.append(f"smoke_{i}.png")
        write_png(os.path.join(data, "images", names[-1]), img)
    with open(os.path.join(data, "labels.csv"), "w") as f:
        f.write("filename,label\n")
        for i, n in enumerate(names):
            f.write(f"{n},{i * 100 % classes + 1}\n")
    common = ["--input_dir", data, "--output_dir", out, "--batchsize", str(SMOKE_IMAGES),
              "--device", device]
    t0 = time.perf_counter()
    cli(["--attack", "mifgsm", "--model", model, *(["--bf16"] if bf16 else []), *common],
        cwd=out_root)
    t_attack = time.perf_counter() - t0
    cli(["--eval", "--attack", "mifgsm", "--eval_models", model, *common], cwd=out_root)
    max_linf, nonzero = 0.0, 0
    for n in names:  # the clean image as the CLI reads it (at 224²)
        clean = load_image(os.path.join(data, "images", n))
        adv = load_image(os.path.join(out, n))
        d = float(np.abs(adv - clean).max())
        max_linf, nonzero = max(max_linf, d), nonzero + int(d > 0)
    with open(os.path.join(out, "attack_meta.json")) as f:
        fallbacks = json.load(f).get("fallback_weights_used", [])
    rec = {"smoke": f"mifgsm/{model}/{side}x{side}/batch{SMOKE_IMAGES}", "device": device,
           "bf16": bf16,
           "attack_seconds": round(t_attack, 2), "max_linf": round(max_linf, 5),
           "eps": round(SMOKE_EPS, 5), "nonzero_deltas": nonzero,
           "fallback_weights_used": fallbacks,
           "ok": max_linf <= SMOKE_EPS + SMOKE_QUANT and nonzero == len(names)}
    with open(os.path.join(out_root, "smoke.json"), "w") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec))
    return rec


def sweep(args, cli: Callable = subprocess_cli) -> None:
    """Each attack of ``args.attacks``, then its eval."""
    for attack in args.attacks.split(","):
        out_dir = os.path.join(args.out_root, attack, args.model)
        flags = ["--input_dir", args.input_dir, "--output_dir", out_dir,
                 "--batchsize", str(args.batchsize), "--device", args.device]
        if args.targeted:
            flags.append("--targeted")
        cli(["--attack", attack, "--model", args.model, *flags, "--skip_existing",
             *(["--bf16"] if args.bf16 else [])])
        if not args.skip_eval:
            cli(["--eval", "--attack", attack, *flags,
                 *(["--eval_models", args.eval_models] if args.eval_models else [])])


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="attack sweep through the port's CLI")
    p.add_argument("--smoke", action="store_true", help="the 224² smoke drive")
    p.add_argument("--input_dir", default="./data")
    p.add_argument("--out_root", default=None,
                   help="default ./adv_data, or for --smoke a directory under the temporary one")
    p.add_argument("--attacks", default=UNTARGETED_DEFAULT)
    p.add_argument("--model", default="resnet50")
    p.add_argument("--batchsize", default=32, type=int)
    p.add_argument("--targeted", action="store_true")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--skip_eval", action="store_true")
    p.add_argument("--eval_models", default="", type=str,
                   help="comma list overriding the 8 paper eval models")
    p.add_argument("--device", default="cuda", type=str)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = get_parser().parse_args(argv)
    if args.smoke:
        root = args.out_root or os.path.join(tempfile.gettempdir(), "ta_torch_smoke")
        return 0 if run_smoke(root, device=args.device)["ok"] else 1
    args.out_root = args.out_root or "./adv_data"
    sweep(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
