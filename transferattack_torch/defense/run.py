"""Defense CLI (counterpart of ``transferattack_tpu/defense/run.py``; the
reference's ``defense/*_defense.sh``).

    python -m transferattack_torch.defense.run --defense at  --input_dir data --output_dir adv
    python -m transferattack_torch.defense.run --defense rs  ...
    python -m transferattack_torch.defense.run --defense nrp ... --purified_dir purified
    python -m transferattack_torch.defense.run --defense hgd ...
    python -m transferattack_torch.defense.run --defense diffpure ...

AT, HGD, RS and DiffPure write a prediction CSV and print ``{DEFENSE} ASR:
{asr:.2f}%`` by the ``check_output`` scorer; NRP writes purified PNGs for a
normal ``python -m transferattack_torch.main --eval`` pass
(``defense/nrp_defense.sh:14-16``).  Everything runs on the CUDA card unless
``--device cpu`` asks for the CPU; without a card the CUDA default raises.
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

from .scoring import asr_from_labels


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description="Defense evaluation on PyTorch/CUDA")
    p.add_argument("--defense", required=True, choices=["at", "hgd", "rs", "nrp", "diffpure"])
    p.add_argument("--input_dir", default="./data")
    p.add_argument("--output_dir", default="./results")
    p.add_argument("--purified_dir", default="./purified_data")
    p.add_argument("--batchsize", default=16, type=int)
    p.add_argument("--targeted", action="store_true")
    p.add_argument("--sigma", default=0.5, type=float)
    p.add_argument("--N", default=1000, type=int)
    p.add_argument("--dynamic", action="store_true")
    # DiffPure's defaults as the shipped driver sets them (diffpure_defense.sh:11-13)
    p.add_argument("--t_star", default=150, type=int)
    p.add_argument("--diffusion_type", default="sde", choices=["sde", "ddpm"])
    p.add_argument("--classifier_name", default="resnet101")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device; 'cpu' runs on the CPU")
    args = p.parse_args(argv)

    common = dict(batchsize=args.batchsize, device=args.device)
    if args.defense == "at":
        from .at import run_at

        csv_path = run_at(args.input_dir, args.output_dir, **common)
    elif args.defense == "hgd":
        from .at import run_hgd

        csv_path = run_hgd(args.input_dir, args.output_dir, **common)
    elif args.defense == "rs":
        from .rs import run_rs

        csv_path = run_rs(args.input_dir, args.output_dir, sigma=args.sigma, n=args.N, **common)
    elif args.defense == "diffpure":
        from .diffpure import run_diffpure

        csv_path = run_diffpure(args.input_dir, args.output_dir, t_star=args.t_star,
                                model_name=args.classifier_name,
                                diffusion_type=args.diffusion_type, **common)
    else:
        from .nrp import run_nrp

        out = run_nrp(args.input_dir, args.output_dir, args.purified_dir,
                      dynamic=args.dynamic, **common)
        print(f"Purified images written to {out}; score with "
              f"`python -m transferattack_torch.main --eval --input_dir {args.input_dir} "
              f"--output_dir {out}`")
        return

    asr = asr_from_labels(os.path.join(args.input_dir, "labels.csv"), csv_path,
                          targeted=args.targeted)
    print(f"{args.defense.upper()} ASR: {asr:.2f}%")


if __name__ == "__main__":
    main()
