"""Weights-present ASR gate over the full BASELINE.md protocol, through the
port (counterpart of the JAX package's ``scripts/asr_gate.py``, with its own
copy of that script's table parser, tolerance bands and surrogate protocol).

It parses the two ASR tables of BASELINE.md (the reference's untargeted and
targeted matrices) and reproduces every runnable cell end to end:

  * all 8 model columns (4 CNN + 4 ViT eval models, ``--eval_models``),
  * the 5 defense columns (AT/HGD/RS/NRP/DiffPure through
    ``python -m transferattack_torch.defense.run``; NRP purifies, then its
    PNGs are scored on the white-box surrogate),
  * the ViT-surrogate rows (``--model vit_base_patch16_224``),
  * the 4-CNN ensemble rows (ENS/SVRE/AdaEA/CWA/SMER, ``--ensemble``),
  * the targeted table (``--targeted``, each attack's official epochs;
    a long row resumes by ``--skip_existing`` and, inside a batch, from the
    attack state saved every ``--checkpoint_every`` iterations).

Each attack and eval runs as ``python -m transferattack_torch.main`` with
``--device`` passed through, in ``--out_root`` (where the CLI appends
``results_eval.jsonl``).  Weights gating is per row: a row runs only when
its surrogate's and eval models' weights are converted
(``python -m transferattack_torch.utils.convert``), and a row whose attack
reports ``fallback_weights_used`` in its ``attack_meta.json`` is SKIP,
never compared.

Tolerance bands: deterministic attacks ±1.0 ASR point; attacks that sample
augmentations or noise ±2.5; defense columns ±2.5.

    python -m transferattack_torch.scripts.asr_gate --input_dir ./data
    python -m transferattack_torch.scripts.asr_gate --rows mifgsm,dim --columns cnn
    python -m transferattack_torch.scripts.asr_gate --rows targeted --defenses

Exits 1 if any weights-backed cell falls outside its band; exits 0 (with
SKIP accounting) when weights are absent.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from typing import List, Optional

from ..utils.weights_manifest import weights_root

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BASELINE_MD = os.path.join(REPO, "BASELINE.md")

# column order in the BASELINE.md tables
MODEL_COLS = (
    ("resnet50", "resnet50"),
    ("vgg16", "vgg16"),
    ("mobilenet_v2", "mobilenet_v2"),
    ("inception_v3", "inception_v3"),
    ("vit", "vit_base_patch16_224"),
    ("pit", "pit_b_224"),
    ("visformer", "visformer_small"),
    ("swin", "swin_tiny_patch4_window7_224"),
)
DEFENSE_COLS = ("at", "hgd", "rs", "nrp", "diffpure")

# reference README.md:719 — surrogate assignment per row
VIT_SURROGATE = {"pna_patchout", "sapr", "tgr", "vdc", "att", "fpr",
                 "fdap", "ll2s", "ata_vit"}
ENSEMBLE_4CNN = {"ens", "svre", "adaea", "cwa", "smer"}
# attacks whose only published randomness is the data order (SURVEY §4
# acceptance band ±1.0); everything else samples augmentations → ±2.5
DETERMINISTIC = {
    "fgsm", "ifgsm", "mifgsm", "nifgsm", "aifgtm", "ifgssm", "pcifgsm",
    "iefgsm", "dta", "gifgsm", "mig", "tim", "sim", "sgm", "linbp",
    "iaa", "bpa", "mup", "tap", "ila", "ata", "taig", "logit",
    "logit_margin", "potrip", "ens",
}


def parse_baseline_tables(path: str = BASELINE_MD):
    """Parse BASELINE.md's untargeted + targeted ASR tables.

    Returns {key: {"targeted": bool, "expect": {col: float}}} where key
    is the attack registry key (the reference file stem — BASELINE.md's
    second column cites `transferattack/<cat>/<key>.py`).
    """
    rows, targeted = {}, False
    col_names = [c for c, _ in MODEL_COLS] + list(DEFENSE_COLS)
    for line in open(path, encoding="utf-8"):
        if line.startswith("## Targeted attacks"):
            targeted = True
        if line.startswith("## Build targets") or line.startswith("## Measured"):
            break
        m = re.match(r"\|\s*[^|]+\|\s*`transferattack/([^`]+)`\s*\|(.*)", line)
        if not m:
            continue
        key = os.path.splitext(os.path.basename(m.group(1)))[0]
        vals = [v.strip() for v in m.group(2).strip().strip("|").split("|")]
        if len(vals) != len(col_names):
            continue
        try:
            expect = {c: float(v) for c, v in zip(col_names, vals)}
        except ValueError:
            continue
        rows[key] = {"targeted": targeted, "expect": expect}
    return rows


def npz_present(name: str) -> bool:
    return os.path.exists(os.path.join(weights_root(), f"{name}.npz"))


def surrogate_for(key: str):
    if key in VIT_SURROGATE:
        return "vit_base_patch16_224", False
    if key in ENSEMBLE_4CNN:
        return ",".join(m for _, m in MODEL_COLS[:4]), True
    return "resnet50", False


def tol_for(key: str, col: str) -> float:
    if col in DEFENSE_COLS:
        return 2.5
    return 1.0 if key in DETERMINISTIC else 2.5


def run(cmd: List[str], cwd: str, **kw):
    """``cmd`` in ``cwd`` with the repository on the path."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p))
    print("+", " ".join(cmd), flush=True)
    return subprocess.run(cmd, cwd=cwd, env=env, **kw)


def port_cli(*args: str) -> List[str]:
    return [sys.executable, "-m", "transferattack_torch.main", *args]


def attack_fallbacks(out_dir: str):
    meta = os.path.join(out_dir, "attack_meta.json")
    if os.path.exists(meta):
        with open(meta) as f:
            return json.load(f).get("fallback_weights_used", [])
    return []


def eval_records(args, out_dir: str) -> dict:
    """``{eval_model: asr}`` of ``out_dir`` in ``<out_root>/results_eval.jsonl``."""
    with open(os.path.join(args.out_root, "results_eval.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return {r["eval_model"]: r["asr"] for r in recs if r["output_dir"] == out_dir}


def eval_models_cells(args, key, out_dir, is_targeted, expect, results):
    """``--eval`` over the model columns; compare each cell."""
    cols = MODEL_COLS[:4] if args.columns == "cnn" else MODEL_COLS
    avail = [(c, m) for c, m in cols if npz_present(m)]
    for c, m in cols:
        if (c, m) not in avail:
            results.append((key, c, "SKIP", None, expect[c]))
    if not avail:
        return
    cmd = port_cli("--eval", "--input_dir", args.input_dir, "--output_dir", out_dir,
                   "--attack", key, "--eval_models", ",".join(m for _, m in avail),
                   "--batchsize", str(args.batchsize), "--device", args.device)
    if is_targeted:
        cmd.append("--targeted")
    run(cmd, args.out_root, check=True)
    got = eval_records(args, out_dir)
    for c, m in avail:
        asr, exp, tol = got.get(m), expect[c], tol_for(key, c)
        ok = asr is not None and abs(asr - exp) <= tol
        results.append((key, c, "ok" if ok else "FAIL", asr, exp))


DEFENSE_NEEDS = {"at": ["at_resnet50"],
                 "hgd": ["hgd_resnet152", "hgd_inception_resnet_v2", "hgd_inception_v3",
                         "hgd_resnext101_32x4d"],
                 "rs": ["rs_resnet50_sigma050"], "nrp": ["nrp"], "diffpure": ["diffpure_unet"]}


def defense_cells(args, key, out_dir, is_targeted, expect, results):
    """The AT/HGD/RS/NRP/DiffPure columns through the defense CLI."""
    for d in DEFENSE_COLS:
        if not all(npz_present(n) for n in DEFENSE_NEEDS[d]):
            results.append((key, d, "SKIP", None, expect[d]))
            continue
        purified = os.path.join(args.out_root, "purified", key)
        cmd = [sys.executable, "-m", "transferattack_torch.defense.run", "--defense", d,
               "--input_dir", args.input_dir, "--output_dir", out_dir,
               "--batchsize", str(args.batchsize), "--device", args.device]
        if is_targeted:
            cmd.append("--targeted")
        if d == "nrp":
            cmd += ["--dynamic", "--purified_dir", purified]
        proc = run(cmd, args.out_root, check=True, capture_output=True, text=True)
        asr = None
        if d == "nrp":  # purify, then eval on the white-box surrogate
            surrogate = surrogate_for(key)[0].split(",")[0]
            if not npz_present(surrogate):
                results.append((key, d, "SKIP", None, expect[d]))
                continue
            ev = port_cli("--eval", "--input_dir", args.input_dir, "--output_dir", purified,
                          "--attack", key, "--eval_models", surrogate,
                          "--batchsize", str(args.batchsize), "--device", args.device)
            if is_targeted:
                ev.append("--targeted")
            run(ev, args.out_root, check=True)
            asr = eval_records(args, purified).get(surrogate)
        else:
            m = re.search(r"ASR:\s*([\d.]+)%", proc.stdout or "")
            asr = float(m.group(1)) if m else None
        exp, tol = expect[d], tol_for(key, d)
        ok = asr is not None and abs(asr - exp) <= tol
        results.append((key, d, "ok" if ok else "FAIL", asr, exp))


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="the BASELINE.md ASR gate through the port")
    p.add_argument("--input_dir", default="./data")
    p.add_argument("--out_root", default="./adv_data_gate")
    p.add_argument("--rows", default="all",
                   help="'all' | 'untargeted' | 'targeted' | comma list")
    p.add_argument("--columns", default="all", choices=["cnn", "models", "all"])
    p.add_argument("--defenses", action="store_true",
                   help="also score the 5 defense columns (slow: RS is N=1000 noisy "
                        "forwards an image)")
    p.add_argument("--batchsize", default=32, type=int)
    p.add_argument("--checkpoint_every", default=50, type=int,
                   help="resume granularity of the T=300 targeted rows")
    p.add_argument("--device", default="cuda", type=str)
    return p


def select_rows(table: dict, rows: str) -> list:
    if rows == "all":
        return list(table)
    if rows in ("untargeted", "targeted"):
        want = rows == "targeted"
        return [k for k, v in table.items() if v["targeted"] is want]
    return [k for k in rows.split(",") if k in table]


def main(argv: Optional[List[str]] = None) -> int:
    args = get_parser().parse_args(argv)
    args.input_dir, args.out_root = os.path.abspath(args.input_dir), os.path.abspath(args.out_root)
    os.makedirs(args.out_root, exist_ok=True)
    table = parse_baseline_tables()
    selected = select_rows(table, args.rows)
    cols = MODEL_COLS[:4] if args.columns == "cnn" else MODEL_COLS
    print(f"ASR gate: {len(selected)} rows x {len(cols) + (5 if args.defenses else 0)}"
          f" columns (of {len(table)} rows in BASELINE.md), weights from {weights_root()}")

    results = []  # (attack, column, status, got, expected)
    for key in selected:
        row = table[key]
        surrogate, is_ens = surrogate_for(key)
        if not all(npz_present(s) for s in surrogate.split(",")):
            results += [(key, c, "SKIP", None, row["expect"][c]) for c, _ in cols]
            continue
        out_dir = os.path.join(args.out_root, key)
        cmd = port_cli("--input_dir", args.input_dir, "--output_dir", out_dir, "--attack", key,
                       "--model", surrogate, "--batchsize", str(args.batchsize),
                       "--device", args.device)
        if is_ens:
            cmd.append("--ensemble")
        if row["targeted"]:
            cmd += ["--targeted", "--skip_existing",
                    "--checkpoint_every", str(args.checkpoint_every)]
        run(cmd, args.out_root, check=True)
        fb = attack_fallbacks(out_dir)
        if fb:
            print(f"SKIP(fallback) {key}: attack ran on fallback weights {fb}")
            results += [(key, c, "SKIP", None, row["expect"][c]) for c, _ in cols]
            continue
        eval_models_cells(args, key, out_dir, row["targeted"], row["expect"], results)
        if args.defenses:
            defense_cells(args, key, out_dir, row["targeted"], row["expect"], results)

    failures = [r for r in results if r[2] == "FAIL"]
    skips = [r for r in results if r[2] == "SKIP"]
    for key, col, status, got, exp in results:
        print(f"[{status:4s}] {key:16s} {col:14s} got={got} expected={exp}±{tol_for(key, col)}")
    print(f"ASR gate: {len(results) - len(failures) - len(skips)} ok, {len(failures)} FAIL, "
          f"{len(skips)} SKIP ({len(selected)} rows selected)")
    if failures:
        return 1
    if skips and len(skips) == len(results):
        print("SKIP: no converted weights present in $TA_TPU_WEIGHTS_DIR "
              "(see `python -m transferattack_torch.utils.convert --list`).")
    return 0


if __name__ == "__main__":
    sys.exit(main())
