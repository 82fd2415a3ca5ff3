"""Defense output scoring (counterpart of ``transferattack_tpu/defense/scoring.py``;
the reference's ``defense/check_output.py:28-48``).

Defenses write a ``filename,label`` CSV of predictions.  The attack success
rate compares it with the ground-truth ``labels.csv`` under the reference's
off-by-one: ground-truth CSVs are 1-indexed, prediction CSVs 0-indexed, so
``start=1``.  Targeted runs read the ground truth's third column, and a
missing prediction counts as wrong.  Those three are pure Python, kept here
so that the port imports nothing of the JAX package.  :func:`classify_dir`
is the defenses' shared loop from adversarial PNGs to a prediction CSV.
"""
from __future__ import annotations

import csv
import os
from typing import Callable, Dict

import torch

from ..utils.data import AdvDataset


def load_label_csv(path: str, column: int = 1) -> Dict[str, int]:
    """``{filename: int(row[column])}`` of a CSV with a header row."""
    out = {}
    with open(path, newline="") as f:
        reader = csv.reader(f)
        next(reader)  # the header
        for row in reader:
            if row:
                out[row[0]] = int(row[column])
    return out


def write_label_csv(path: str, preds: Dict[str, int]) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["filename", "label"])
        for name, lbl in preds.items():
            w.writerow([name, int(lbl)])


def asr_from_labels(label_file: str, output_file: str, targeted: bool = False,
                    start: int = 1) -> float:
    """ASR in percent of the prediction CSV ``output_file`` against the
    ground truth ``label_file`` (``check_output.py:32-48``)."""
    f2l = load_label_csv(label_file, column=2 if targeted else 1)
    check = load_label_csv(output_file)
    wrong = sum(1 for k in f2l if int(f2l[k]) - start != int(check.get(k, -10**9)))
    n = max(len(f2l), 1)
    if not targeted:
        return wrong / n * 100.0
    return 100.0 - wrong / n * 100.0


def classify_dir(classify: Callable[[torch.Tensor], torch.Tensor], input_dir: str,
                 output_dir: str, batchsize: int, out_csv: str, device) -> str:
    """Predict every adversarial PNG of ``output_dir`` (labels from
    ``input_dir``) with ``classify`` (an NHWC batch on ``device`` → its
    labels), batch by batch, and write ``output_dir/out_csv``."""
    ds = AdvDataset(input_dir=input_dir, output_dir=output_dir, eval_mode=True)
    preds = {}
    with torch.inference_mode():
        for xs, _, names in ds.as_batches(batchsize):
            labels = classify(torch.from_numpy(xs).to(device)).cpu().tolist()
            preds.update(zip(names, labels))
    path = os.path.join(output_dir, out_csv)
    write_label_csv(path, preds)
    return path
