"""Host-side data pipeline (counterpart of ``transferattack_tpu/utils/data.py``).

The same interface and arrays: images are decoded on the host into NHWC
float32 ``[0, 1]`` numpy batches, labels come from ``labels.csv``.  PNG
decode, PIL's bilinear resize and PNG encode are the port's own
(:mod:`transferattack_torch.utils.png`), so no PIL is needed.
"""
from __future__ import annotations

import csv
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .png import read_png, resize_bilinear, write_png


def _read_labels(path: str) -> Tuple[List[str], np.ndarray, Optional[np.ndarray]]:
    """Parse ``labels.csv`` with columns ``filename,label[,targeted_label]``.

    The CSV stores 1-indexed classes (the reference loader's convention); the
    loader subtracts 1.
    """
    names: List[str] = []
    labels: List[int] = []
    tlabels: List[int] = []
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        has_target = len(header) >= 3
        for row in reader:
            if not row:
                continue
            names.append(row[0])
            labels.append(int(row[1]) - 1)
            if has_target:
                tlabels.append(int(row[2]) - 1)
    t = np.asarray(tlabels, np.int32) if has_target else None
    return names, np.asarray(labels, np.int32), t


def load_image(path: str, size: Tuple[int, int] = (224, 224)) -> np.ndarray:
    """A PNG as (H, W, 3) float32 in [0, 1], resized to ``size`` (rows,
    columns) as PIL's bilinear ``resize`` does."""
    img = read_png(path)
    if img.shape[:2] != tuple(size):
        img = resize_bilinear(img, size)
    return img.astype(np.float32) / 255.0


class AdvDataset:
    """The 1000-image benchmark set (JAX ``AdvDataset``).

    ``targeted=True`` uses the third CSV column (or ``target_class``, which
    overrides every label).  ``eval_mode=True`` reads adversarial PNGs from
    ``output_dir`` while labels come from ``input_dir``.
    """

    def __init__(
        self,
        input_dir: str,
        output_dir: str = "",
        targeted: bool = False,
        target_class: Optional[int] = None,
        eval_mode: bool = False,
        size: Tuple[int, int] = (224, 224),
    ):
        self.input_dir = input_dir
        self.image_dir = output_dir if eval_mode else os.path.join(input_dir, "images")
        self.size = size
        names, labels, tlabels = _read_labels(os.path.join(input_dir, "labels.csv"))
        self.names = names
        if targeted:
            if target_class is not None:
                self.labels = np.full(len(names), target_class, np.int32)
            else:
                if tlabels is None:
                    raise ValueError("targeted run needs a targeted_label CSV column")
                # (label, target) pairs, as the reference keeps them
                self.labels = np.stack([labels, tlabels], axis=1)
        else:
            self.labels = labels
        self.orig_labels = labels

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, i: int):
        x = load_image(os.path.join(self.image_dir, self.names[i]), self.size)
        return x, self.labels[i], self.names[i]

    def as_batches(
        self, batch_size: int
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, List[str]]]:
        for start in range(0, len(self), batch_size):
            idx = range(start, min(start + batch_size, len(self)))
            xs = np.stack([self[i][0] for i in idx])
            ys = np.stack([self.labels[i] for i in idx])
            yield xs, ys, [self.names[i] for i in idx]


def save_images(output_dir: str, images: np.ndarray, names: List[str]) -> None:
    """Write uint8 PNGs. ``images``: NHWC in [0, 1]; every name ends in .png."""
    os.makedirs(output_dir, exist_ok=True)
    arr = np.clip(np.round(np.asarray(images) * 255.0), 0, 255).astype(np.uint8)
    for img, name in zip(arr, names):
        if not name.lower().endswith(".png"):
            raise ValueError(f"{name}: the port writes PNG only; name the file .png")
        write_png(os.path.join(output_dir, name), img)
