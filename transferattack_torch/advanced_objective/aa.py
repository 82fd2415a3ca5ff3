"""AA, activation attack (counterpart of ``advanced_objective/aa.py``).

Targeted: minimize the mid-layer feature distance to an anchor image of
the target class, read from ``input_dir`` through its ``labels.csv``
(1-indexed labels) when the attack is called.
"""
from __future__ import annotations

import csv
import os

import numpy as np
import torch

from ..attack import Attack
from ..utils import img_height, img_width
from ..utils.data import load_image
from . import objective_loop


class AA(Attack):
    """Official args: layer_name='layer2', epoch=300, alpha=2/255,
    targeted."""

    # its ``__call__`` reads the anchor images and labels on the host (JAX's flag)
    host_state = True

    def __init__(self, model_name="resnet50", epoch=300, eps=16 / 255, alpha=2 / 255,
                 decay=1.0, layer_name="layer2", input_dir="./data", targeted=True,
                 random_start=False, norm="linfty", loss="crossentropy",
                 attack="AA", **kwargs):
        super().__init__(model_name, epoch=epoch, eps=eps, alpha=alpha, decay=decay,
                         targeted=targeted, random_start=random_start, norm=norm,
                         loss=loss, attack=attack, **kwargs)
        self.feature_layer = layer_name
        self.input_dir = input_dir
        self._l2f = None
        self._tar_data = None

    def _label_to_file(self):
        if self._l2f is None:
            self._l2f = {}
            with open(os.path.join(self.input_dir, "labels.csv"), newline="") as f:
                reader = csv.reader(f)
                next(reader)
                for row in reader:
                    if row:
                        self._l2f[int(row[1]) - 1] = row[0]  # 1-indexed in the CSV
        return self._l2f

    def _anchor_batch(self, tar_label):
        l2f = self._label_to_file()
        return np.stack([load_image(os.path.join(self.input_dir, "images", l2f[int(t)]),
                                    (img_height, img_width)) for t in tar_label])

    def __call__(self, data, label, generator=None, idx: int = 0):
        pairs = torch.as_tensor(label)
        if pairs.ndim != 2:
            raise ValueError("AA needs (label, target) pairs: a targeted run")
        self._tar_data = torch.from_numpy(self._anchor_batch(pairs[:, 1].tolist())).to(
            self.device)
        return super().__call__(data, label, generator=generator, idx=idx)

    def run(self, x, y, gen):
        with torch.no_grad():
            mid_t = self.model.feature(self._tar_data, self.feature_layer)[1]

        def dist_loss(d, state):
            mid_s = self.model.feature(x + d, self.feature_layer)[1]
            loss = (mid_t - mid_s).reshape(x.shape[0], -1).norm(dim=1).mean()
            return -loss if self.targeted else loss

        return objective_loop(self, x, y, gen, dist_loss, use_momentum=True)
