"""RS, randomized smoothing (counterpart of ``transferattack_tpu/defense/rs.py``;
the reference's ``defense/rs/core.py:8-112`` and ``defense/rs/predict.py``).

``Smooth.predict`` votes over N draws of N(0, σ²) input noise and abstains
(−1) where a two-sided binomial test cannot tell the top two counts apart;
``certify`` selects a class with ``max(n0, chunk)`` draws and bounds its
probability with ``n`` more (Clopper–Pearson), giving an L2 radius.  Votes
are counted ``chunk`` draws at a time, ``max(n // chunk, 1)`` chunks, as JAX
counts them (so an ``n`` that is not a multiple of ``chunk`` draws fewer):
each chunk is one forward of chunk·B images, and only the counts go to the
host.  Noise comes from a ``torch.Generator`` on the device (one seeded
``seed`` a run, drawn from once a batch, as JAX splits a key a batch), or
from ``noises``: one standard-normal array (chunk, B, H, W, C) a chunk, in
the order the chunks are counted (the tests hand JAX's draws over there).
"""
from __future__ import annotations

import warnings
from typing import Optional, Sequence

import numpy as np
import torch
from scipy.stats import beta, binomtest, norm

from ..attack import draw
from ..models import Surrogate, aux_path, load_npz, make_model, record_fallback, \
    resolve_device, weights_root
from ..utils.bridge import load_flat_variables
from .scoring import classify_dir


class Smooth:
    """The smoothed classifier of ``surrogate``.  Official arguments
    (``predict.py``): σ 0.50, N 1000, α 0.001."""

    ABSTAIN = -1

    def __init__(self, surrogate: Surrogate, num_classes: int = 1000, sigma: float = 0.5):
        self.model = surrogate
        self.num_classes = num_classes
        self.sigma = float(sigma)

    def _count_votes(self, x, generator: Optional[torch.Generator], n: int, chunk: int = 50,
                     noises: Optional[Sequence] = None) -> np.ndarray:
        """(B, num_classes) vote counts over ``max(n // chunk, 1)`` chunks
        of ``chunk`` noise draws, as float32 (JAX's one-hot sums)."""
        classes = torch.arange(self.num_classes, device=x.device)
        counts = torch.zeros((x.shape[0], self.num_classes), dtype=torch.int64, device=x.device)
        with torch.inference_mode():
            for i in range(max(n // chunk, 1)):
                shape = (chunk,) + tuple(x.shape)
                z = (draw(generator, torch.randn, shape, device=x.device) if noises is None
                     else torch.as_tensor(noises[i], dtype=torch.float32, device=x.device))
                pts = torch.clamp(x[None] + z * self.sigma, 0.0, 1.0)
                logits = self.model.apply(pts.reshape((-1,) + tuple(x.shape[1:])))
                preds = logits.reshape(chunk, x.shape[0], -1).argmax(-1)
                counts += (preds[..., None] == classes).sum(0)
        return counts.cpu().numpy().astype(np.float32)

    def _inputs(self, x, generator):
        device = next(self.model.module.parameters()).device
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        return x, generator

    def certify(self, x, generator: Optional[torch.Generator] = None, n0: int = 100,
                n: int = 1000, alpha: float = 0.001, chunk: int = 50,
                noises: Optional[Sequence] = None):
        """(predictions, L2 radii) an image (``core.py:18-52``): the top class
        of ``max(n0, chunk)`` draws, its probability bounded below with ``n``
        draws, radius σ·Φ⁻¹(p̲); abstain (radius 0) below 0.5.  ``noises``:
        the selection's chunks, then the estimate's."""
        x, generator = self._inputs(x, generator)
        n_sel = max(n0, chunk)
        k = max(n_sel // chunk, 1)
        sel = self._count_votes(x, generator, n_sel, chunk, None if noises is None else noises[:k])
        est = self._count_votes(x, generator, n, chunk, None if noises is None else noises[k:])
        preds, radii = [], []
        for c_sel, c_est in zip(sel, est):
            c_a = int(c_sel.argmax())
            n_a = int(c_est[c_a])
            total = int(c_est.sum())
            p_lower = beta.ppf(alpha, n_a, total - n_a + 1) if n_a > 0 else 0.0
            if p_lower < 0.5:
                preds.append(self.ABSTAIN)
                radii.append(0.0)
            else:
                preds.append(c_a)
                radii.append(float(self.sigma * norm.ppf(p_lower)))
        return np.asarray(preds), np.asarray(radii)

    def predict(self, x, generator: Optional[torch.Generator] = None, n: int = 1000,
                alpha: float = 0.001, chunk: int = 50,
                noises: Optional[Sequence] = None) -> np.ndarray:
        """The smoothed prediction of each image, or −1 (``core.py:53+``)."""
        x, generator = self._inputs(x, generator)
        preds = []
        for c in self._count_votes(x, generator, n, chunk, noises):
            top2 = c.argsort()[::-1][:2]
            n1, n2 = int(c[top2[0]]), int(c[top2[1]])
            preds.append(self.ABSTAIN if binomtest(n1, n1 + n2, 0.5).pvalue > alpha
                         else int(top2[0]))
        return np.asarray(preds)


def run_rs(input_dir: str, output_dir: str, batchsize: int = 16, sigma: float = 0.5,
           n: int = 1000, alpha: float = 0.001, model_name: str = "resnet50",
           ckpt: str = "rs_resnet50_noise050", out_csv: str = "rs_predictions.csv",
           seed: int = 0, device="cuda") -> str:
    """Classify the adversarial PNGs with the smoothed classifier and write
    the prediction CSV; returns its path.  A missing checkpoint is recorded
    as ``rs_resnet50_sigma050``, as JAX records it."""
    dev = resolve_device(device)
    surrogate = make_model(model_name, device=dev)
    path = aux_path(ckpt)
    if path is not None:
        load_flat_variables(surrogate.module, load_npz(path))
    else:
        record_fallback("rs_resnet50_sigma050")
        warnings.warn(f"RS: noise-trained {ckpt}.npz not found under {weights_root()}; "
                      "base weights used.")
    smooth = Smooth(surrogate, sigma=sigma)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return classify_dir(
        lambda x: torch.from_numpy(smooth.predict(x, gen, n=n, alpha=alpha)),
        input_dir, output_dir, batchsize, out_csv, dev)
