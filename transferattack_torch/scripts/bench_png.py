"""Time the port's PNG decode on the host, per image.

    python -m transferattack_torch.scripts.bench_png

Eight seeded 299² images in each of two kinds of file, both made here
without PIL: the port's own (filter 0 on every row, as ``save_images``
writes them), and one with the Paeth filter on every row.  Any row filtered with Average or Paeth sends
the decode through its anti-diagonal sweep, whose cost does not depend on
how many rows use them, so the second kind times every PNG that PIL writes
with adaptive filtering.  Prints one JSON line with the median ms per
image of ``decode_png`` and of ``load_image`` (decode plus the resize to
224²).  This is host CPU time; it names the host's CPU count.
"""
from __future__ import annotations

import json
import os
import statistics
import struct
import tempfile
import time
import zlib

import numpy as np

from transferattack_torch.utils import png
from transferattack_torch.utils.data import load_image

SIZE, IMAGES = 299, 8  # of each kind


def paeth_png(img: np.ndarray) -> bytes:
    """``img`` (H, W, 3) uint8 as an RGB PNG with the Paeth filter on every row."""
    h, w, _ = img.shape
    x = np.zeros((h + 1, w + 1, 3), np.int16)
    x[1:, 1:] = img
    a, b, ul = x[1:, :-1], x[:-1, 1:], x[:-1, :-1]
    pa, pb, pc = np.abs(b - ul), np.abs(a - ul), np.abs(a + b - 2 * ul)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
    raw = np.full((h, 1 + 3 * w), 4, np.uint8)
    raw[:, 1:] = ((x[1:, 1:] - pred) & 255).reshape(h, 3 * w)
    return (png.SIGNATURE
            + png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + png._chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + png._chunk(b"IEND", b""))


def decode_ms() -> dict:
    """Median ms per image of each kind."""
    rng = np.random.RandomState(0)
    imgs = (rng.rand(IMAGES, SIZE, SIZE, 3) * 255).astype(np.uint8)
    out = {"size": SIZE, "images": IMAGES, "host_cpus": os.cpu_count()}
    with tempfile.TemporaryDirectory() as tmp:
        for kind, encode in (("filter0", png.encode_png), ("paeth", paeth_png)):
            paths = []
            for i, img in enumerate(imgs):
                paths.append(os.path.join(tmp, f"{kind}_{i}.png"))
                with open(paths[-1], "wb") as f:
                    f.write(encode(img))
            for label, fn in (("decode", png.read_png), ("load_image", load_image)):
                times = []
                for path, img in zip(paths, imgs):
                    t0 = time.perf_counter()
                    got = fn(path)
                    times.append((time.perf_counter() - t0) * 1e3)
                    if label == "decode" and not np.array_equal(got, img):
                        raise RuntimeError(f"{path}: decoded pixels differ")
                out[f"{kind}_{label}_ms"] = statistics.median(times)
    return out


def main() -> None:
    print(json.dumps(decode_ms()))


if __name__ == "__main__":
    main()
