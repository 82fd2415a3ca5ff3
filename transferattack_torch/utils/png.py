"""PNG read and write, and PIL's bilinear and bicubic resizes, in the standard library and numpy.

The JAX package reads and writes images with PIL (``utils/data.py``); the
card's machine has no PIL, so the port carries what the data path needs:

* :func:`decode_png`: 8-bit, non-interlaced PNGs of colour type gray, gray +
  alpha, RGB, RGBA or palette, converted to RGB as PIL's ``convert("RGB")``
  does (alpha dropped, palette looked up, gray copied to three channels).
  Anything else (not a PNG, another bit depth, Adam7 interlace, a damaged
  file) raises ``ValueError`` naming the file and the reason.
* :func:`encode_png`: an RGB PNG with filter 0 (None) on every row.
* :func:`resize_bilinear`, :func:`resize_bicubic`: PIL's ``Image.resize``
  with ``Image.BILINEAR`` or ``Image.BICUBIC`` (its default for RGB) on
  uint8 images, bit for bit: its two-pass fixed-point resample (22
  precision bits, a horizontal pass, a clip to uint8, then a vertical pass,
  and a support scaled by ``max(in/out, 1)`` when shrinking).
"""
from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel (PNG spec, table 11.1)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PRECISION_BITS = 32 - 8 - 2  # PIL's Resample.c


def _chunks(data: bytes, name: str):
    """``(type, payload)`` of every chunk up to ``IEND``, CRCs checked."""
    pos = len(SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{name}: truncated PNG (no IEND chunk)")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"{name}: truncated PNG chunk {ctype!r}")
        payload = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(ctype + payload) != crc:
            raise ValueError(f"{name}: bad CRC in PNG chunk {ctype!r}")
        yield ctype, payload
        if ctype == b"IEND":
            return
        pos = end + 4


def _unfilter(raw: np.ndarray, height: int, width: int, channels: int) -> np.ndarray:
    """Undo the per-row filters of 8-bit samples: ``raw`` is (H, 1 + W·C) with
    the filter type first.  Returns (H, W, C) uint8."""
    ftype, rows = raw[:, 0], raw[:, 1:].reshape(height, width, channels)
    if ftype.max() > 4:
        raise ValueError(f"PNG filter type {int(ftype.max())} is not 0-4")
    if not np.isin(ftype, (3, 4)).any():
        # None, Sub and Up: a row needs only the row above, and Sub is a
        # running sum along the row, modulo 256
        out = np.empty_like(rows)
        prev = np.zeros_like(rows[0])
        for r in range(height):
            t = ftype[r]
            if t == 0:
                out[r] = rows[r]
            elif t == 1:
                out[r] = np.cumsum(rows[r], axis=0, dtype=np.uint8)
            else:
                out[r] = rows[r] + prev
            prev = out[r]
        return out
    # Average and Paeth read the left, upper and upper-left neighbours of a
    # pixel, so the pixels of one anti-diagonal r + c = d are independent:
    # sweep the diagonals, each vectorised over its rows.  Pixels live in a
    # flat (row-major) copy with a zero border row and column in front
    w1 = width + 1
    out = np.zeros(((height + 1) * w1, channels), np.int16)
    samples = rows.reshape(-1, channels).astype(np.int16)
    ftype = ftype.astype(np.int16)
    for d in range(height + width - 1):
        r = np.arange(max(0, d - width + 1), min(height - 1, d) + 1)
        c = d - r
        here = (r + 1) * w1 + c + 1
        a, b, ul = out[here - 1], out[here - w1], out[here - w1 - 1]
        # Paeth: |p - a|, |p - b|, |p - ul| for p = a + b - ul
        pa, pb, pc = np.abs(b - ul), np.abs(a - ul), np.abs(a + b - 2 * ul)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
        t = ftype[r]
        if (t != 4).any():
            t = t[:, None]
            pred = np.where(t == 4, pred, np.where(
                t == 3, (a + b) >> 1, np.where(t == 2, b, np.where(t == 1, a, 0))))
        out[here] = (samples[r * width + c] + pred) & 255
    return out.reshape(height + 1, w1, channels)[1:, 1:].astype(np.uint8)


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """An 8-bit PNG as an (H, W, 3) uint8 RGB array (see the module doc)."""
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{name}: not a PNG file (only PNG is supported)")
    header, palette, idat = None, None, []
    for ctype, payload in _chunks(data, name):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{name}: PNG has no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"{name}: PNG colour type {ctype} does not exist")
    if depth != 8:
        raise ValueError(f"{name}: PNG bit depth {depth} is not supported (only 8)")
    if interlace:
        raise ValueError(f"{name}: interlaced (Adam7) PNG is not supported")
    if ctype == 3 and palette is None:
        raise ValueError(f"{name}: palette PNG has no PLTE chunk")
    channels = _CHANNELS[ctype]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{name}: PNG image data does not inflate: {e}") from None
    if len(raw) != height * (1 + width * channels):
        raise ValueError(f"{name}: PNG image data holds {len(raw)} bytes, "
                         f"expected {height * (1 + width * channels)}")
    try:
        px = _unfilter(np.frombuffer(raw, np.uint8).reshape(height, -1),
                       height, width, channels)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    if ctype == 3:
        if px.max() >= len(palette):
            raise ValueError(f"{name}: palette index {int(px.max())} beyond the "
                             f"{len(palette)} PLTE entries")
        return palette[px[..., 0]]
    if ctype in (0, 4):  # gray, gray + alpha
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])  # RGB, RGBA


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def encode_png(img: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 array as an 8-bit RGB PNG, filter 0 on every row."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, got {img.shape} {img.dtype}")
    h, w, _ = img.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = img.reshape(h, 3 * w)
    return (SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _bilinear(x: np.ndarray) -> np.ndarray:
    """PIL's ``bilinear_filter`` (support 1)."""
    return np.maximum(1.0 - np.abs(x), 0.0)


def _bicubic(x: np.ndarray) -> np.ndarray:
    """PIL's ``bicubic_filter`` (a = -0.5, support 2), its products in C's order."""
    x = np.abs(x)
    a = -0.5
    near = (((a + 2.0) * x - (a + 3.0)) * x) * x + 1.0
    far = (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coeffs(in_size: int, out_size: int, filt, support: float) -> Tuple[np.ndarray, np.ndarray]:
    """PIL's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for a filter
    of the given support: per output pixel, the first input index and the
    fixed-point weights of its window, as (out, k) int64 arrays (input
    indices clipped; weights past the window are 0)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates toward 0; a negative xmin is clipped to 0 anyway
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    x = np.arange(ksize)
    # PIL multiplies by the reciprocal, which rounds unlike a division
    w = filt((x[None] + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(x[None] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for k in range(ksize):  # PIL's running sum, in its order
        ww = ww + w[:, k]
    ww = ww[:, None]
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    # C's (int) of w·2^22 ± 0.5: rounded half away from zero (bicubic
    # weights can be negative)
    fixed = np.trunc(w * (1 << _PRECISION_BITS) + np.where(w < 0, -0.5, 0.5)).astype(np.int64)
    idx = np.minimum(xmin[:, None] + x[None], in_size - 1)
    return idx, fixed


def _resample_axis(img: np.ndarray, out_size: int, axis: int, filt,
                   support: float) -> np.ndarray:
    """One pass of PIL's resample along ``axis`` of a uint8 array, as one
    float64 matrix product: every product and partial sum is an integer
    below 2**31 in magnitude (bicubic's negative weights included: their
    absolute sum stays under 1.25·2**22), so the sum is exact in any order,
    as PIL's int32 one is.  PIL's ``clip8`` then takes the sum's floor over
    2**22 and clips it to [0, 255], a negative sum to 0."""
    idx, w = _coeffs(img.shape[axis], out_size, filt, support)
    dense = np.zeros((out_size, img.shape[axis]))
    np.add.at(dense, (np.arange(out_size)[:, None], idx), w)
    src = np.moveaxis(img, axis, 0).astype(np.float64)
    acc = np.tensordot(dense, src, axes=(1, 0)) + (1 << (_PRECISION_BITS - 1))
    out = np.clip(np.floor(acc / (1 << _PRECISION_BITS)), 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _resize(img: np.ndarray, size: Tuple[int, int], filt, support: float) -> np.ndarray:
    out_h, out_w = size
    if img.shape[1] != out_w:
        img = _resample_axis(img, out_w, 1, filt, support)
    if img.shape[0] != out_h:
        img = _resample_axis(img, out_h, 0, filt, support)
    return img


def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``Image.fromarray(img).resize((size[1], size[0]), Image.BILINEAR)`` for
    an (H, W, C) uint8 array: ``size`` is (rows, columns)."""
    return _resize(img, size, _bilinear, 1.0)


def resize_bicubic(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``Image.fromarray(img).resize((size[1], size[0]))`` for an RGB (H, W,
    C) uint8 array: PIL's default filter for RGB, ``Image.BICUBIC``."""
    return _resize(img, size, _bicubic, 2.0)
