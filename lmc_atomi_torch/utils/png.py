"""Minimal pure-NumPy PNG reader (counterpart of
``lmc_atomi_tpu/utils/png.py``, copied: the port imports nothing of the JAX
package). No skimage or PIL is needed.

Supports the common still-image subset: 8-bit grayscale (colortype 0), RGB
(2), palette-less gray+alpha (4) and RGBA (6), non-interlaced, all five
scanline filters. Enough to load the reference's natural test image
``einstein.png`` (reference prox_lmc_deconv.py:44-46 reads it with
``skimage.io.imread``) and matplotlib-written PNGs in tests.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["read_png", "read_png_gray"]

_SIG = b"\x89PNG\r\n\x1a\n"


def _paeth(a, b, c):
    p = int(a) + int(b) - int(c)
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file to a uint8 array of shape (h, w) or (h, w, c)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(data):
        ln, typ = struct.unpack(">I4s", data[pos : pos + 8])
        chunk = data[pos + 8 : pos + 8 + ln]
        if typ == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", chunk)
        elif typ == b"IDAT":
            idat.append(chunk)
        elif typ == b"IEND":
            break
        pos += 12 + ln
    if hdr is None:
        raise ValueError(f"{path}: missing IHDR")
    w, h, depth, ctype, comp, filt, interlace = hdr
    if depth != 8 or interlace != 0 or comp != 0 or filt != 0:
        raise NotImplementedError(
            f"{path}: only 8-bit non-interlaced PNGs supported "
            f"(depth={depth}, interlace={interlace})"
        )
    channels = {0: 1, 2: 3, 4: 2, 6: 4}.get(ctype)
    if channels is None:
        raise NotImplementedError(f"{path}: colortype {ctype} (palette?)")

    raw = zlib.decompress(b"".join(idat))
    stride = w * channels
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{path}: bad decompressed size")
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    bpp = channels
    for y in range(h):
        f = raw[y * (stride + 1)]
        line = np.frombuffer(
            raw, np.uint8, stride, y * (stride + 1) + 1
        ).astype(np.int32)
        if f == 0:  # None
            rec = line
        elif f == 1:  # Sub: prefix sums within each byte lane mod 256
            rec = line.copy()
            # cumulative sum per channel offset, sequential in x
            for off in range(bpp):
                rec[off::bpp] = np.cumsum(rec[off::bpp]) & 0xFF
        elif f == 2:  # Up
            rec = (line + prev) & 0xFF
        elif f == 3:  # Average
            rec = line.copy()
            for x in range(stride):
                left = rec[x - bpp] if x >= bpp else 0
                rec[x] = (rec[x] + ((left + prev[x]) >> 1)) & 0xFF
        elif f == 4:  # Paeth
            rec = line.copy()
            for x in range(stride):
                left = rec[x - bpp] if x >= bpp else 0
                ul = prev[x - bpp] if x >= bpp else 0
                rec[x] = (rec[x] + _paeth(left, prev[x], ul)) & 0xFF
        else:
            raise ValueError(f"{path}: unknown filter {f} on line {y}")
        out[y] = rec.astype(np.uint8)
        prev = rec
    img = out.reshape(h, w, channels)
    return img[..., 0] if channels == 1 else img


def read_png_gray(path: str) -> np.ndarray:
    """Decode to float32 grayscale in [0, 255] (Rec.601 luma for color)."""
    img = read_png(path).astype(np.float32)
    if img.ndim == 2:
        return img
    if img.shape[-1] == 2:  # gray + alpha
        return img[..., 0]
    rgb = img[..., :3]
    return rgb @ np.asarray([0.299, 0.587, 0.114], np.float32)
