"""PNG writer with triangular-dither quantization, and a minimal reader; the
port's copy of ``tinsel_tpu/io/png.py`` (NumPy and the standard library).

One zlib-compressed IDAT with filter 0 on every row. Quantization adds
triangular dither (rand + rand - 0.5) before rounding, drawn from
``np.random.default_rng(0)`` on float64 exactly as the JAX package does, so
both packages write the same bytes for the same float image.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ..utils.profiling import traced


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def quantize_dithered(img: np.ndarray, rng: np.random.Generator | None = None):
    """Float [0,1] image -> uint8 with triangular dither."""
    rng = rng or np.random.default_rng(0)
    tri = rng.random(img.shape) + rng.random(img.shape) - 0.5
    q = np.clip(img * 255.0 + tri, 0.0, 255.0)
    return q.astype(np.uint8)


@traced("app.png")
def encode_png(img: np.ndarray, dither: bool = True) -> bytes:
    """img: (H, W, 3) or (H, W, 4) float in [0,1] or uint8, or (H, W)
    gray -> PNG bytes. A host array: copy a device tensor to the host
    first."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = quantize_dithered(img.astype(np.float64)) if dither else np.clip(
            img * 255.0, 0, 255
        ).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    h, w, c = img.shape
    if c not in (3, 4):
        raise ValueError(f"expected 3 or 4 channels, got {c}")
    color_type = 2 if c == 3 else 6

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    rows = np.zeros((h, 1 + w * c), np.uint8)  # filter byte 0, then the row
    rows[:, 1:] = img.reshape(h, w * c)
    out = b"\x89PNG\r\n\x1a\n"
    out += _chunk(b"IHDR", ihdr)
    out += _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
    out += _chunk(b"IEND", b"")
    return out


def write_png(path: str, img: np.ndarray, dither: bool = True):
    """img: (H, W, 3) or (H, W, 4) float in [0,1] or uint8."""
    with open(path, "wb") as f:
        f.write(encode_png(img, dither))


def _unfilter(ft: int, line, prev, nch: int):
    """One scanline through PNG filter ``ft`` (0 none, 1 sub, 2 up,
    3 average, 4 Paeth), int32 in and out."""
    stride = len(line)
    if ft == 0:
        return line
    if ft == 2:
        return (line + prev) & 0xFF
    cur = line.copy()
    if ft == 1:
        for i in range(nch, stride):
            cur[i] = (cur[i] + cur[i - nch]) & 0xFF
    elif ft == 3:
        for i in range(stride):
            left = cur[i - nch] if i >= nch else 0
            cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
    elif ft == 4:
        for i in range(stride):
            a = cur[i - nch] if i >= nch else 0
            b = prev[i]
            cc = prev[i - nch] if i >= nch else 0
            p = a + b - cc
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
            pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
            cur[i] = (cur[i] + pr) & 0xFF
    else:
        raise ValueError(f"bad filter {ft}")
    return cur


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader (8-bit, color types 0/2/6, no interlace) -> uint8
    array (H, W, C). For tests and tooling round-trips."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    idat = b""
    w = h = ctype = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bitdepth, ctype, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload
            )
            if bitdepth != 8 or interlace != 0 or ctype not in (0, 2, 6):
                raise ValueError(f"{path}: unsupported PNG (depth {bitdepth}, "
                                 f"color type {ctype}, interlace {interlace})")
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    raw = zlib.decompress(idat)
    nch = {0: 1, 2: 3, 6: 4}[ctype]
    stride = w * nch
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(h):
        line = np.frombuffer(raw[pos + 1 : pos + 1 + stride], np.uint8).astype(np.int32)
        cur = _unfilter(raw[pos], line, prev, nch)
        pos += 1 + stride
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out.reshape(h, w, nch)
