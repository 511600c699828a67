"""PNG writer with triangular-dither quantization; the
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
