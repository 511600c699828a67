"""TGA load/save: 24/32-bit truecolor, optional RLE; the port's copy of
``tinsel_tpu/io/tga.py`` (NumPy on the host)."""

from __future__ import annotations

import struct

import numpy as np

_HDR = struct.Struct("<BBBHHBHHHHBB")


def load_tga(path: str) -> np.ndarray:
    """Returns (H, W, C) uint8, rows top-down, channels RGB(A)."""
    with open(path, "rb") as f:
        data = f.read()
    (
        identsize, cmap_type, image_type, _cm_start, _cm_len, _cm_bits,
        _xs, _ys, w, h, bits, descriptor,
    ) = _HDR.unpack_from(data, 0)
    nch = bits // 8
    if cmap_type != 0 or image_type not in (2, 10) or nch not in (3, 4):
        raise ValueError(f"{path}: unsupported TGA (colormap {cmap_type}, "
                         f"type {image_type}, {bits} bits)")
    pos = _HDR.size + identsize

    if image_type == 2:
        px = np.frombuffer(data[pos : pos + w * h * nch], np.uint8).reshape(
            h, w, nch
        ).copy()
    else:  # RLE: a packet header, then one pixel (run) or count pixels (raw)
        out = np.empty((h * w, nch), np.uint8)
        i = 0
        while i < h * w:
            packet = data[pos]
            pos += 1
            count = (packet & 0x7F) + 1
            if packet & 0x80:
                out[i : i + count] = np.frombuffer(data[pos : pos + nch], np.uint8)
                pos += nch
            else:
                out[i : i + count] = np.frombuffer(
                    data[pos : pos + count * nch], np.uint8
                ).reshape(count, nch)
                pos += count * nch
            i += count
        px = out.reshape(h, w, nch)

    px = px[..., [2, 1, 0] + ([3] if nch == 4 else [])]  # BGR(A) -> RGB(A)
    if not (descriptor & 0x20):  # bit 5 clear: rows stored bottom-up
        px = px[::-1]
    return np.ascontiguousarray(px)


def save_tga(path: str, img: np.ndarray):
    """img: (H, W, 3|4) uint8 (or float in [0,1]); writes top-down, no RLE."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    h, w, nch = img.shape
    if nch not in (3, 4):
        raise ValueError(f"expected 3 or 4 channels, got {nch}")
    bgr = img[..., [2, 1, 0] + ([3] if nch == 4 else [])]
    hdr = _HDR.pack(0, 0, 2, 0, 0, 0, 0, 0, w, h, nch * 8, 0x20)
    with open(path, "wb") as f:
        f.write(hdr)
        f.write(np.ascontiguousarray(bgr).tobytes())
