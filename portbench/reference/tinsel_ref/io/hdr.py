"""Radiance .hdr (RGBE) loading on the host (NumPy); the port's copy of
``tinsel_tpu/io/hdr.py``, cut to the loader. The decoder reads flat and
new-style RLE scanlines (one Python step per run or literal).
"""

from __future__ import annotations

import numpy as np


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 RGBE -> (..., 3) float32.

    Reference convention (pfm.cpp:174-180 convertComponent): value =
    mantissa/256 * 2^(e-128), zero when the exponent byte is 0."""
    rgbe = rgbe.astype(np.float32)
    e = rgbe[..., 3]
    scale = np.where(e > 0.0, np.ldexp(1.0, (e - 136.0).astype(np.int32)), 0.0)
    return rgbe[..., :3] * scale[..., None]


def load_hdr(path: str) -> np.ndarray:
    """Radiance .hdr/.pic RGBE -> (H, W, 3) float32 linear radiance."""
    with open(path, "rb") as f:
        magic = f.readline()
        if not (magic.startswith(b"#?RADIANCE") or magic.startswith(b"#?RGBE")):
            raise ValueError("not a Radiance HDR file")
        # header: read until blank line
        while True:
            line = f.readline()
            if line in (b"\n", b"\r\n", b""):
                break
        dims = f.readline().split()
        # standard orientation "-Y H +X W"
        assert dims[0] == b"-Y" and dims[2] == b"+X", dims
        h, w = int(dims[1]), int(dims[3])
        payload = f.read()

    out = np.zeros((h, w, 4), np.uint8)
    pos = 0
    for y in range(h):
        # new-style RLE scanline marker: 2, 2, then width in 2 bytes
        if (
            w >= 8
            and w < 32768
            and payload[pos] == 2
            and payload[pos + 1] == 2
            and ((payload[pos + 2] << 8) | payload[pos + 3]) == w
        ):
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = payload[pos]
                    pos += 1
                    if count > 128:  # run
                        out[y, x : x + count - 128, c] = payload[pos]
                        pos += 1
                        x += count - 128
                    else:  # literal
                        out[y, x : x + count, c] = np.frombuffer(
                            payload[pos : pos + count], np.uint8
                        )
                        pos += count
                        x += count
        else:
            # flat (or old-style RLE, rare) scanline
            row = np.frombuffer(payload[pos : pos + 4 * w], np.uint8).reshape(
                w, 4
            )
            out[y] = row
            pos += 4 * w
    return _rgbe_to_float(out)
