"""HDR image I/O on the host (NumPy): PFM load/save and Radiance .hdr
(RGBE) load/save; the port's copy of ``tinsel_tpu/io/hdr.py``.

PFM little/big-endian grayscale and RGB; the Radiance RGBE decoder reads
flat and new-style RLE scanlines (one Python step per run or literal).
"""

from __future__ import annotations

import numpy as np


# ------------------------------------------------------------------------ PFM


def load_pfm(path: str) -> np.ndarray:
    """Returns (H, W, 3) or (H, W) float32. PFM stores rows bottom-up."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"not a PFM file: {header!r}")
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        dtype = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(w * h * channels * 4), dtype=dtype)
    img = data.reshape(h, w, channels) if channels == 3 else data.reshape(h, w)
    return np.ascontiguousarray(img[::-1]).astype(np.float32)  # flip to top-down


def save_pfm(path: str, img: np.ndarray):
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        header = b"Pf"
        channels = 1
    else:
        assert img.shape[-1] == 3
        header = b"PF"
        channels = 3
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(header + b"\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.000000\n")  # little-endian
        f.write(np.ascontiguousarray(img[::-1]).astype("<f4").tobytes())


# --------------------------------------------------------------- Radiance HDR


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


def save_hdr(path: str, img: np.ndarray):
    """Write flat (non-RLE) RGBE — universally readable."""
    img = np.maximum(np.asarray(img, np.float32), 0.0)
    h, w = img.shape[:2]
    maxc = img.max(axis=-1)
    e = np.zeros((h, w), np.int32)
    nz = maxc > 1e-32
    m, ex = np.frexp(maxc)
    scale = np.where(nz, m * 256.0 / np.maximum(maxc, 1e-32), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, ex + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
