"""The port's PNG and TGA readers and writers against tinsel_tpu's: the
bytes each writer emits and the arrays each reader returns must be equal
exactly (both are NumPy on the host; the PNG dither draws from the same
``default_rng(0)`` stream). The files the readers take are written here:
PNGs with each filter type 0-4 (and all five across the rows of one
image), TGAs raw and RLE, top-down and bottom-up, 24 and 32 bits.
"""

import struct
import zlib

import numpy as np
import pytest

from tinsel_tpu.io import png as jpng
from tinsel_tpu.io import tga as jtga
from tinsel_tpu_torch.io import png as tpng
from tinsel_tpu_torch.io import tga as ttga


def _image(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    # some values outside [0, 1]: the clip is part of the format
    return (rng.random(shape) * 1.2 - 0.1).astype(dtype)


@pytest.mark.parametrize("shape", [(7, 5, 3), (4, 9, 4), (6, 6)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.uint8])
@pytest.mark.parametrize("dither", [True, False])
def test_encode_png_bytes_equal_jax(shape, dtype, dither):
    img = _image(shape, dtype)
    assert tpng.encode_png(img, dither) == jpng.encode_png(img, dither)


def test_quantize_and_write_png_equal_jax(tmp_path):
    img = _image((5, 8, 3), np.float64, seed=3)
    np.testing.assert_array_equal(tpng.quantize_dithered(img), jpng.quantize_dithered(img))
    rng_t, rng_j = np.random.default_rng(7), np.random.default_rng(7)
    np.testing.assert_array_equal(tpng.quantize_dithered(img, rng_t),
                                  jpng.quantize_dithered(img, rng_j))
    tpng.write_png(str(tmp_path / "t.png"), img)
    jpng.write_png(str(tmp_path / "j.png"), img)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_row(ft, cur, prev, nch):
    """PNG filter ``ft`` applied to one scanline (int arrays)."""
    left = np.concatenate([np.zeros(nch, np.int64), cur[:-nch]])
    upleft = np.concatenate([np.zeros(nch, np.int64), prev[:-nch]])
    pred = {0: 0, 1: left, 2: prev, 3: (left + prev) >> 1,
            4: _paeth(left, prev, upleft)}[ft]
    return ((cur - pred) & 0xFF).astype(np.uint8)


def _png_with_filters(path, img, filters):
    """Write ``img`` (H, W, C) uint8 as a PNG whose row y uses filter
    ``filters[y % len(filters)]``, the IDAT split in two chunks."""
    h, w, c = img.shape
    ctype = {1: 0, 3: 2, 4: 6}[c]
    rows = img.reshape(h, w * c).astype(np.int64)
    raw = b""
    prev = np.zeros(w * c, np.int64)
    for y in range(h):
        ft = filters[y % len(filters)]
        raw += bytes([ft]) + _filter_row(ft, rows[y], prev, c).tobytes()
        prev = rows[y]
    z = zlib.compress(raw)

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
    data += chunk(b"IDAT", z[: len(z) // 2]) + chunk(b"IDAT", z[len(z) // 2:]) + chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_read_png_equals_jax_per_filter(tmp_path, filters, channels):
    img = _image((9, 7, channels), np.uint8, seed=len(filters) + channels)
    path = str(tmp_path / "f.png")
    _png_with_filters(path, img, filters)
    got = tpng.read_png(path)
    np.testing.assert_array_equal(got, jpng.read_png(path))
    np.testing.assert_array_equal(got, img)  # the filters undone exactly


def test_read_png_round_trips_encode(tmp_path):
    img = _image((6, 10, 4), np.uint8, seed=11)
    tpng.write_png(str(tmp_path / "r.png"), img)
    np.testing.assert_array_equal(tpng.read_png(str(tmp_path / "r.png")), img)


@pytest.mark.parametrize("shape,dtype", [((5, 7, 3), np.uint8), ((4, 6, 4), np.uint8),
                                         ((3, 8, 3), np.float32)])
def test_save_tga_bytes_equal_jax(tmp_path, shape, dtype):
    img = _image(shape, dtype)
    ttga.save_tga(str(tmp_path / "t.tga"), img)
    jtga.save_tga(str(tmp_path / "j.tga"), img)
    assert (tmp_path / "t.tga").read_bytes() == (tmp_path / "j.tga").read_bytes()


def _rle(pixels):
    """TGA RLE packets of a (N, C) pixel run: runs of equal pixels as run
    packets (up to 128), the rest as raw packets (up to 128)."""
    out = b""
    i, n = 0, len(pixels)
    while i < n:
        j = i
        while j + 1 < n and j - i < 127 and np.array_equal(pixels[j + 1], pixels[i]):
            j += 1
        if j > i:
            out += bytes([0x80 | (j - i)]) + pixels[i].tobytes()
            i = j + 1
            continue
        j = i
        while j + 1 < n and j - i < 127 and not np.array_equal(pixels[j + 1], pixels[j]):
            j += 1
        out += bytes([j - i]) + pixels[i:j + 1].tobytes()
        i = j + 1
    return out


def _tga(path, img, rle: bool, top_down: bool, ident=b""):
    """(H, W, C) uint8 RGB(A) as a TGA: BGR(A) on disk, rows bottom-up
    unless ``top_down``."""
    h, w, c = img.shape
    px = img[..., [2, 1, 0] + ([3] if c == 4 else [])]
    if not top_down:
        px = px[::-1]
    hdr = struct.pack("<BBBHHBHHHHBB", len(ident), 0, 10 if rle else 2, 0, 0, 0, 0, 0,
                      w, h, c * 8, 0x20 if top_down else 0)
    body = _rle(np.ascontiguousarray(px).reshape(h * w, c)) if rle else \
        np.ascontiguousarray(px).tobytes()
    with open(path, "wb") as f:
        f.write(hdr + ident + body)


@pytest.mark.parametrize("rle", [False, True])
@pytest.mark.parametrize("top_down", [False, True])
@pytest.mark.parametrize("channels", [3, 4])
def test_load_tga_equals_jax(tmp_path, rle, top_down, channels):
    rng = np.random.default_rng(channels)
    # runs of equal pixels beside noise, so both packet kinds occur
    img = rng.integers(0, 4, (6, 140, channels), dtype=np.uint8) * 60
    img[:, 20:90] = img[:, 20:21]
    path = str(tmp_path / "t.tga")
    _tga(path, img, rle, top_down, ident=b"id")
    got = ttga.load_tga(path)
    np.testing.assert_array_equal(got, jtga.load_tga(path))
    np.testing.assert_array_equal(got, img)
