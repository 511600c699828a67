"""The port's HDR readers and writers (io/hdr.py) and load_probe against
tinsel_tpu's on the same files, bit for bit."""

import dataclasses

import numpy as np
import pytest

from tinsel_tpu.io import hdr as jhdr
from tinsel_tpu.scene.probe_io import load_probe as jload_probe
from tinsel_tpu_torch.io import hdr as thdr
from tinsel_tpu_torch.scene.probe_io import load_probe as tload_probe


def _image(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) * 10.0 ** rng.integers(-3, 3, shape)).astype(np.float32)


def write_pfm(path, img, big_endian):
    """A PFM written by hand in either byte order (save_pfm writes little
    endian only)."""
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n" if img.ndim == 3 else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"1.0\n" if big_endian else b"-1.0\n")
        f.write(np.ascontiguousarray(img[::-1]).astype(">f4" if big_endian else "<f4").tobytes())


def _rle_channel(row: np.ndarray) -> bytes:
    """New-style RLE of one channel of a scanline: runs of 3+ equal bytes
    as (128 + n, value), everything else as literals of up to 128 bytes."""
    out, x, w = bytearray(), 0, len(row)
    while x < w:
        n = 1
        while x + n < w and n < 127 and row[x + n] == row[x]:
            n += 1
        if n >= 3:
            out += bytes([128 + n, int(row[x])])
            x += n
            continue
        start = x
        while x < w and x - start < 128:
            if x + 2 < w and row[x] == row[x + 1] == row[x + 2]:
                break
            x += 1
        out += bytes([x - start]) + bytes(row[start:x].tolist())
    return bytes(out)


def write_rle_hdr(path, rgbe: np.ndarray):
    h, w = rgbe.shape[:2]
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        for y in range(h):
            f.write(bytes([2, 2, w >> 8, w & 255]))
            for c in range(4):
                f.write(_rle_channel(rgbe[y, :, c]))


def _rgbe_with_runs(h, w, seed):
    """RGBE bytes with long runs (flat regions) and literals (noise)."""
    rng = np.random.default_rng(seed)
    rgbe = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    rgbe[..., 3] = rng.integers(120, 140, (h, w))
    rgbe[: h // 2, : w // 2] = [200, 100, 50, 130]  # runs in every channel
    rgbe[h // 2, :] = [0, 0, 0, 0]  # a black row: exponent 0
    rgbe[:, -3:, 1] = 7  # a run of exactly three
    return rgbe


@pytest.mark.parametrize("big_endian", [False, True])
@pytest.mark.parametrize("channels", [3, 1])
def test_pfm_load_matches_jax(tmp_path, channels, big_endian):
    img = _image((13, 17, 3) if channels == 3 else (13, 17), 1)
    path = str(tmp_path / "x.pfm")
    write_pfm(path, img, big_endian)
    a, b = jhdr.load_pfm(path), thdr.load_pfm(path)
    assert b.dtype == a.dtype == np.float32 and b.shape == img.shape
    np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(b, img)


@pytest.mark.parametrize("channels", [3, 1])
def test_save_pfm_writes_the_same_bytes(tmp_path, channels):
    img = _image((9, 11, 3) if channels == 3 else (9, 11), 2)
    jhdr.save_pfm(str(tmp_path / "j.pfm"), img)
    thdr.save_pfm(str(tmp_path / "t.pfm"), img)
    assert (tmp_path / "t.pfm").read_bytes() == (tmp_path / "j.pfm").read_bytes()
    np.testing.assert_array_equal(thdr.load_pfm(str(tmp_path / "t.pfm")), img)


def test_save_hdr_and_flat_decode_match_jax(tmp_path):
    img = _image((10, 23, 3), 3)
    img[0, 0] = 0.0
    jhdr.save_hdr(str(tmp_path / "j.hdr"), img)
    thdr.save_hdr(str(tmp_path / "t.hdr"), img)
    assert (tmp_path / "t.hdr").read_bytes() == (tmp_path / "j.hdr").read_bytes()
    a, b = jhdr.load_hdr(str(tmp_path / "t.hdr")), thdr.load_hdr(str(tmp_path / "t.hdr"))
    assert b.dtype == a.dtype and b.shape == (10, 23, 3)
    np.testing.assert_array_equal(b, a)
    # one shared exponent per pixel, 8-bit mantissas
    assert (np.abs(b - img) <= 2 ** -7 * img.max(axis=-1, keepdims=True)).all()


@pytest.mark.parametrize("w", [8, 61, 300])
def test_rle_decode_matches_jax(tmp_path, w):
    rgbe = _rgbe_with_runs(6, w, w)
    path = str(tmp_path / "rle.hdr")
    write_rle_hdr(path, rgbe)
    raw = open(path, "rb").read()
    assert w == 8 or len(raw) < rgbe.size  # the runs compressed it
    a, b = jhdr.load_hdr(path), thdr.load_hdr(path)
    np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(b, thdr._rgbe_to_float(rgbe))


@pytest.mark.parametrize("ext", [".hdr", ".pfm"])
def test_load_probe_matches_jax(tmp_path, ext):
    path = str(tmp_path / f"probe{ext}")
    if ext == ".hdr":
        write_rle_hdr(path, _rgbe_with_runs(16, 32, 4))
    else:
        write_pfm(path, _image((16, 32, 3), 5), big_endian=False)
    a, b = jload_probe(path), tload_probe(path)
    for f in dataclasses.fields(b):
        np.testing.assert_array_equal(getattr(b, f.name), getattr(a, f.name), err_msg=f.name)
    with pytest.raises(ValueError, match="unsupported probe format"):
        tload_probe(str(tmp_path / "probe.exr"))
