"""The stand-ins of a configuration whose upstream assets are not shipped
(``configs/<name>.json``'s ``standins``), written from the
configuration's own fixed seed into ``portbench/_data/<config>/`` (a
fixed directory inside the checkout, so the port's mesh cache under
``.mesh_cache/torch/`` hits from the second run on): a Perlin-displaced
sphere PLY in the place of a scanned mesh, and a run-length encoded
Radiance ``.hdr`` sky in the place of a probe. Copied from the
repository's ``chip_smoke.py`` (``perlin_sphere``, ``probe_image``,
``write_rle_hdr``). The scene file is written again with the stand-ins'
paths in place of the upstream ones."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .spec import HERE, ROOT


def perlin_sphere(detail: int):
    """A sphere of radius 0.8 with 2 * detail^2 triangles displaced by
    four octaves of Perlin noise: (positions, indices)."""
    from reference.tinsel_ref.scene.procedural import sphere
    from reference.tinsel_ref.utils.perlin import fractal3d

    m = sphere(radius=0.8, n_theta=detail, n_phi=detail)
    p = m.positions
    disp = np.asarray(fractal3d(p[:, 0] * 3.0, p[:, 1] * 3.0, p[:, 2] * 3.0, octaves=4),
                      np.float32)
    r = np.linalg.norm(p, axis=-1, keepdims=True)
    pos = (p / np.maximum(r, 1e-9)) * (0.8 + 0.18 * disp[:, None]).astype(np.float32)
    return pos.astype(np.float32), m.indices


def probe_image(w: int, h: int, seed: int):
    """A lat-long sky of w x h: a gradient from horizon to zenith, a sun
    disc of radiance 2,000, a darker, grainy ground and seeded cloud noise
    in 8x8 blocks."""
    rng = np.random.default_rng(seed)
    v = (np.arange(h, dtype=np.float32)[:, None] + 0.5) / h  # 0 = up
    u = (np.arange(w, dtype=np.float32)[None, :] + 0.5) / w
    up = np.clip(1.0 - 2.0 * v, 0.0, 1.0)
    sky = (np.array([0.9, 0.85, 0.75], np.float32) * (1 - up)[..., None]
           + np.array([0.25, 0.4, 0.75], np.float32) * up[..., None])
    img = np.broadcast_to(sky, (h, w, 3)).copy()
    img[v[:, 0] > 0.5] *= 0.3
    cloud = np.repeat(np.repeat(rng.random((h // 8, w // 8)), 8, 0), 8, 1)[:h, :w]
    img *= (0.8 + 0.4 * cloud)[..., None].astype(np.float32)
    img[h // 2:] *= (0.9 + 0.2 * rng.random((h - h // 2, w, 1))).astype(np.float32)
    sun = ((u - 0.3) ** 2 * 4 + (v - 0.2) ** 2) < 0.02 ** 2
    img[sun] = 2000.0
    return img.astype(np.float32)


def write_rle_hdr(path, img):
    """A Radiance .hdr of ``img`` with new-style RLE scanlines, RGBE
    quantized."""
    img = np.maximum(np.asarray(img, np.float32), 0.0)
    h, w = img.shape[:2]
    maxc = img.max(axis=-1)
    nz = maxc > 1e-32
    m, ex = np.frexp(maxc)
    scale = np.where(nz, m * 256.0 / np.maximum(maxc, 1e-32), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, ex + 128, 0).astype(np.uint8)
    out = bytearray(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode())
    for y in range(h):
        out += bytes((2, 2, w >> 8, w & 255))
        for c in range(4):
            row = rgbe[y, :, c]
            starts = np.flatnonzero(np.r_[True, row[1:] != row[:-1]]).tolist() + [w]
            lit = []
            for a, b in zip(starts[:-1], starts[1:]):
                n = b - a
                if n < 3:
                    lit.extend(row[a:b].tolist())
                    continue
                for i in range(0, len(lit), 128):
                    out += bytes((len(lit[i:i + 128]),)) + bytes(lit[i:i + 128])
                lit = []
                while n > 0:
                    k = min(n, 127)
                    if k < 3:
                        out += bytes((k,)) + bytes([int(row[a])] * k)
                    else:
                        out += bytes((128 + k, int(row[a])))
                    n -= k
            for i in range(0, len(lit), 128):
                out += bytes((len(lit[i:i + 128]),)) + bytes(lit[i:i + 128])
    Path(path).write_bytes(bytes(out))


def scene_file(config: dict, data_dir: Path | None = None) -> str:
    """The scene file this configuration runs: the repository's file, or,
    where it has ``standins``, a copy that names the stand-ins (written
    once into ``data_dir``, by default ``portbench/_data/<config>/``).

    ``standins`` holds the ``seed`` of the sky and any of: ``mesh``, a mesh
    stand-in for a path the scene names exactly once; ``meshes``, a list of
    mesh stand-ins, each for every occurrence of its path (at least one:
    a mesh that many primitives instance); ``probe``, a sky stand-in for a
    path named once. The stamp ``standins.json`` records them as given, so
    the files are written again only when the configuration changes."""
    path = ROOT / config["scene"]
    st = config.get("standins")
    if not st:
        return str(path)
    d = Path(data_dir or HERE / "_data" / config["name"])
    d.mkdir(parents=True, exist_ok=True)
    stamp = d / "standins.json"
    want = json.dumps(st, sort_keys=True)
    tin = d / path.name
    if not (stamp.exists() and stamp.read_text() == want and tin.exists()):
        from reference.tinsel_ref.scene.loaders.mesh_io import save_ply

        text = path.read_text()
        meshes = [(st["mesh"], False)] if "mesh" in st else []
        meshes += [(m, True) for m in st.get("meshes", [])]
        for m, every in meshes:
            ply = d / m["file"]
            save_ply(str(ply), *perlin_sphere(int(m["detail"])))
            text = _replaced(text, path, m["replaces"], ply, every)
        if "probe" in st:
            hdr = d / st["probe"]["file"]
            write_rle_hdr(hdr, probe_image(int(st["probe"]["width"]),
                                           int(st["probe"]["height"]), int(st["seed"])))
            text = _replaced(text, path, st["probe"]["replaces"], hdr, every=False)
        tin.write_text(text)
        stamp.write_text(want)
    return str(tin)


def _replaced(text: str, path, old: str, new, every: bool) -> str:
    """``text`` with ``old`` replaced by ``new``: named once, or, where
    ``every``, at least once."""
    n = text.count(old)
    if n != 1 and not (every and n >= 1):
        raise ValueError(f"{path} names {old} {n} times; its stand-in replaces "
                         + ("every occurrence, at least one" if every else "exactly one"))
    return text.replace(old, str(new))
