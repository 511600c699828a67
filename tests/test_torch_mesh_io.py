"""The port's mesh importers and writers (scene/loaders/mesh_io.py) against
tinsel_tpu's on the same files: every field of the imported mesh
(positions, normals, indices, CDF, area, the BVH arrays) bit for bit, and
the port's own cache."""

import os

import numpy as np
import pytest

import torch_parity  # noqa: F401  (builds tinsel_tpu's native library once, locked)
from tinsel_tpu.scene.loaders import mesh_io as jio
from tinsel_tpu_torch.scene import procedural as tproc
from tinsel_tpu_torch.scene.loaders import mesh_io as tio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("positions", "normals", "indices", "cdf")
BVH_FIELDS = ("lower", "upper", "left", "right", "leaf", "count", "perm")


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Each package's mesh cache in its own directory under tmp_path."""
    monkeypatch.setattr(jio, "_CACHE_DIR", str(tmp_path / "jax_cache"))
    monkeypatch.setattr(tio, "_CACHE_DIR", str(tmp_path / "torch_cache"))
    return tmp_path


def assert_meshes_equal(t, j):
    for f in FIELDS:
        a, b = getattr(j, f), getattr(t, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert b.dtype == a.dtype, f
            np.testing.assert_array_equal(b, a, err_msg=f)
    assert t.area == j.area
    assert (t.bvh is None) == (j.bvh is None)
    if t.bvh is not None:
        for f in BVH_FIELDS:
            np.testing.assert_array_equal(getattr(t.bvh, f), getattr(j.bvh, f), err_msg=f)


def import_both(path, cache=False):
    return tio.import_mesh(path, cache=cache), jio.import_mesh(path, cache=cache)


def _grid(n=5, seed=0):
    """An n x n vertex grid with a little noise: positions, quads."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:n, 0:n]
    pos = np.stack([x, 0.2 * rng.random((n, n)), y], -1).reshape(-1, 3).astype(np.float32)
    q = [(r * n + c, r * n + c + 1, (r + 1) * n + c + 1, (r + 1) * n + c)
         for r in range(n - 1) for c in range(n - 1)]
    return pos, q


# ------------------------------------------------------------------- OBJ


def _write_obj(path, kind):
    pos, quads = _grid()
    lines = [f"v {p[0]} {p[1]} {p[2]}" for p in pos]
    if kind in ("normals", "partial"):
        lines += ["vn 0 1 0", "vn 0.1 0.9 0", "vn 0 0 0"]
    nv = len(pos)
    for k, q in enumerate(quads):
        if kind == "plain":
            lines.append("f " + " ".join(str(i + 1) for i in q))
        elif kind == "negative":  # relative indices from the end
            lines.append("f " + " ".join(str(i - nv) for i in q))
        elif kind == "normals":
            lines.append("f " + " ".join(f"{i + 1}//{1 + (k + m) % 2}" for m, i in enumerate(q)))
        elif kind == "partial":  # one face names the zero normal
            ni = 3 if k == 0 else 1
            lines.append("f " + " ".join(f"{i + 1}/1/{ni}" for i in q))
        elif kind == "triangles":
            lines.append(f"f {q[0] + 1} {q[1] + 1} {q[2] + 1}")
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("kind", ["plain", "negative", "normals", "partial", "triangles"])
def test_obj_matches_jax(tmp_path, caches, kind):
    path = tmp_path / f"{kind}.obj"
    _write_obj(path, kind)
    t, j = import_both(str(path))
    assert_meshes_equal(t, j)
    raw_t, raw_j = tio.import_obj(str(path)), jio.import_obj(str(path))
    for f in ("positions", "indices", "normals"):
        a, b = getattr(raw_j, f), getattr(raw_t, f)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(b, a)
    assert (raw_t.normals is None) == (kind != "normals")


# ------------------------------------------------------------------- PLY


def _ply_header(fmt, nv, nf, count_type, normals, strips=0):
    h = ["ply", f"format {fmt} 1.0", f"element vertex {nv}",
         "property float x", "property float y", "property float z"]
    if normals:
        h += ["property float nx", "property float ny", "property float nz"]
    h += [f"element face {nf}", f"property list {count_type} int vertex_indices"]
    if strips:
        h += [f"element tristrips {strips}", "property list int int vertex_indices"]
    return ("\n".join(h + ["end_header"]) + "\n").encode()


STRIP = [0, 1, 5, 6, 2, -1, 7, 7, 8, 3, 4, 9]  # a restart, a degenerate triangle


def _write_ply(path, fmt, count_type, normals, mixed, strips):
    pos, quads = _grid()
    faces = [list(q) if (mixed and k % 3 == 0) else [q[0], q[1], q[2]]
             for k, q in enumerate(quads)]
    nrm = np.tile(np.array([[0.0, 1.0, 0.2]], np.float32), (len(pos), 1))
    strip = STRIP
    with open(path, "wb") as f:
        f.write(_ply_header(fmt, len(pos), len(faces), count_type, normals, 1 if strips else 0))
        if fmt == "ascii":
            for k, p in enumerate(pos):
                vals = list(p) + (list(nrm[k]) if normals else [])
                f.write((" ".join(repr(float(v)) for v in vals) + "\n").encode())
            for fc in faces:
                f.write((" ".join(str(v) for v in [len(fc)] + fc) + "\n").encode())
            if strips:
                f.write((" ".join(str(v) for v in [len(strip)] + strip) + "\n").encode())
            return
        e = "<" if fmt == "binary_little_endian" else ">"
        v = np.concatenate([pos, nrm], 1) if normals else pos
        f.write(np.ascontiguousarray(v, e + "f4").tobytes())
        cdt = {"uchar": "u1", "int": e + "i4", "ushort": e + "u2"}[count_type]
        for fc in faces:
            f.write(np.array([len(fc)], cdt).tobytes() + np.array(fc, e + "i4").tobytes())
        if strips:
            f.write(np.array([len(strip)], e + "i4").tobytes() + np.array(strip, e + "i4").tobytes())


PLY_CASES = [
    ("ascii", "uchar", False, True, False),
    ("ascii", "uchar", True, False, True),
    ("binary_little_endian", "uchar", False, False, False),
    ("binary_little_endian", "uchar", True, True, False),
    ("binary_little_endian", "int", False, False, True),
    ("binary_big_endian", "uchar", True, False, False),
    ("binary_big_endian", "int", False, True, True),
    ("binary_big_endian", "ushort", False, False, False),
]


@pytest.mark.parametrize("fmt,count_type,normals,mixed,strips", PLY_CASES)
def test_ply_matches_jax(tmp_path, caches, fmt, count_type, normals, mixed, strips):
    path = tmp_path / "m.ply"
    _write_ply(path, fmt, count_type, normals, mixed, strips)
    raw_t, raw_j = tio.import_ply(str(path)), jio.import_ply(str(path))
    np.testing.assert_array_equal(raw_t.indices, raw_j.indices)
    np.testing.assert_array_equal(raw_t.positions, raw_j.positions)
    assert (raw_t.normals is None) == (raw_j.normals is None) == (not normals)
    n_quads = sum(1 for k in range(16) if mixed and k % 3 == 0)
    assert len(raw_t.indices) == 16 + n_quads + (6 if strips else 0)
    assert_meshes_equal(*import_both(str(path)))


@pytest.mark.parametrize("name", ["knob.ply", "plate.ply"])
def test_repo_assets_match_jax(caches, name):
    assert_meshes_equal(*import_both(os.path.join(ROOT, "scenes", "assets", name)))


def test_save_ply_writes_the_same_bytes_and_a_big_mesh_builds_natively(tmp_path, caches):
    """save_ply's bytes equal the JAX writer's; a mesh of 8,192 triangles
    (over the native builder's 4,096) imports to the JAX importer's tree."""
    m = tproc.sphere(1.0, 64, 64)
    m.calculate_normals()
    for normals in (None, m.normals):
        tio.save_ply(str(tmp_path / "t.ply"), m.positions, m.indices, normals)
        jio.save_ply(str(tmp_path / "j.ply"), m.positions, m.indices, normals)
        assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    t, j = import_both(str(tmp_path / "t.ply"))
    assert len(t.indices) == 8192
    assert_meshes_equal(t, j)


# ------------------------------------------------------------ wo3 and bin


def test_wo3_round_trip_matches_jax(tmp_path, caches):
    rng = np.random.default_rng(4)
    pos, quads = _grid(6, 1)
    idx = np.array([[q[0], q[1], q[2]] for q in quads], np.int32)
    nrm = rng.normal(size=pos.shape).astype(np.float32)
    uv = rng.random((len(pos), 2)).astype(np.float32)
    tio.save_wo3(str(tmp_path / "t.wo3"), pos, idx, nrm, uv)
    jio.save_wo3(str(tmp_path / "j.wo3"), pos, idx, nrm, uv)
    assert (tmp_path / "t.wo3").read_bytes() == (tmp_path / "j.wo3").read_bytes()
    t, j = import_both(str(tmp_path / "t.wo3"))
    assert_meshes_equal(t, j)
    np.testing.assert_array_equal(t.positions, pos)  # wo3 is not normalized
    np.testing.assert_array_equal(t.indices, idx)


def test_bin_round_trip_matches_jax(tmp_path, caches):
    m = tio.import_mesh(os.path.join(ROOT, "scenes", "assets", "knob.ply"), cache=False)
    tio.save_bin(str(tmp_path / "t.bin"), m)
    jio.save_bin(str(tmp_path / "j.bin"), m)
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    t, j = import_both(str(tmp_path / "t.bin"))
    assert_meshes_equal(t, j)
    np.testing.assert_array_equal(t.positions, m.positions)
    np.testing.assert_array_equal(t.indices, m.indices)
    with pytest.raises(ValueError, match="built mesh"):
        tio.save_bin(str(tmp_path / "x.bin"), tio.Mesh(positions=m.positions, indices=m.indices))


# ----------------------------------------------------------------- cache


def test_cache_round_trip_and_warm_equals_cold(tmp_path, caches):
    src = tmp_path / "blob.ply"
    m = tproc.sphere(1.0, 12, 24)
    tio.save_ply(str(src), m.positions, m.indices)
    cold = tio.import_mesh(str(src))
    files = os.listdir(tio._CACHE_DIR)
    assert len(files) == 1 and ".torch." in files[0]
    warm = tio.import_mesh(str(src))
    assert warm is not cold
    assert_meshes_equal(warm, cold)
    back = tio.load_mesh_cache(os.path.join(tio._CACHE_DIR, files[0]))
    assert_meshes_equal(back, cold)
    # the JAX importer, cold, builds the same mesh
    assert_meshes_equal(cold, jio.import_mesh(str(src)))


def test_cache_never_reads_the_jax_package_cache(tmp_path, caches, monkeypatch):
    """Both caches in one directory: the names differ, so the port builds
    its own (a JAX cache holds the JAX builder's tree)."""
    monkeypatch.setattr(tio, "_CACHE_DIR", jio._CACHE_DIR)
    src = tmp_path / "blob.ply"
    m = tproc.sphere(1.0, 8, 16)
    tio.save_ply(str(src), m.positions, m.indices)
    jio.import_mesh(str(src))
    assert len(os.listdir(jio._CACHE_DIR)) == 1
    tio.import_mesh(str(src))
    assert len(os.listdir(jio._CACHE_DIR)) == 2
    assert tio._cache_path_for(str(src)) != jio._cache_path_for(str(src))


def test_cache_refuses_a_v2_file(tmp_path, caches):
    """A cache without the ranged leaves' count/perm (format v2) is refused
    by load_mesh_cache; import_mesh then reimports the source."""
    src = tmp_path / "blob.ply"
    m = tproc.sphere(1.0, 8, 16)
    tio.save_ply(str(src), m.positions, m.indices)
    cold = tio.import_mesh(str(src))
    path = tio._cache_path_for(str(src))
    z = dict(np.load(path))
    del z["bvh_count"], z["bvh_perm"]
    np.savez(path.removesuffix(".npz"), **z)
    with pytest.raises(ValueError, match="predates ranged-leaf"):
        tio.load_mesh_cache(path)
    assert_meshes_equal(tio.import_mesh(str(src)), cold)
    assert "bvh_count" in np.load(path)  # rewritten by the reimport


def test_unsupported_format_raises(tmp_path):
    with pytest.raises(ValueError, match="unsupported mesh format"):
        tio.import_mesh(str(tmp_path / "x.stl"), cache=False)
