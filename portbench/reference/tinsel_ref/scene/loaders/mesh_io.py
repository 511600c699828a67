"""The PLY mesh importer (ASCII and binary of either endianness, face
lists fan-triangulated; the only format the cells' meshes come in), with
an ``.npz`` cache, and ``save_ply`` (binary little-endian); the port's
copy of ``tinsel_tpu/scene/loaders/mesh_io.py``, cut to that.

The cache holds positions, normals, indices, CDF and the flat BVH arrays
(``count`` and ``perm`` included). It lives in a directory of the port's
own (``.mesh_cache/torch/`` at the repo root, or ``$TINSEL_TORCH_MESH_CACHE``)
and its file names carry the package's tag: the port never reads a cache
the JAX package wrote, since a cache holds a built tree.
"""

from __future__ import annotations

import hashlib
import os
import struct
import time

import numpy as np

from ...accel.build import BVH
from ..model import Mesh


# the reference's own cache of imported meshes and their trees, inside
# the benchmark's folder (portbench/_data/refcache): never the program's
_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))), "_data", "refcache")


# the JAX package's cache format version (v2: unit-box normalization at
# import; v3: the ranged-leaf BVH's count/perm, without which a reloaded
# tree is corrupt)
_CACHE_VERSION = 3


def _cache_path_for(path: str) -> str:
    """Cache file in the port's own cache dir, never next to the asset. The
    key covers the absolute path, the format version and the package."""
    key = hashlib.sha1(
        f"{os.path.abspath(path)}|v{_CACHE_VERSION}|portbench-reference".encode()
    ).hexdigest()[:16]
    base = os.path.basename(path)
    return os.path.join(_CACHE_DIR, f"{base}.torch.{key}.npz")


def import_mesh(path: str, cache: bool = True) -> Mesh:
    """Import + build (normals, CDF, BVH) with transparent .npz caching."""
    cache_path = _cache_path_for(path)
    if cache and os.path.exists(cache_path) and os.path.getmtime(
        cache_path
    ) >= os.path.getmtime(path):
        try:
            return load_mesh_cache(cache_path)
        except Exception:
            pass

    ext = os.path.splitext(path)[1].lower()
    t0 = time.perf_counter()
    if ext == ".ply":
        mesh = import_ply(path)
    elif ext == ".npz":
        return load_mesh_cache(path)
    else:
        raise ValueError(f"unsupported mesh format: {path}")
    # scene-file transforms assume unit meshes: imported OBJ/PLY are
    # normalized to the unit box exactly like the reference
    # (mesh.cpp:105-132 ImportMesh -> Normalize before BVH build);
    # wo3/bin keep their stored coordinates and normals (same dispatch —
    # a .bin was normalized when the reference converted it)
    if ext not in (".wo3", ".bin"):
        mesh.normalize()
    mesh.build()
    dt = (time.perf_counter() - t0) * 1000.0
    print(f"Imported mesh {path} ({len(mesh.indices)} tris) in {dt:.1f}ms")
    if cache:
        try:
            os.makedirs(_CACHE_DIR, exist_ok=True)
            save_mesh_cache(cache_path, mesh)
        except OSError:
            pass
    return mesh


def save_mesh_cache(path: str, mesh: Mesh):
    """Full BVH round-trip including the ranged-leaf fields — like the
    reference's .bin dump, which also serializes its prebuilt BVH verbatim
    (mesh.cpp:809-880). Dropping count/perm is NOT recoverable: leaf `left`
    is a perm-range start, not an item index."""
    b = mesh.bvh
    np.savez_compressed(
        path,
        positions=mesh.positions,
        normals=mesh.normals,
        indices=mesh.indices,
        cdf=mesh.cdf,
        area=np.float32(mesh.area),
        bvh_lower=b.lower,
        bvh_upper=b.upper,
        bvh_left=b.left,
        bvh_right=b.right,
        bvh_leaf=b.leaf,
        bvh_count=b.count,
        bvh_perm=b.perm,
    )


def load_mesh_cache(path: str) -> Mesh:
    z = np.load(path)
    if "bvh_count" not in z or "bvh_perm" not in z:
        raise ValueError(
            f"mesh cache {path} predates ranged-leaf serialization (v3); "
            "refusing lossy reload — reimport the source mesh"
        )
    mesh = Mesh(
        positions=z["positions"],
        indices=z["indices"],
        normals=z["normals"],
        cdf=z["cdf"],
        area=float(z["area"]),
    )
    mesh.bvh = BVH(
        lower=z["bvh_lower"],
        upper=z["bvh_upper"],
        left=z["bvh_left"],
        right=z["bvh_right"],
        leaf=z["bvh_leaf"],
        count=z["bvh_count"],
        perm=z["bvh_perm"],
    )
    return mesh


# ------------------------------------------------------------------------ OBJ


# ------------------------------------------------------------------------ WO3


# ------------------------------------------------------------------------ BIN


# ------------------------------------------------------------------------ PLY


def _binary_faces(body: bytes, pos: int, n_face: int, cnt_dt, endian: str):
    """Fan-triangulated faces of a binary PLY face list (4-byte indices)
    starting at byte ``pos``; returns (faces, end position). Where every
    face has the first face's count, one structured ``np.frombuffer`` reads
    them all; otherwise faces are read one at a time. Both give the same
    triangles in the same order."""
    if n_face == 0:
        return np.zeros((0, 3), np.int64), pos
    cnt = int(np.frombuffer(body, cnt_dt, 1, pos)[0])
    rec = np.dtype([("n", cnt_dt), ("i", endian + "i4", (cnt,))])
    if cnt >= 3 and pos + n_face * rec.itemsize <= len(body):
        arr = np.frombuffer(body, rec, n_face, pos)
        if (arr["n"] == cnt).all():
            idx = arr["i"].astype(np.int64)
            fan = np.stack([np.repeat(idx[:, :1], cnt - 2, axis=1), idx[:, 1:-1],
                            idx[:, 2:]], axis=-1)
            return fan.reshape(-1, 3), pos + n_face * rec.itemsize
    faces = []
    i32 = struct.Struct(endian + "i")
    for _ in range(n_face):
        cnt = int(np.frombuffer(body, cnt_dt, 1, pos)[0])
        pos += cnt_dt.itemsize
        idx = [i32.unpack_from(body, pos + 4 * k)[0] for k in range(cnt)]
        pos += 4 * cnt
        for k in range(1, cnt - 1):
            faces.append((idx[0], idx[k], idx[k + 1]))
    return faces, pos


def import_ply(path: str) -> Mesh:
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n")
    assert header_end >= 0, "malformed PLY"
    header = data[: header_end].decode("ascii", "replace").splitlines()
    body = data[header_end + len(b"end_header\n") :]

    fmt = "ascii"
    n_vertex = n_face = 0
    n_strips = 0
    vertex_props = []
    cur_element = None
    face_count_type = "uchar"  # list COUNT dtype of the face element
    for line in header:
        t = line.split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            cur_element = t[1]
            if t[1] == "vertex":
                n_vertex = int(t[2])
            elif t[1] == "face":
                n_face = int(t[2])
            elif t[1] == "tristrips":
                n_strips = int(t[2])
        elif t[0] == "property" and cur_element == "vertex":
            if t[1] == "list":
                continue
            vertex_props.append((t[1], t[2]))
        elif t[0] == "property" and t[1] == "list":
            # list <count_type> <index_type> — the count dtype varies
            # (uchar for typical face elements, int for tristrips)
            if cur_element == "face":
                face_count_type = t[2]

    if n_strips:
        raise ValueError(f"{path}: PLY tristrips are not read by the reference")
    prop_names = [p[1] for p in vertex_props]
    xi, yi, zi = (prop_names.index(c) for c in ("x", "y", "z"))
    has_n = all(c in prop_names for c in ("nx", "ny", "nz"))

    if fmt == "ascii":
        text = body.decode("ascii", "replace").split("\n")
        vp = np.array(
            [[float(v) for v in text[i].split()] for i in range(n_vertex)],
            np.float64,
        )
        positions = vp[:, [xi, yi, zi]].astype(np.float32)
        normals = (
            vp[:, [prop_names.index("nx"), prop_names.index("ny"), prop_names.index("nz")]].astype(np.float32)
            if has_n
            else None
        )
        faces = []
        for i in range(n_vertex, n_vertex + n_face):
            t = [int(v) for v in text[i].split()]
            cnt, idx = t[0], t[1:]
            for k in range(1, cnt - 1):
                faces.append((idx[0], idx[k], idx[k + 1]))
        indices = np.asarray(faces, np.int32)
    else:
        endian = "<" if fmt == "binary_little_endian" else ">"
        type_map = {
            "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
            "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
            "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
            "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
        }
        vdt = np.dtype([(p[1], endian + type_map[p[0]]) for p in vertex_props])
        varr = np.frombuffer(body, vdt, count=n_vertex)
        positions = np.stack(
            [varr["x"], varr["y"], varr["z"]], axis=-1
        ).astype(np.float32)
        normals = (
            np.stack([varr["nx"], varr["ny"], varr["nz"]], axis=-1).astype(np.float32)
            if has_n
            else None
        )
        pos = n_vertex * vdt.itemsize
        cnt_dt = np.dtype(endian + type_map[face_count_type])
        faces, pos = _binary_faces(body, pos, n_face, cnt_dt, endian)
        indices = np.asarray(faces, np.int64).reshape(-1, 3).astype(np.int32)

    mesh = Mesh(positions=positions, indices=indices)
    if normals is not None and np.isfinite(normals).all():
        norm = np.linalg.norm(normals, axis=-1, keepdims=True)
        if (norm[:, 0] > 1e-8).all():
            mesh.normals = (normals / norm).astype(np.float32)
    return mesh


def save_ply(path: str, positions: np.ndarray, indices: np.ndarray,
             normals: np.ndarray | None = None):
    """Binary little-endian PLY writer (the export-side complement of
    import_ply; the reference ships only importers + its .bin dump,
    mesh.cpp:809-880)."""
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int32)
    has_n = normals is not None
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {len(positions)}",
               "property float x", "property float y", "property float z"]
        if has_n:
            hdr += ["property float nx", "property float ny",
                    "property float nz"]
        hdr += [f"element face {len(indices)}",
                "property list uchar int vertex_indices", "end_header"]
        f.write(("\n".join(hdr) + "\n").encode("ascii"))
        if has_n:
            v = np.concatenate(
                [positions, np.asarray(normals, np.float32)], axis=1
            )
        else:
            v = positions
        f.write(np.ascontiguousarray(v, "<f4").tobytes())
        rows = np.zeros(len(indices), np.dtype([("n", "u1"), ("i", "<i4", (3,))]))
        rows["n"] = 3
        rows["i"] = indices
        f.write(rows.tobytes())
