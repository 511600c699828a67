"""Mesh importers: OBJ, PLY (ASCII and binary), ``.wo3`` and ``.bin``,
with an ``.npz`` cache; the port's copy of
``tinsel_tpu/scene/loaders/mesh_io.py``.

OBJ with (v, vn) deduplication and fan triangulation; PLY in ASCII and
binary of either endianness, with the face list's count type and
``tristrips``; ``.wo3`` (flat little-endian {pos, normal, uv} vertices and
{i, j, k, mat} triangles, stored normals kept, not normalized); ``.bin``
(geometry, normals, area and CDF; its binary-BVH node block is skipped and
the tree rebuilt). Writers: ``save_ply`` (binary little-endian),
``save_wo3`` and ``save_bin``.

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


_CACHE_DIR = os.environ.get(
    "TINSEL_TORCH_MESH_CACHE",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))), ".mesh_cache", "torch"),
)


# the JAX package's cache format version (v2: unit-box normalization at
# import; v3: the ranged-leaf BVH's count/perm, without which a reloaded
# tree is corrupt)
_CACHE_VERSION = 3


def _cache_path_for(path: str) -> str:
    """Cache file in the port's own cache dir, never next to the asset. The
    key covers the absolute path, the format version and the package."""
    key = hashlib.sha1(
        f"{os.path.abspath(path)}|v{_CACHE_VERSION}|tinsel_tpu_torch".encode()
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
    if ext == ".obj":
        mesh = import_obj(path)
    elif ext == ".ply":
        mesh = import_ply(path)
    elif ext == ".wo3":
        mesh = import_wo3(path)
    elif ext == ".bin":
        mesh = import_bin(path)
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


def import_obj(path: str) -> Mesh:
    """Wavefront OBJ: v/vn parsed; faces triangulated (fan); (v, vn) pairs
    deduplicated; normals recomputed if absent."""
    positions = []
    normals = []
    verts = {}  # (vi, ni) -> new index
    out_pos = []
    out_nrm = []
    faces = []
    has_normals = False

    def resolve(token: str) -> int:
        nonlocal has_normals
        parts = token.split("/")
        vi = int(parts[0])
        vi = vi - 1 if vi > 0 else len(positions) + vi
        ni = None
        if len(parts) == 3 and parts[2]:
            ni = int(parts[2])
            ni = ni - 1 if ni > 0 else len(normals) + ni
            has_normals = True
        key = (vi, ni)
        idx = verts.get(key)
        if idx is None:
            idx = len(out_pos)
            verts[key] = idx
            out_pos.append(positions[vi])
            out_nrm.append(normals[ni] if ni is not None else (0.0, 0.0, 0.0))
        return idx

    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                p = line.split()
                positions.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("vn "):
                p = line.split()
                normals.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("f "):
                toks = line.split()[1:]
                idx = [resolve(t) for t in toks]
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append((idx[0], idx[k], idx[k + 1]))

    mesh = Mesh(
        positions=np.asarray(out_pos, np.float32),
        indices=np.asarray(faces, np.int32),
    )
    if has_normals:
        n = np.asarray(out_nrm, np.float32)
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        ok = norm[:, 0] > 1e-8
        mesh.normals = np.where(ok[:, None], n / np.maximum(norm, 1e-8), 0.0).astype(np.float32)
        if not ok.all():
            mesh.normals = None  # partial normals: recompute all
    return mesh


# ------------------------------------------------------------------------ WO3


def import_wo3(path: str) -> Mesh:
    """Binary .wo3 : u64 vertex count, then packed
    {Vec3 pos, Vec3 normal, Vec2 uv} records (32 B), u64 triangle count,
    then {int i, j, k, mat} records (16 B); uv and mat are dropped exactly
    like the reference drops them."""
    with open(path, "rb") as f:
        data = f.read()
    n_vertex = int(np.frombuffer(data, "<u8", count=1, offset=0)[0])
    vdt = np.dtype([("pos", "<f4", 3), ("nrm", "<f4", 3), ("uv", "<f4", 2)])
    verts = np.frombuffer(data, vdt, count=n_vertex, offset=8)
    off = 8 + n_vertex * vdt.itemsize
    n_tri = int(np.frombuffer(data, "<u8", count=1, offset=off)[0])
    tdt = np.dtype([("idx", "<i4", 3), ("mat", "<i4")])
    tris = np.frombuffer(data, tdt, count=n_tri, offset=off + 8)

    mesh = Mesh(
        positions=np.ascontiguousarray(verts["pos"], np.float32),
        indices=np.ascontiguousarray(tris["idx"], np.int32),
    )
    normals = np.ascontiguousarray(verts["nrm"], np.float32)
    norm = np.linalg.norm(normals, axis=-1, keepdims=True)
    if np.isfinite(normals).all() and (norm[:, 0] > 1e-8).all():
        mesh.normals = (normals / norm).astype(np.float32)
    return mesh


def save_wo3(path: str, positions: np.ndarray, indices: np.ndarray,
             normals: np.ndarray | None = None,
             uvs: np.ndarray | None = None):
    """Writer for the reference's .wo3 layout (round-trip/test complement;
    the reference itself ships only the importer)."""
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int32).reshape(-1, 3)
    n = len(positions)
    vdt = np.dtype([("pos", "<f4", 3), ("nrm", "<f4", 3), ("uv", "<f4", 2)])
    verts = np.zeros(n, vdt)
    verts["pos"] = positions
    if normals is not None:
        verts["nrm"] = np.asarray(normals, np.float32)
    if uvs is not None:
        verts["uv"] = np.asarray(uvs, np.float32)
    tdt = np.dtype([("idx", "<i4", 3), ("mat", "<i4")])
    tris = np.zeros(len(indices), tdt)
    tris["idx"] = indices
    with open(path, "wb") as f:
        f.write(np.uint64(n).tobytes())
        f.write(verts.tobytes())
        f.write(np.uint64(len(indices)).tobytes())
        f.write(tris.tobytes())


# ------------------------------------------------------------------------ BIN


def import_bin(path: str) -> Mesh:
    """Reference `.bin` mesh dump: header of three
    little-endian i32 {numVertices, numIndices, numNodes}, then positions
    (numVertices x 12 B Vec3), normals (same), indices (numIndices x i32),
    numNodes x 32 B binary BVH nodes (SKIPPED — the wide TPU tree is
    rebuilt, see module docstring), then area (f32) and the per-triangle
    area CDF (numIndices/3 x f32), which are kept verbatim."""
    with open(path, "rb") as f:
        data = f.read()
    n_vtx, n_idx, n_nodes = (int(v) for v in np.frombuffer(data, "<i4", 3))
    if n_vtx <= 0 or n_idx <= 0 or n_idx % 3 or n_nodes < 0:
        raise ValueError(f"corrupt .bin mesh header in {path}")
    off = 12
    pos = np.frombuffer(data, "<f4", n_vtx * 3, off).reshape(n_vtx, 3)
    off += n_vtx * 12
    nrm = np.frombuffer(data, "<f4", n_vtx * 3, off).reshape(n_vtx, 3)
    off += n_vtx * 12
    idx = np.frombuffer(data, "<i4", n_idx, off).reshape(-1, 3)
    off += n_idx * 4
    off += n_nodes * 32  # serialized BVHNode block: layout-foreign, skipped
    mesh = Mesh(
        positions=np.ascontiguousarray(pos, np.float32),
        indices=np.ascontiguousarray(idx, np.int32),
    )
    if off + 4 + (n_idx // 3) * 4 <= len(data):
        mesh.area = float(np.frombuffer(data, "<f4", 1, off)[0])
        mesh.cdf = np.ascontiguousarray(
            np.frombuffer(data, "<f4", n_idx // 3, off + 4), np.float32
        )
    norm = np.linalg.norm(nrm, axis=-1, keepdims=True)
    if np.isfinite(nrm).all() and (norm[:, 0] > 1e-8).all():
        mesh.normals = np.ascontiguousarray(nrm / norm, np.float32)
    return mesh


def save_bin(path: str, mesh: Mesh):
    """Writer for the reference's `.bin` layout (round-trip/test complement
    of import_bin; also lets assets converted here feed the reference).
    Requires a built mesh (cdf/area present); emits a single root leaf node
    block so the reference's reader gets a structurally valid (if trivial)
    tree — it rebuilds nothing, so readers that *use* the nodes get one
    32-byte leaf covering all items."""
    if mesh.cdf is None:
        raise ValueError("save_bin needs a built mesh (mesh.build())")
    n_vtx = len(mesh.positions)
    idx = np.asarray(mesh.indices, np.int32).reshape(-1, 3)
    nrm = mesh.normals
    if nrm is None or len(nrm) != n_vtx:
        raise ValueError("save_bin needs vertex normals (mesh.build())")
    lo = mesh.positions.min(axis=0).astype(np.float32)
    hi = mesh.positions.max(axis=0).astype(np.float32)
    # one leaf node: bounds + {leftIndex=0, rightIndex:31=count, leaf:1=1}
    node = np.zeros(8, np.uint32)
    node[0:3] = lo.view(np.uint32)
    node[3:6] = hi.view(np.uint32)
    node[6] = 0
    node[7] = np.uint32((len(idx) & 0x7FFFFFFF) | 0x80000000)
    with open(path, "wb") as f:
        f.write(np.asarray([n_vtx, idx.size, 1], "<i4").tobytes())
        f.write(np.asarray(mesh.positions, "<f4").tobytes())
        f.write(np.asarray(nrm, "<f4").tobytes())
        f.write(np.asarray(idx, "<i4").tobytes())
        f.write(node.tobytes())
        f.write(np.float32(mesh.area).tobytes())
        f.write(np.asarray(mesh.cdf, "<f4").tobytes())


# ------------------------------------------------------------------------ PLY


def _decode_tristrip(idx) -> list:
    """Triangle-strip list (-1 = strip restart) -> triangle index tuples
    with alternating winding, degenerate triangles dropped. Extends the
    PLY importer to scanner-produced `element tristrips` files (e.g. the
    Stanford-scan meshes); the reference's importer (mesh.cpp) has no
    tristrips path at all."""
    out = []
    start = 0  # index where the current strip begins
    for k in range(len(idx)):
        if int(idx[k]) < 0:
            start = k + 1
            continue
        if k - start < 2:
            continue
        a, b, c = int(idx[k - 2]), int(idx[k - 1]), int(idx[k])
        if a == b or b == c or a == c:
            continue
        flip = (k - start) % 2  # odd strip-local triangles flip winding
        out.append((a, c, b) if flip else (a, b, c))
    return out


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
    strip_count_type = "int"
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
            elif cur_element == "tristrips":
                strip_count_type = t[2]

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
        for i in range(n_vertex + n_face, n_vertex + n_face + n_strips):
            t = [int(v) for v in text[i].split()]
            faces.extend(_decode_tristrip(t[1:]))
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
        strip_cnt_dt = np.dtype(endian + type_map[strip_count_type])
        strips = []
        for _ in range(n_strips):
            cnt = int(np.frombuffer(body, strip_cnt_dt, 1, pos)[0])
            pos += strip_cnt_dt.itemsize
            idx = np.frombuffer(body, np.dtype(endian + "i4"), cnt, pos)
            pos += 4 * cnt
            strips.extend(_decode_tristrip(idx))
        indices = np.concatenate([np.asarray(faces, np.int64).reshape(-1, 3),
                                  np.asarray(strips, np.int64).reshape(-1, 3)]).astype(np.int32)

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
