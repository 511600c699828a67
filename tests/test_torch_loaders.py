"""The port's scene-file loaders against tinsel_tpu's, on every scene file
in the repository: the host scene each loader builds and its flattened
arrays must be equal bit for bit, the rotation quaternions within 1e-6:
the camera's look-at quaternion goes through rsqrt and a Tungsten
primitive's Euler quaternion through sin and cos, which XLA and PyTorch
may round differently in the last bit (measured: one ulp of a cosine in
veach_mis.json).

Scenes whose meshes or probes lie outside the repository skip, as
tests/test_scenes.py skips them.
"""

import dataclasses
import glob
import os
import re

import numpy as np
import pytest
import torch

from tinsel_tpu.scene import model as jmodel
from tinsel_tpu.scene.loaders import mesh_io as jmesh_io
from tinsel_tpu.scene.loaders.tin import load_tin as jload_tin
from tinsel_tpu.scene.loaders.tungsten import load_tungsten as jload_tungsten
from tinsel_tpu_torch.scene.loaders import mesh_io as tmesh_io
from tinsel_tpu_torch.scene.loaders.tin import load_tin as tload_tin
from tinsel_tpu_torch.scene.loaders.tungsten import load_tungsten as tload_tungsten

from torch_parity import scene_to_numpy

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE_FILES = sorted(
    glob.glob(os.path.join(ROOT, "scenes", "*.tin"))
    + glob.glob(os.path.join(ROOT, "scenes", "*.json"))
    + glob.glob(os.path.join(ROOT, "tests", "data", "*_parity.tin"))
)
ROT_TOL = 1e-6


def missing_assets(path):
    """Mesh and probe files a scene names that are not on disk (relative
    to the scene file, includes followed)."""
    base = os.path.dirname(path)
    text = open(path).read()
    if path.endswith(".json"):
        names = re.findall(r'"file"\s*:\s*"([^"]+)"', text)
    else:
        names = re.findall(r"^\s*(?:mesh|probe)\s+(\S+\.\w+)\s*$", text, re.M)
        for inc in re.findall(r"^\s*include\s+(\S+)", text, re.M):
            names += [os.path.join(os.path.dirname(inc), n)
                      for n in missing_assets(os.path.join(base, inc))]
    return [n for n in names if not os.path.exists(os.path.join(base, n))]


def scene_id(path):
    return os.path.relpath(path, ROOT)


def load_both(path, tmp_path, monkeypatch):
    """(JAX scene, port scene), each package's mesh cache in its own
    directory under tmp_path."""
    missing = missing_assets(path)
    if missing:
        pytest.skip(f"needs assets outside the repository: {missing}")
    monkeypatch.setattr(jmesh_io, "_CACHE_DIR", str(tmp_path / "jax_cache"))
    monkeypatch.setattr(tmesh_io, "_CACHE_DIR", str(tmp_path / "torch_cache"))
    if path.endswith(".json"):
        return jload_tungsten(path), tload_tungsten(path)
    return jload_tin(path), tload_tin(path)


def assert_same_fields(a, b, what, skip=()):
    for f in dataclasses.fields(b):
        if f.name in skip:
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(a, jmodel.HostTransform) and f.name == "q":
            np.testing.assert_allclose(y, x, rtol=0, atol=ROT_TOL, err_msg=f"{what}.q")
            continue
        if isinstance(y, np.ndarray) or isinstance(x, np.ndarray):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x), err_msg=f"{what}.{f.name}")
        elif dataclasses.is_dataclass(y) or y is None:
            continue
        else:
            assert x == y or (x != x and y != y), (what, f.name, x, y)


def assert_host_scenes_equal(js, ts):
    assert_same_fields(js.options, ts.options, "options")
    assert_same_fields(js.camera, ts.camera, "camera", skip=("rotation",))
    np.testing.assert_allclose(ts.camera.rotation, js.camera.rotation, rtol=0, atol=ROT_TOL)
    assert_same_fields(js.sky, ts.sky, "sky")
    assert (js.sky.probe is None) == (ts.sky.probe is None)
    if ts.sky.probe is not None:
        assert_same_fields(js.sky.probe, ts.sky.probe, "probe")
    assert len(ts.primitives) == len(js.primitives)
    meshes = {}
    for k, (jp, tp) in enumerate(zip(js.primitives, ts.primitives)):
        what = f"primitives[{k}]"
        assert_same_fields(jp, tp, what)
        assert_same_fields(jp.start_transform, tp.start_transform, what + ".start")
        assert (jp.end_transform is None) == (tp.end_transform is None)
        if tp.end_transform is not None:
            assert_same_fields(jp.end_transform, tp.end_transform, what + ".end")
        assert_same_fields(jp.material, tp.material, what + ".material")
        assert (jp.mesh is None) == (tp.mesh is None)
        if tp.mesh is not None:
            # instancing: one port mesh object per JAX mesh object
            assert meshes.setdefault(id(jp.mesh), id(tp.mesh)) == id(tp.mesh)
            assert_same_fields(jp.mesh, tp.mesh, what + ".mesh")
            if tp.mesh.bvh is not None:
                assert_same_fields(jp.mesh.bvh, tp.mesh.bvh, what + ".mesh.bvh")


@pytest.mark.parametrize("path", SCENE_FILES, ids=scene_id)
def test_loaded_scene_matches_jax(path, tmp_path, monkeypatch):
    js, ts = load_both(path, tmp_path, monkeypatch)
    assert_host_scenes_equal(js, ts)
    (ja, jstatic), (ta, tstatic) = scene_to_numpy(js.flatten()), scene_to_numpy(
        ts.flatten(device="cpu"))
    assert ta.keys() == ja.keys()
    for k in ja:
        a, b = ja[k], ta[k]
        if k in ("prims.start_q", "prims.end_q"):
            np.testing.assert_allclose(b, a, rtol=0, atol=ROT_TOL, err_msg=k)
            continue
        if a.dtype == np.float32:
            a, b = a.view(np.uint32), b.view(np.uint32)
        np.testing.assert_array_equal(b, a, err_msg=k)
    assert tstatic == jstatic


def test_every_scene_file_is_listed():
    """The corpus the parametrisation covers: 20 .tin scenes, 2 Tungsten
    files and 4 parity scenes."""
    names = [scene_id(p) for p in SCENE_FILES]
    assert len(names) == 26, names
    assert {"scenes/veach_mis.json", "scenes/tungsten_box.json",
            "tests/data/cornell_parity.tin"} <= set(names)
    # only these six read assets from outside the repository
    assert {os.path.basename(p) for p in SCENE_FILES if missing_assets(p)} <= {
        "ajax.tin", "ajaxenv.tin", "env_parity.tin", "meshlight_parity.tin",
        "sportscar.tin", "table.tin"}


def test_look_at_and_euler_quaternions_match_jax():
    """The host math the loaders call, on CPU f32 tensors, against the JAX
    package's jnp versions: rotations within 1e-6, the rest exact."""
    import jax.numpy as jnp

    from tinsel_tpu.core import math as jm
    from tinsel_tpu_torch.core import math as tm

    rng = np.random.default_rng(5)
    for _ in range(20):
        eye, target = rng.normal(size=3).astype(np.float32), rng.normal(size=3).astype(np.float32)
        a = np.array(jm.look_at_matrix(jnp.asarray(eye), jnp.asarray(target)))
        b = tm.look_at_matrix(torch.from_numpy(eye), torch.from_numpy(target)).numpy()
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(
            tm.mat44_affine_inverse(torch.from_numpy(a)).numpy()[:3, :3],
            np.asarray(jm.mat44_affine_inverse(jnp.asarray(a)))[:3, :3])
        qa = np.asarray(jm.quat_from_matrix3(jnp.asarray(a[:3, :3])))
        qb = tm.quat_from_matrix3(torch.from_numpy(a[:3, :3])).numpy()
        np.testing.assert_allclose(qb, qa, rtol=0, atol=ROT_TOL)
        ang = float(rng.uniform(-4, 4))
        axis = rng.normal(size=3).astype(np.float32)
        qa = np.asarray(jm.quat_from_axis_angle(jnp.asarray(axis), ang))
        qb = tm.quat_from_axis_angle(torch.from_numpy(axis), ang).numpy()
        np.testing.assert_allclose(qb, qa, rtol=0, atol=ROT_TOL)
        p, q = rng.normal(size=(2, 4)).astype(np.float32)
        np.testing.assert_array_equal(
            tm.quat_mul(torch.from_numpy(p), torch.from_numpy(q)).numpy(),
            np.asarray(jm.quat_mul(jnp.asarray(p), jnp.asarray(q))))
    # every pivot of quat_from_matrix3: rotations by pi about each axis
    for axis in np.eye(3, dtype=np.float32):
        for ang in (0.3, np.pi):
            qa = np.asarray(jm.quat_from_axis_angle(jnp.asarray(axis), ang))
            m = _rot(qa)
            np.testing.assert_allclose(tm.quat_from_matrix3(torch.from_numpy(m)).numpy(),
                                       np.asarray(jm.quat_from_matrix3(jnp.asarray(m))),
                                       rtol=0, atol=ROT_TOL)


def _rot(q):
    x, y, z, w = (float(c) for c in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def test_mesh_helpers_match_jax():
    """HostTransform.copy and Mesh.normalize / transform / add_mesh, as the
    importer and scene code call them, on the same seeded mesh."""
    from tinsel_tpu.scene import model as jmodel
    from tinsel_tpu_torch.scene import model as tmodel

    rng = np.random.default_rng(8)
    pos = (rng.normal(size=(40, 3)) * 3 + 1).astype(np.float32)
    idx = rng.integers(0, 40, (30, 3)).astype(np.int32)
    nrm = rng.normal(size=(40, 3)).astype(np.float32)
    mat = np.eye(4)
    mat[:3, :3] = _rot(np.array([0.2, 0.5, -0.3, 0.8]) / np.linalg.norm([0.2, 0.5, -0.3, 0.8]))
    mat[:3, 3] = [1.0, -2.0, 0.5]
    out = []
    for model in (jmodel, tmodel):
        a = model.Mesh(positions=pos.copy(), indices=idx.copy(), normals=nrm.copy())
        b = model.Mesh(positions=pos[:7] * 2, indices=idx[:5] % 7, normals=nrm[:7])
        a.normalize(2.5)
        a.transform(mat)
        a.add_mesh(b)
        c = model.Mesh(positions=pos[:5], indices=idx[:3] % 5)
        c.add_mesh(b)  # one side without normals: none kept
        t = model.HostTransform(p=pos[0], q=np.array([0, 0, 0, 1], np.float32), s=2.0)
        u = t.copy()
        u.p[0] = 99.0
        out.append((a, c, t))
    for j, t in zip(out[0][:2], out[1][:2]):
        for f in ("positions", "indices", "normals"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    assert out[1][2].p[0] == pos[0, 0] and out[0][2].p[0] == pos[0, 0]
