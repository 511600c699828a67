"""The port's BVH builder and big-mesh flatten against tinsel_tpu's,
bit for bit.

Every comparison takes the JAX package's NumPy builder (``use_native=False``
or meshes under 4,096 triangles): its native C++ builder makes other, equally
valid trees.
"""

import numpy as np
import pytest

from tinsel_tpu.accel import build as jbuild
from tinsel_tpu.scene import model as jmodel
from tinsel_tpu.scene import presets as jpresets
from tinsel_tpu_torch.accel import build as tbuild
from tinsel_tpu_torch.scene import model as tmodel
from tinsel_tpu_torch.scene import presets as tpresets
from tinsel_tpu_torch.scene import procedural as tproc


def _soup(n, seed):
    """n random triangles of mixed sizes in a 20-unit cube: an unbalanced
    tree with deep stacks."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-10, 10, (n, 1, 3))
    size = rng.choice([0.05, 0.5, 3.0], (n, 1, 1))
    pos = (c + rng.normal(size=(n, 3, 3)) * size).reshape(-1, 3).astype(np.float32)
    return pos, np.arange(3 * n, dtype=np.int32).reshape(n, 3)


def _meshes():
    sph = tproc.sphere(1.0, 20, 40)
    cap = tproc.capsule(0.5, 0.5, 10, 20)
    return {
        "sphere": (sph.positions, sph.indices),
        "capsule": (cap.positions, cap.indices),
        "soup": _soup(900, 3),
        "fan17": (tproc.disc(1.0, 17).positions, tproc.disc(1.0, 17).indices),
        "one_leaf": _soup(11, 4),
    }


MESHES = _meshes()


@pytest.mark.parametrize("method", ["sah", "median", "midpoint"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_build_matches_jax(mesh, method):
    pos, idx = MESHES[mesh]
    lo, hi = tbuild.triangle_bounds(pos, idx)
    a = tbuild.build_bvh(lo, hi, method=method)
    b = jbuild.build_bvh(lo, hi, use_native=False, method=method)
    for f in ("lower", "upper", "left", "right", "leaf", "count", "perm"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    wa, wb = tbuild.build_wide_bvh(a), jbuild.build_wide_bvh(b, use_native=False)
    np.testing.assert_array_equal(wa.node_rows.view(np.uint32), wb.node_rows.view(np.uint32))
    np.testing.assert_array_equal(wa.perm_padded, wb.perm_padded)
    np.testing.assert_array_equal(wa.real_mask, wb.real_mask)
    np.testing.assert_array_equal(wa.root_lower, wb.root_lower)
    np.testing.assert_array_equal(wa.root_upper, wb.root_upper)
    assert tbuild.wide_stack_bound(wa) == jbuild.wide_stack_bound(wb)
    assert tbuild.validate_wide_bvh(wa, lo, hi, len(idx))


def test_bf16_packing_matches_jax_and_contains_the_box():
    rng = np.random.default_rng(0)
    lo = np.concatenate([rng.normal(size=5000) * 10.0 ** rng.integers(-3, 4, 5000),
                         [0.0, -0.0, 1.0, -1.0, 1e-30]]).astype(np.float32)
    hi = (lo + np.abs(rng.normal(size=lo.size)).astype(np.float32)).astype(np.float32)
    p = tbuild._bf16_pack_bounds(lo, hi)
    np.testing.assert_array_equal(p, jbuild._bf16_pack_bounds(lo, hi))
    ulo, uhi = tbuild._bf16_unpack_bounds(p)
    assert np.all(ulo <= lo) and np.all(uhi >= hi)
    jlo, jhi = jbuild._bf16_unpack_bounds(p)
    np.testing.assert_array_equal(ulo, jlo)
    np.testing.assert_array_equal(uhi, jhi)


def _big_scene(model, presets, proc):
    sc = presets.cornell_scene(16, 16, 2)
    sph = proc.sphere(0.3, 12, 24)
    for k, p in enumerate(([0.2, 0.4, 0.1], [-0.3, 0.5, 0.2])):  # instanced twice
        sc.add_primitive(model.Primitive(
            type=model.MESH, mesh=sph,
            start_transform=model.HostTransform(p=np.array(p, np.float32), s=0.5 + 0.2 * k),
        ))
    sc.add_primitive(model.Primitive(type=model.MESH, mesh=proc.capsule(0.2, 0.2, 6, 10)))
    return sc


@pytest.mark.parametrize("kind", ["cornell+meshes", "instances", "many_mesh", "envmesh"])
def test_big_mesh_flatten_matches_jax(kind):
    from tinsel_tpu.scene import procedural as jproc

    if kind == "cornell+meshes":
        jf = _big_scene(jmodel, jpresets, jproc).flatten()
        tf = _big_scene(tmodel, tpresets, tproc).flatten(device="cpu")
    else:
        name, args = {
            "instances": ("instances_scene", (8, 8, 2)),
            "many_mesh": ("many_mesh_scene", (14, 8, 8, 2)),
            "envmesh": ("envmesh_scene", (8, 8, 2, 20)),
        }[kind]
        jf = getattr(jpresets, name)(*args).flatten()
        tf = getattr(tpresets, name)(*args).flatten(device="cpu")
    np.testing.assert_array_equal(
        tf.pool.node_rows.numpy().view(np.uint32), np.asarray(jf.pool.node_rows).view(np.uint32)
    )
    np.testing.assert_array_equal(tf.pool.block_rows.numpy(), np.asarray(jf.pool.block_rows))
    np.testing.assert_array_equal(tf.pool.tri_cdf.numpy(), np.asarray(jf.pool.tri_cdf))
    for a, b in zip(tf.pool.nrm_planes, jf.pool.nrm_planes, strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tf.materials.color.numpy(), np.asarray(jf.materials.color))
    for tp, jp in zip(tf.prim_static, jf.prim_static, strict=True):
        assert (tp.mesh is None) == (jp.mesh is None)
        if tp.mesh is not None:
            for name in ("node_offset", "num_nodes", "tri_offset", "num_tris", "real_tris",
                         "area", "root_lower", "root_upper", "stack_slots"):
                assert getattr(tp.mesh, name) == getattr(jp.mesh, name), name


def test_flatten_refuses_a_stack_deeper_than_128(monkeypatch):
    """The stack-slot limit: a mesh whose walk would need more than 128
    entries is refused at flatten, as the JAX package refuses it."""
    sc = tpresets.cornell_scene(8, 8, 1)
    sc.add_primitive(tmodel.Primitive(type=tmodel.MESH, mesh=tproc.sphere(1.0, 8, 16)))
    monkeypatch.setattr(tmodel, "wide_stack_bound", lambda wide: 129)
    with pytest.raises(ValueError, match="129 traversal stack slots"):
        sc.flatten(device="cpu")


def test_envmesh_probe_names_its_slice():
    """envmesh_scene(probe=True) is ported (slice 4): the JAX package's
    scene, its test probe bit for bit. Loading a probe from a file needs
    the HDR readers, which are slice 5, and says so."""
    from tinsel_tpu_torch.scene.probe_io import load_probe

    j = jpresets.envmesh_scene(8, 8, 1, detail=4, probe=True)
    t = tpresets.envmesh_scene(8, 8, 1, detail=4, probe=True)
    for k in ("data", "pdf_x", "cdf_x", "pdf_y", "cdf_y"):
        np.testing.assert_array_equal(getattr(t.sky.probe, k), getattr(j.sky.probe, k))
    np.testing.assert_array_equal(t.primitives[0].mesh.positions, j.primitives[0].mesh.positions)
    with pytest.raises(NotImplementedError, match="slice 5"):
        load_probe("probe.pfm")
