"""The port's host scene model and flatten against tinsel_tpu's, exactly.

The port keeps its own copy of the host dataclasses; its flattened tensors
must equal the JAX package's arrays bit for bit on every field it produces.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tinsel_tpu.render.camera import CameraParams as JCam
from tinsel_tpu.scene import model as jmodel
from tinsel_tpu.scene import presets as jpresets
from tinsel_tpu_torch.render.camera import CameraParams as TCam
from tinsel_tpu_torch.scene import model as tmodel
from tinsel_tpu_torch.scene import presets as tpresets
from tinsel_tpu_torch.scene.convert import camera_from_numpy, scene_flat_from_numpy

from torch_parity import camera_to_numpy, scene_to_numpy

torch.set_num_threads(1)


def _fan_mesh(model, n_tris):
    """A planar fan of n_tris triangles around the origin."""
    ang = np.linspace(0.0, 1.5 * np.pi, n_tris + 1)
    ring = np.stack([np.cos(ang), 0.1 * np.sin(3 * ang), np.sin(ang)], -1)
    pos = np.concatenate([np.zeros((1, 3)), ring]).astype(np.float32)
    idx = np.array([[0, i + 1, i + 2] for i in range(n_tris)], np.int32)
    return model.Mesh(positions=pos, indices=idx)


def _scene(model, presets, kind):
    sc = presets.cornell_scene(32, 32, 4)
    if kind == "cornell+fan":
        # a second tiny mesh (5 triangles, padded to one block), instanced
        # twice, one instance moving: exercises offsets, padding, motion
        fan = _fan_mesh(model, 5)
        sc.add_primitive(model.Primitive(
            type=model.MESH, mesh=fan,
            start_transform=model.HostTransform(
                p=np.array([0.2, 0.3, 0.1], np.float32), s=0.3),
        ))
        sc.add_primitive(model.Primitive(
            type=model.MESH, mesh=fan,
            start_transform=model.HostTransform(
                p=np.array([-0.2, 0.6, 0.3], np.float32), s=0.25),
            end_transform=model.HostTransform(
                p=np.array([-0.1, 0.6, 0.3], np.float32), s=0.25),
        ))
    elif kind == "cornell+fan17":
        # 17 triangles: one more than a block, so the mesh gets a BVH
        sc.add_primitive(model.Primitive(type=model.MESH, mesh=_fan_mesh(model, 17)))
    elif kind == "cornell+bump":
        sc.primitives[0].material.bump = 0.5
    return sc


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


KINDS = ["cornell", "cornell+fan", "cornell+fan17", "cornell+bump"]


@pytest.mark.parametrize("kind", KINDS)
def test_flatten_matches_jax(kind):
    jf = _scene(jmodel, jpresets, kind).flatten()
    tf = _scene(tmodel, tpresets, kind).flatten(device="cpu")
    for group in ("prims", "materials"):
        for name, val in _fields(getattr(tf, group)).items():
            np.testing.assert_array_equal(
                val.numpy(), np.asarray(getattr(getattr(jf, group), name)),
                err_msg=f"{group}.{name}",
            )
    np.testing.assert_array_equal(tf.pool.tri_cdf.numpy(), np.asarray(jf.pool.tri_cdf))
    np.testing.assert_array_equal(
        tf.pool.node_rows.numpy().view(np.uint32), np.asarray(jf.pool.node_rows).view(np.uint32)
    )
    np.testing.assert_array_equal(tf.pool.block_rows.numpy(), np.asarray(jf.pool.block_rows))
    for key in ("tri_planes", "nrm_planes"):
        for a, b in zip(getattr(tf.pool, key), getattr(jf.pool, key), strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=key)
    for name in ("sky_horizon", "sky_zenith", "prim_type", "prim_light_samples",
                 "prim_local_area", "prim_bump"):
        np.testing.assert_array_equal(
            getattr(tf, name).numpy(), np.asarray(getattr(jf, name)), err_msg=name
        )
    assert tf.light_indices == jf.light_indices
    assert tf.has_bump == jf.has_bump == (kind == "cornell+bump")
    for tp, jp in zip(tf.prim_static, jf.prim_static, strict=True):
        assert (tp.type, tp.material_index, tp.light_samples, tp.motion) == (
            jp.type, jp.material_index, jp.light_samples, jp.motion
        )
        assert (tp.mesh is None) == (jp.mesh is None)
        if tp.mesh is not None:
            for name in ("node_offset", "num_nodes", "tri_offset", "num_tris",
                         "real_tris", "area", "root_lower", "root_upper", "stack_slots"):
                assert getattr(tp.mesh, name) == getattr(jp.mesh, name), name


def test_cornell_quad_padding():
    """The quad light: triangles in order, padded with the last one; the
    area CDF padded with 1.0 (tinsel_tpu: perm_padded = [0, 1, 1, ..., 1])."""
    tf = tpresets.cornell_scene(32, 32, 4).flatten(device="cpu")
    cdf = tf.pool.tri_cdf.numpy()
    np.testing.assert_array_equal(cdf, [0.5] + [1.0] * 15)
    v0x = tf.pool.tri_planes[0].numpy()
    assert np.all(v0x[1:] == v0x[1]) and v0x.shape == (16,)
    h = tf.prim_static[5].mesh
    assert (h.real_tris, h.num_tris, h.root_lower[1], h.root_upper[1]) == (2, 16, 0.0, 0.0)


@pytest.mark.parametrize("kind", KINDS)
def test_scene_flat_from_numpy_round_trips(kind):
    jf = _scene(jmodel, jpresets, kind).flatten()
    tf = _scene(tmodel, tpresets, kind).flatten(device="cpu")
    arrays, static = scene_to_numpy(jf)
    cf = scene_flat_from_numpy(arrays, static, device="cpu")
    for group in ("prims", "materials"):
        for name, val in _fields(getattr(cf, group)).items():
            assert torch.equal(val, getattr(getattr(tf, group), name)), name
    for key in ("tri_planes", "nrm_planes"):
        for a, b in zip(getattr(cf.pool, key), getattr(tf.pool, key), strict=True):
            assert torch.equal(a, b)
    assert torch.equal(cf.pool.tri_cdf, tf.pool.tri_cdf)
    assert torch.equal(cf.pool.block_rows, tf.pool.block_rows)
    assert torch.equal(cf.pool.node_rows.view(torch.int32), tf.pool.node_rows.view(torch.int32))
    for name in ("prim_type", "prim_light_samples", "prim_local_area", "prim_bump"):
        assert torch.equal(getattr(cf, name), getattr(tf, name))
    assert cf.prim_static == tf.prim_static
    assert cf.light_indices == tf.light_indices
    assert cf.has_bump == tf.has_bump


def test_camera_from_numpy_matches_from_host():
    cam = jpresets.cornell_scene(8, 8, 1).camera
    a = camera_from_numpy(camera_to_numpy(JCam.from_host(cam)), device="cpu")
    b = TCam.from_host(tpresets.cornell_scene(8, 8, 1).camera, device="cpu")
    for name, val in _fields(a).items():
        assert torch.equal(val, getattr(b, name)), name


@pytest.mark.parametrize("what", ["probe"])
def test_flatten_refuses_later_slices(what):
    """HDR probes flatten since slice 4 (as big meshes and bump maps since
    slice 3): the probe tables and the light pmf equal the JAX package's
    bit for bit. What is still refused is a later slice's: loading a probe
    from a file (the HDR readers, slice 5)."""
    from tinsel_tpu.scene.probe_io import create_test_probe as jprobe

    from tinsel_tpu_torch.scene.probe_io import create_test_probe, load_probe

    js, ts = jpresets.cornell_scene(8, 8, 1), tpresets.cornell_scene(8, 8, 1)
    js.sky.probe, ts.sky.probe = jprobe(16, 8), create_test_probe(16, 8)
    jf, tf = js.flatten(), ts.flatten(device="cpu")
    for f in dataclasses.fields(jf.probe):
        np.testing.assert_array_equal(getattr(tf.probe, f.name).numpy(),
                                      np.asarray(getattr(jf.probe, f.name)))
    np.testing.assert_array_equal(tf.light_pmf.numpy(), np.asarray(jf.light_pmf))
    with pytest.raises(NotImplementedError, match="slice 5"):
        load_probe(f"{what}.hdr")
