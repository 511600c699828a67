"""The port's gradient step: against tinsel_tpu's at equal draws, against
central finite differences of the port itself (following
tests/test_gradients.py), and the inverse-rendering trainer.

A render is a deterministic function of its parameters and its draws, so
central differences on the same draws match autodiff wherever no discrete
sampling decision flips inside the step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinsel_tpu.diff.gradients import render_loss_and_grads as jrender_loss_and_grads
from tinsel_tpu.render.camera import CameraParams as JCam
from tinsel_tpu.scene.presets import cornell_scene as jcornell
from tinsel_tpu_torch.core.sampling import NumpyUniforms, Prefixed
from tinsel_tpu_torch.diff.gradients import (
    linear_image,
    render_loss,
    render_loss_and_grads,
    render_loss_and_grads_scan,
)
from tinsel_tpu_torch.render.camera import CameraParams
from tinsel_tpu_torch.render.renderer import render_pass
from tinsel_tpu_torch.scene import model as tmodel
from tinsel_tpu_torch.scene.presets import cornell_scene

from torch_parity import JaxUniforms

torch.set_num_threads(2)


def _leaves(g_mats, g_cam):
    return {f"materials.{f.name}": getattr(g_mats, f.name) for f in dataclasses.fields(g_mats)} | {
        f"camera.{f.name}": getattr(g_cam, f.name) for f in dataclasses.fields(g_cam)
    }


@pytest.fixture(scope="module")
def jax_grads():
    """tinsel_tpu's loss and gradients on cornell 16x16, depth 2, key 42,
    target 0.25 (one compile, shared)."""
    w = h = 16
    sc = jcornell(w, h, 2)
    key = jax.random.key(42)
    target = jnp.full((h, w, 3), 0.25, jnp.float32)
    loss, (gm, gc) = jax.jit(
        lambda f, c, k, t: jrender_loss_and_grads(f, c, k, t, width=w, height=h, max_depth=2)
    )(sc.flatten(), JCam.from_host(sc.camera), key, target)
    return float(loss), {k: np.asarray(v) for k, v in _leaves(gm, gc).items()}, key


def test_loss_and_grads_match_jax(jax_grads):
    """Loss within 1e-5 relative; every gradient leaf within 1e-3 of its
    largest entry (f32 sums of the backward in another order; measured
    worst 2e-4, clearcoat)."""
    j_loss, j_grads, key = jax_grads
    sc = cornell_scene(16, 16, 2)
    loss, (gm, gc) = render_loss_and_grads(
        sc.flatten(device="cpu"), CameraParams.from_host(sc.camera, device="cpu"),
        JaxUniforms(key), torch.full((16, 16, 3), 0.25), width=16, height=16, max_depth=2,
    )
    assert abs(float(loss) - j_loss) <= 1e-5 * abs(j_loss)
    grads = _leaves(gm, gc)
    assert grads.keys() == j_grads.keys()
    for name, g in grads.items():
        want = j_grads[name]
        assert g.shape == want.shape, name
        scale = max(float(np.abs(want).max()), 1e-12)
        assert float(np.abs(g.numpy() - want).max()) / scale <= 1e-3, name
    assert float(gm.color.abs().max()) > 0 and float(gc.position.abs().max()) > 0


def _old_select(mats, i):
    """MaterialsFlat.select before the one-hot backward: advanced indexing,
    whose backward is the accumulating index_put."""
    i = i.long()
    return {f.name: getattr(mats, f.name)[i] for f in dataclasses.fields(mats)}


def _materials_and_lanes(n_lanes=5000, seed=0):
    sc = cornell_scene(8, 8, 1)
    sc.add_primitive(tmodel.Primitive(type=tmodel.SPHERE, radius=0.1, material=tmodel.Material(
        color=np.array([0.1, 0.2, 0.3], np.float32), eta=1.33, transmission=0.4)))
    mats = sc.flatten(device="cpu").materials
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, mats.color.shape[0], n_lanes))
    return mats, idx, rng


@pytest.mark.parametrize("shape", [(5000,), (40, 25)])
def test_material_select_forward_is_the_old_gather_bit_for_bit(shape):
    mats, idx, _ = _materials_and_lanes(int(np.prod(shape)))
    new = mats.select(idx.reshape(shape).int())
    for name, want in _old_select(mats, idx.reshape(shape)).items():
        got = getattr(new, name)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        assert torch.equal(got, want), name


def test_material_select_backward_matches_the_old_gather():
    """The one-hot matmul backward against the accumulating index_put, on
    random upstream gradients for every field: within 1e-6 of each leaf's
    largest entry (the sums run in another order); a field whose output
    takes no gradient gets none."""
    mats, idx, rng = _materials_and_lanes()
    grads = {}
    for how in ("new", "old"):
        leaves = {f.name: getattr(mats, f.name).clone().requires_grad_(True)
                  for f in dataclasses.fields(mats)}
        m = tmodel.MaterialsFlat(**leaves)
        rows = ({f.name: getattr(m.select(idx), f.name) for f in dataclasses.fields(m)}
                if how == "new" else _old_select(m, idx))
        up = np.random.default_rng(1)
        loss = sum((rows[k] * torch.from_numpy(up.normal(size=tuple(rows[k].shape))
                                               .astype(np.float32))).sum()
                   for k in rows if k != "eta")
        grads[how] = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                                           allow_unused=True)))
    for k, want in grads["old"].items():
        got = grads["new"][k]
        if k == "eta":
            assert got is None or float(got.abs().max()) == 0.0
            continue
        scale = float(want.abs().max())
        assert scale > 0 and float((got - want).abs().max()) <= 1e-6 * scale, k


def _setup(w=24, h=24, depth=2):
    sc = cornell_scene(w, h, depth)
    flat = sc.flatten(device="cpu")
    cam = CameraParams.from_host(sc.camera, device="cpu")
    target = torch.full((h, w, 3), 0.25)
    return flat, cam, NumpyUniforms(42, "cpu"), target, dict(width=w, height=h, max_depth=depth)


def _ad_and_fd(loss_of, x0: float, step: float):
    x = torch.tensor(x0, requires_grad=True)
    (g_ad,) = torch.autograd.grad(loss_of(x), x)
    with torch.no_grad():
        g_fd = (loss_of(torch.tensor(x0 + step)) - loss_of(torch.tensor(x0 - step))) / (2 * step)
    return float(g_ad), float(g_fd)


def _with_materials(flat, **fields):
    return dataclasses.replace(flat, materials=dataclasses.replace(flat.materials, **fields))


@pytest.mark.parametrize("what", ["emission", "color"])
def test_material_gradient_matches_fd(what):
    """Scaling the light's emission, or the red wall's color (primitive
    1): neither moves a sampling decision, so the match is tight."""
    flat, cam, src, target, opts = _setup()
    row = flat.light_indices[0] if what == "emission" else 1
    base = getattr(flat.materials, what)

    def loss_of(s):
        scale = torch.ones(base.shape[0], 1).index_put((torch.tensor([row]),), s.reshape(1, 1))
        return render_loss(_with_materials(flat, **{what: base * scale}), cam, src, target, **opts)

    g_ad, g_fd = _ad_and_fd(loss_of, 1.0, 1e-2)
    tol = 0.02 if what == "emission" else 0.03
    assert g_ad != 0.0 and abs(g_ad - g_fd) <= tol * max(abs(g_fd), 1e-3), (g_ad, g_fd)


def test_roughness_gradient_matches_fd():
    """Depth 1: roughness enters only through the smooth NEE term."""
    flat, cam, src, _, opts = _setup(depth=1)

    def loss_of(s):
        r = flat.materials.roughness.clone()
        r = torch.cat([(0.4 * s).reshape(1), r[1:]])
        img = linear_image(render_pass(_with_materials(flat, roughness=r), cam, src, **opts))
        return img.mean()

    g_ad, g_fd = _ad_and_fd(loss_of, 1.0, 2e-2)
    assert g_ad != 0.0 and abs(g_ad - g_fd) <= 0.1 * max(abs(g_fd), 1e-4), (g_ad, g_fd)


def test_light_position_gradient_matches_fd():
    flat, cam, src, target, opts = _setup()
    j = flat.light_indices[0]

    def loss_of(dy):
        shift = torch.zeros_like(flat.prims.start_p)
        shift = shift.index_put((torch.tensor([j]), torch.tensor([1])), dy.reshape(1))
        prims = dataclasses.replace(flat.prims, start_p=flat.prims.start_p + shift,
                                    end_p=flat.prims.end_p + shift)
        return render_loss(dataclasses.replace(flat, prims=prims), cam, src, target, **opts)

    # a step small enough that no visibility boundary flips for these
    # draws (at 5e-3 one does, and the difference quotient jumps 5x)
    g_ad, g_fd = _ad_and_fd(loss_of, -0.2, 1e-3)
    assert g_ad != 0.0 and abs(g_ad - g_fd) <= 0.02 * max(abs(g_fd), 1e-3), (g_ad, g_fd)


def _look_at_quat(pos, target):
    """(x, y, z, w) rotation whose -z axis looks from pos at target, +y up."""
    f = (target - pos) / np.linalg.norm(target - pos)
    right = np.cross(f, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, f)
    m = np.stack([right, up, -f], axis=1)  # columns: camera x, y, z in world
    w = 0.5 * np.sqrt(1.0 + np.trace(m))
    return np.array([(m[2, 1] - m[1, 2]) / (4 * w), (m[0, 2] - m[2, 0]) / (4 * w),
                     (m[1, 0] - m[0, 1]) / (4 * w), w], np.float32)


def _smooth_camera_setup():
    """A bump-mapped plane filling the frame (the camera looks down: no
    silhouette or horizon in the image), lit at depth 1 by an out-of-frame
    sphere light: the image is a smooth function of the camera."""
    sc = tmodel.Scene()
    sc.sky = tmodel.Sky(horizon=np.zeros(3, np.float32), zenith=np.zeros(3, np.float32))
    pos = np.array([0.3, 2.0, 0.4], np.float32)
    sc.camera = tmodel.Camera(position=pos, rotation=_look_at_quat(pos, np.zeros(3)),
                              fov=float(np.deg2rad(35.0)))
    sc.add_primitive(tmodel.Primitive(
        type=tmodel.PLANE, plane=np.array([0, 1, 0, 0], np.float32),
        material=tmodel.Material(color=np.full(3, 0.7, np.float32), roughness=0.6,
                                 specular=0.3, bump=0.5, bump_tile=1.5),
    ))
    sc.add_primitive(tmodel.Primitive(
        type=tmodel.SPHERE, radius=0.4,
        start_transform=tmodel.HostTransform(p=np.array([2.5, 6.0, 1.5], np.float32)),
        material=tmodel.Material(color=np.zeros(3, np.float32),
                                 emission=np.full(3, 40.0, np.float32)),
        light_samples=1,
    ))
    flat = sc.flatten(device="cpu")
    assert flat.has_bump
    cam = CameraParams.from_host(sc.camera, device="cpu")
    return flat, cam, NumpyUniforms(21, "cpu"), torch.full((24, 24, 3), 0.3), dict(
        width=24, height=24, max_depth=1)


@pytest.mark.parametrize("what", ["position", "fov"])
def test_camera_gradient_matches_fd_on_the_bump_plane(what):
    flat, cam, src, target, opts = _smooth_camera_setup()

    def loss_of(x):
        if what == "position":
            c2 = dataclasses.replace(cam, position=cam.position + torch.stack(
                [torch.zeros(()), torch.zeros(()), x]))
        else:
            c2 = dataclasses.replace(cam, fov=x)
        return render_loss(flat, c2, src, target, **opts)

    x0 = 0.0 if what == "position" else float(cam.fov)
    g_ad, g_fd = _ad_and_fd(loss_of, x0, 1e-3)
    assert g_ad != 0.0 and abs(g_ad - g_fd) <= 0.05 * max(abs(g_fd), 1e-3), (g_ad, g_fd)


def test_aperture_and_focal_distance_gradients_finite_and_nonzero():
    sc = tmodel.Scene()
    sc.sky = tmodel.Sky(horizon=np.array([0.9, 0.5, 0.2], np.float32),
                        zenith=np.array([0.1, 0.3, 0.8], np.float32))
    sc.camera = tmodel.Camera(position=np.array([0.0, 1.5, 3.0], np.float32))
    sc.add_primitive(tmodel.Primitive(
        type=tmodel.PLANE, plane=np.array([0, 1, 0, 0], np.float32),
        material=tmodel.Material(color=np.full(3, 0.7, np.float32), roughness=0.6,
                                 specular=0.3, bump=0.4, bump_tile=2.0),
    ))
    flat = sc.flatten(device="cpu")
    cam = dataclasses.replace(CameraParams.from_host(sc.camera, device="cpu"),
                              aperture=torch.tensor(0.15), focal_distance=torch.tensor(3.0))
    _, (_, gc) = render_loss_and_grads(flat, cam, NumpyUniforms(11, "cpu"),
                                       torch.full((16, 16, 3), 0.3), width=16, height=16,
                                       max_depth=2)
    for g in (gc.aperture, gc.focal_distance):
        assert torch.isfinite(g) and float(g) != 0.0


def test_scan_is_the_mean_of_its_chunks():
    flat, cam, src, target, _ = _setup(8, 8)
    opts = dict(width=8, height=8, max_depth=2)
    loss, (gm, gc) = render_loss_and_grads_scan(flat, cam, src, target, 3, **opts)
    parts = [render_loss_and_grads(flat, cam, Prefixed(src, c), target, **opts)
             for c in range(3)]
    assert abs(float(loss) - sum(float(p[0]) for p in parts) / 3) < 1e-6
    mean = {k: sum(_leaves(*p[1])[k] for p in parts) / 3 for k in _leaves(gm, gc)}
    for k, g in _leaves(gm, gc).items():
        scale = max(float(mean[k].abs().max()), 1e-12)
        assert float((g - mean[k]).abs().max()) / scale < 1e-5, k


def test_inverse_rendering_lowers_albedo_error():
    """The trainer (tinsel_tpu_torch/examples/inverse_rendering.py) makes
    real progress at a small size: the visible-albedo error drops by more
    than a quarter in 15 steps."""
    from tinsel_tpu_torch.examples.inverse_rendering import main

    err0, err1 = main(steps=15, size=24, seed=3, device="cpu")
    assert err1 < 0.75 * err0, (err0, err1)
