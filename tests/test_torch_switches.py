"""The JAX package's module switches in the port, held to tinsel_tpu at
equal draws and to jax.grad, on the CPU:

* ``render/lights.py::NEE_CLOSEST_SHADOW`` (the reference's closest-hit
  shadow estimator),
* ``render/trace.py::MESH_VERTEX_GRADS`` (gradients into the pool's vertex
  and normal planes, through ``MeshPool``'s gathers),
* ``render/trace.py::STATIC_TRANSFORM_HOIST`` (static primitives
  interpolated too, so ``end_*`` get gradients).

Each test sets a switch on both packages with ``monkeypatch`` (the JAX
package is read, never edited) and jits the JAX side afresh, since a jit
traced under one setting keeps its branch. Image parity (b) is
``assert_pass_matches``; gradients hold the loss within 1e-5 relative
and each leaf within 1e-3 of its largest entry, as
``test_torch_gradients.py::test_loss_and_grads_match_jax`` does.

Also here: a guard that every upper-case module constant and every
parameter of a public function of tinsel_tpu has a counterpart in the
port or a recorded reason, the two parameters it found
(``tonemap_filmic(limit=)``, ``render(report_every=)``), and the gradient
of the probe's texels.
"""

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinsel_tpu.core import color as jcolor
from tinsel_tpu.diff.gradients import render_loss as jrender_loss
from tinsel_tpu.render import lights as jlights
from tinsel_tpu.render import renderer as jrenderer
from tinsel_tpu.render import trace as jtrace
from tinsel_tpu.render.camera import CameraParams as JCam
from tinsel_tpu.scene import model as jmodel
from tinsel_tpu.scene import presets as jpresets
from tinsel_tpu_torch.accel import sweep as plain
from tinsel_tpu_torch.accel.traverse import ONEHOT_ROWS, MeshPool
from tinsel_tpu_torch.core import color as tcolor
from tinsel_tpu_torch.core.sampling import NumpyUniforms
from tinsel_tpu_torch.diff.gradients import render_loss
from tinsel_tpu_torch.ops import sweep as ops_sweep
from tinsel_tpu_torch.render import lights as tlights
from tinsel_tpu_torch.render import renderer as trenderer
from tinsel_tpu_torch.render import trace as ttrace
from tinsel_tpu_torch.render.camera import CameraParams as TCam
from tinsel_tpu_torch.scene import model as tmodel
from tinsel_tpu_torch.scene import presets as tpresets

from test_torch_lightsampling import _two_lights
from test_torch_sweep import _load
from torch_parity import JaxUniforms, assert_pass_matches, check_scene_file, jax_render_pass

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
GRAD_TOL = 1e-3


def _set(monkeypatch, name, value):
    """One switch, on both packages."""
    jmod, tmod = {"NEE_CLOSEST_SHADOW": (jlights, tlights),
                  "MESH_VERTEX_GRADS": (jtrace, ttrace),
                  "STATIC_TRANSFORM_HOIST": (jtrace, ttrace)}[name]
    monkeypatch.setattr(jmod, name, value)
    monkeypatch.setattr(tmod, name, value)


def _pass_pair(js, ts, seed, **kw):
    """(JAX pass, port pass) at equal draws, one spp."""
    key = jax.random.key(seed)
    a = jax_render_pass(js.flatten(), JCam.from_host(js.camera), key, **kw)
    b = trenderer.render_pass(ts.flatten(device="cpu"), TCam.from_host(ts.camera, device="cpu"),
                              JaxUniforms(key), **kw).numpy()
    return a, b


# ------------------------------------------------ (b) at equal draws


PASS_CASES = {
    # name: (the scene made from a package's (model, presets), pass options)
    "cornell": (lambda m, p: p.cornell_scene(32, 32, 2), {}),
    "two_lights_power": (_two_lights, dict(light_sampling="power")),
    # 19 meshes, 13 of them big (every third is a 4-triangle tetrahedron,
    # swept): one above INSTANCE_TOPK_MIN, so the shadow rays' closest hits
    # run the shortlist rounds
    "many_mesh19": (lambda m, p: p.many_mesh_scene(19, 16, 16, 2), {}),
}


@pytest.mark.parametrize("name", list(PASS_CASES))
def test_closest_shadow_pass_matches_jax(name, monkeypatch):
    _set(monkeypatch, "NEE_CLOSEST_SHADOW", True)
    build, extra = PASS_CASES[name]
    js, ts = build(jmodel, jpresets), build(tmodel, tpresets)
    o = ts.options
    kw = dict(width=o.width, height=o.height, max_depth=o.max_depth, filter_type=o.filter_type,
              filter_width=o.filter_width, filter_falloff=o.filter_falloff, **extra)
    rounds = []
    if name == "many_mesh19":
        assert len(plain.layout(ts.flatten(device="cpu").prim_static).big) > \
            ttrace.INSTANCE_TOPK_MIN
        real = ttrace._instance_rounds
        monkeypatch.setattr(ttrace, "_instance_rounds",
                            lambda *a: rounds.append(1) or real(*a))
    a, b = _pass_pair(js, ts, 8, **kw)
    assert_pass_matches(a, b)
    if name == "many_mesh19":  # the path's and the shadow ray's, each bounce
        assert len(rounds) == 2 * kw["max_depth"]
    assert a[..., :3].mean() > 1e-3


def test_closest_shadow_changes_the_estimate(monkeypatch):
    """The switch reaches the port: the same draws give another image
    under each estimator (they differ where a shadow ray epsilon-misses its
    light or meets another emitter within the tolerance)."""
    ts = tpresets.cornell_scene(16, 16, 1)
    flat, cam = ts.flatten(device="cpu"), TCam.from_host(ts.camera, device="cpu")
    kw = dict(width=16, height=16, max_depth=1)
    imgs = []
    for closest in (False, True):
        monkeypatch.setattr(tlights, "NEE_CLOSEST_SHADOW", closest)
        imgs.append(trenderer.render_pass(flat, cam, NumpyUniforms(2, "cpu"), **kw))
    assert not torch.equal(*imgs)
    assert float((imgs[0] - imgs[1]).abs().mean()) < 0.05 * float(imgs[0][..., :3].mean())


def test_closest_shadow_veach_mis_matches_jax(tmp_path, monkeypatch):
    """veach_mis.json, held to the JAX package's own one-ulp self-agreement
    (``check_scene_file(ill_conditioned=True)``)."""
    _set(monkeypatch, "NEE_CLOSEST_SHADOW", True)
    check_scene_file("veach_mis.json", tmp_path, monkeypatch, seed=3, ill_conditioned=True)


def test_hoist_off_pass_matches_jax_on_motionblur(tmp_path, monkeypatch):
    _set(monkeypatch, "STATIC_TRANSFORM_HOIST", False)
    check_scene_file("motionblur", tmp_path, monkeypatch, seed=4)


def test_hoist_off_pass_matches_jax_on_cornell(monkeypatch):
    _set(monkeypatch, "STATIC_TRANSFORM_HOIST", False)
    js, ts = jpresets.cornell_scene(32, 32, 2), tpresets.cornell_scene(32, 32, 2)
    a, b = _pass_pair(js, ts, 9, width=32, height=32, max_depth=2)
    assert_pass_matches(a, b)


# ------------------------------------------------ gradients vs jax.grad


def _planes(flat):
    pool = flat.pool
    return {**{f"tri_planes[{k}]": p for k, p in enumerate(pool.tri_planes)},
            **{f"nrm_planes[{k}]": p for k, p in enumerate(pool.nrm_planes)}}


def _with_planes(flat, leaves):
    pool = dataclasses.replace(
        flat.pool, tri_planes=tuple(leaves[f"tri_planes[{k}]"] for k in range(9)),
        nrm_planes=tuple(leaves[f"nrm_planes[{k}]"] for k in range(9)))
    return dataclasses.replace(flat, pool=pool)


TRANSFORM_FIELDS = ("start_p", "start_q", "start_s", "end_p", "end_q", "end_s")


def _transforms(flat):
    return {f: getattr(flat.prims, f) for f in TRANSFORM_FIELDS}


def _with_transforms(flat, leaves):
    return dataclasses.replace(flat, prims=dataclasses.replace(flat.prims, **leaves))


def _materials_camera(both):
    flat, cam = both
    return {**{f"materials.{f.name}": getattr(flat.materials, f.name)
               for f in dataclasses.fields(flat.materials)},
            **{f"camera.{f.name}": getattr(cam, f.name) for f in dataclasses.fields(cam)}}


def _grads_pair(js, ts, get, put, seed=42, on_camera=False, **opts):
    """(JAX loss, JAX grads, port loss, port grads) of the L2 loss against
    0.25 at equal draws, with respect to the leaves ``get(flat)`` (a dict;
    ``get((flat, cam))`` with ``on_camera``) put back by ``put``. The
    port's leaves are clones of its own tensors; the JAX side is jitted
    here, under the switches as they are set now."""
    w, h = opts["width"], opts["height"]
    key = jax.random.key(seed)
    jflat, jcam = js.flatten(), JCam.from_host(js.camera)
    tflat, tcam = ts.flatten(device="cpu"), TCam.from_host(ts.camera, device="cpu")

    def jloss(leaves):
        f, c = put((jflat, jcam), leaves) if on_camera else (put(jflat, leaves), jcam)
        return jrender_loss(f, c, key, jnp.full((h, w, 3), 0.25, jnp.float32), **opts)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(get((jflat, jcam)) if on_camera else get(jflat))
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in (get((tflat, tcam)) if on_camera else get(tflat)).items()}
    f, c = put((tflat, tcam), leaves) if on_camera else (put(tflat, leaves), tcam)
    tl = render_loss(f, c, JaxUniforms(key), torch.full((h, w, 3), 0.25), **opts)
    tg = torch.autograd.grad(tl, list(leaves.values()), allow_unused=True)
    tg = {k: (torch.zeros_like(v) if g is None else g).numpy()
          for (k, v), g in zip(leaves.items(), tg)}
    return float(jl), {k: np.asarray(v) for k, v in jg.items()}, float(tl), tg


def _assert_grads_match(jl, jg, tl, tg):
    assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    assert tg.keys() == jg.keys()
    for name, want in jg.items():
        got = tg[name]
        assert got.shape == want.shape, name
        scale = max(float(np.abs(want).max()), 1e-12)
        assert float(np.abs(got - want).max()) / scale <= GRAD_TOL, name


VERTEX_SCENES = {
    # the light quad: light sampling and the sweep's refit
    "cornell": lambda m, p: p.cornell_scene(16, 16, 2),
    # 1,152 triangles: the big batch's refit (tri_refit in the port,
    # intersect_ray_tri in JAX)
    "envmesh": lambda m, p: p.envmesh_scene(16, 16, 2, detail=24),
}


@pytest.mark.parametrize("name", list(VERTEX_SCENES))
def test_vertex_grads_match_jax(name, monkeypatch):
    _set(monkeypatch, "MESH_VERTEX_GRADS", True)
    js, ts = (VERTEX_SCENES[name](m, p) for m, p in ((jmodel, jpresets), (tmodel, tpresets)))
    jl, jg, tl, tg = _grads_pair(js, ts, _planes, _with_planes, width=16, height=16,
                                 max_depth=2)
    _assert_grads_match(jl, jg, tl, tg)
    assert all(float(np.abs(tg[f"tri_planes[{k}]"]).max()) > 0 for k in range(9))
    assert any(float(np.abs(tg[f"nrm_planes[{k}]"]).max()) > 0 for k in range(9))


def test_vertex_grads_off_are_zero_on_both_sides(monkeypatch):
    """The planes as leaves with the switch off (the default): every
    plane's gradient is zero in both packages, materials' is not."""
    assert ttrace.MESH_VERTEX_GRADS is False and jtrace.MESH_VERTEX_GRADS is False
    js, ts = jpresets.cornell_scene(16, 16, 2), tpresets.cornell_scene(16, 16, 2)

    def get(flat):
        return {**_planes(flat), "color": flat.materials.color}

    def put(flat, leaves):
        return dataclasses.replace(_with_planes(flat, leaves), materials=dataclasses.replace(
            flat.materials, color=leaves["color"]))

    jl, jg, tl, tg = _grads_pair(js, ts, get, put, width=16, height=16, max_depth=2)
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    for k in _planes(ts.flatten(device="cpu")):
        assert not np.abs(jg[k]).any() and not np.abs(tg[k]).any(), k
    assert np.abs(tg["color"]).max() > 0 and np.abs(jg["color"]).max() > 0


@pytest.mark.parametrize("name", ["cornell", "motionblur"])
def test_hoist_off_transform_grads_match_jax(name, tmp_path, monkeypatch):
    """start_* and end_* of every primitive; a static primitive's end_*
    gradient is nonzero with the hoist off (zero with it on)."""
    _set(monkeypatch, "STATIC_TRANSFORM_HOIST", False)
    if name == "cornell":
        js, ts = jpresets.cornell_scene(16, 16, 2), tpresets.cornell_scene(16, 16, 2)
    else:
        js, ts = _load("motionblur.tin", tmp_path, monkeypatch)
    jl, jg, tl, tg = _grads_pair(js, ts, _transforms, _with_transforms, width=16, height=16,
                                 max_depth=2)
    _assert_grads_match(jl, jg, tl, tg)
    static = [i for i, ps in enumerate(ts.flatten(device="cpu").prim_static)
              if not ps.motion and ps.type != tmodel.PLANE]
    assert any(np.abs(tg["end_p"][i]).max() > 0 for i in static)


def test_closest_shadow_material_and_camera_grads_match_jax(monkeypatch):
    _set(monkeypatch, "NEE_CLOSEST_SHADOW", True)
    js, ts = jpresets.cornell_scene(16, 16, 2), tpresets.cornell_scene(16, 16, 2)

    def put(both, leaves):
        flat, cam = both
        mats = dataclasses.replace(flat.materials, **{
            k.split(".")[1]: v for k, v in leaves.items() if k.startswith("materials.")})
        cam = dataclasses.replace(cam, **{
            k.split(".")[1]: v for k, v in leaves.items() if k.startswith("camera.")})
        return dataclasses.replace(flat, materials=mats), cam

    jl, jg, tl, tg = _grads_pair(js, ts, _materials_camera, put, on_camera=True, width=16,
                                 height=16, max_depth=2)
    _assert_grads_match(jl, jg, tl, tg)
    assert np.abs(tg["materials.emission"]).max() > 0


def test_probe_texel_grads_match_jax():
    """The loss's gradient with respect to ``ProbeFlat.data`` on the
    probe-lit envmesh (probe NEE and escape-ray MIS read texels)."""
    js = jpresets.envmesh_scene(16, 16, 2, detail=16, probe=True)
    ts = tpresets.envmesh_scene(16, 16, 2, detail=16, probe=True)

    def get(flat):
        return {"probe.data": flat.probe.data}

    def put(flat, leaves):
        return dataclasses.replace(flat, probe=dataclasses.replace(flat.probe,
                                                                   data=leaves["probe.data"]))

    jl, jg, tl, tg = _grads_pair(js, ts, get, put, width=16, height=16, max_depth=2)
    _assert_grads_match(jl, jg, tl, tg)
    assert np.count_nonzero(tg["probe.data"]) > 16


def _light_vertex_loss(flat, cam, src, target, opts, plane: int, row: int):
    def loss_of(dx):
        planes = list(flat.pool.tri_planes)
        planes[plane] = planes[plane] + torch.zeros_like(planes[plane]).index_put(
            (torch.tensor([row]),), dx.reshape(1))
        pool = dataclasses.replace(flat.pool, tri_planes=tuple(planes))
        return render_loss(dataclasses.replace(flat, pool=pool), cam, src, target, **opts)

    return loss_of


def test_light_vertex_gradient_matches_fd(monkeypatch):
    """One vertex of the Cornell light quad (its first triangle's v0, moved
    in x, in the quad's plane) with MESH_VERTEX_GRADS on: autograd against
    central differences of the port, at the setup of
    ``test_torch_gradients.py::test_light_position_gradient_matches_fd``.
    The light's area and CDF are host constants in both packages, so both
    sides differentiate the same function. The step is 1e-2, not 1e-3:
    the gradient is about 2e-4, and at 1e-3 the difference of the two
    losses is a few hundred f32 ulps of the loss. (A move out of the
    plane, in y, lifts part of the quad through the ceiling 1e-4 above it:
    a jump, no derivative.)"""
    monkeypatch.setattr(ttrace, "MESH_VERTEX_GRADS", True)
    sc = tpresets.cornell_scene(24, 24, 2)
    flat, cam = sc.flatten(device="cpu"), TCam.from_host(sc.camera, device="cpu")
    row = flat.prim_static[flat.light_indices[0]].mesh.tri_offset
    loss_of = _light_vertex_loss(flat, cam, NumpyUniforms(42, "cpu"), torch.full((24, 24, 3), 0.25),
                                 dict(width=24, height=24, max_depth=2), plane=0, row=row)
    x = torch.tensor(0.0, requires_grad=True)
    (g_ad,) = torch.autograd.grad(loss_of(x), x)
    step = 1e-2
    with torch.no_grad():
        g_fd = (loss_of(torch.tensor(step)) - loss_of(torch.tensor(-step))) / (2 * step)
    g_ad, g_fd = float(g_ad), float(g_fd)
    assert g_ad != 0.0 and abs(g_ad - g_fd) <= 0.02 * abs(g_fd), (g_ad, g_fd)


# ------------------------------------- the plain sweep with the hoist off


def _sweep_case(name, tmp_path, monkeypatch):
    if name == "cornell":
        ts = tpresets.cornell_scene(32, 32, 2)
    else:
        _, ts = _load("motionblur.tin", tmp_path, monkeypatch)
    flat = ts.flatten(device="cpu")
    cam = TCam.from_host(ts.camera, device="cpu")
    from tinsel_tpu_torch.render.camera import generate_rays

    rng = np.random.default_rng(1)
    n = 48
    g = torch.arange(n, dtype=torch.float32) + 0.5
    raster = torch.stack(torch.meshgrid(g * 32 / n, g * 32 / n, indexing="xy"), -1).reshape(-1, 2)
    o, d = generate_rays(cam, 32, 32, raster, torch.zeros_like(raster))
    times = torch.from_numpy(rng.random(o.shape[0]).astype(np.float32))
    return flat, o, d, times


@pytest.mark.parametrize("name", ["cornell", "motionblur"])
def test_hoist_off_sweep_t_equals_the_refit_bit_for_bit(name, tmp_path, monkeypatch):
    """With every sphere and instance interpolated, the refit (the sweep's
    formulas under autograd) keeps the sweep's t bit for bit, and the
    winners are those of the hoisted sweep wherever both hit."""
    flat, o, d, times = _sweep_case(name, tmp_path, monkeypatch)
    lay = plain.layout(flat.prim_static, False)
    assert all(g.motion for g in lay.groups) and (lay.sphere_motion or not lay.spheres)
    t, prim, tri = plain.sweep_closest(flat, o, d, times, hoist=False)
    t_re, _ = ttrace._refit(flat, lay, o, d, times, prim, tri)
    assert (prim >= 0).any()
    assert torch.equal(t_re, t)
    t_h, prim_h, _ = plain.sweep_closest(flat, o, d, times)
    assert torch.equal(prim_h, prim)
    np.testing.assert_allclose(t_h.numpy(), t.numpy(), rtol=1e-6)


@pytest.mark.parametrize("name", ["cornell", "motionblur"])
def test_hoist_off_table_and_a_flip_between_calls(name, tmp_path, monkeypatch):
    """``ops/sweep.py::table`` packs another table for each setting of the
    same scene (every record moving with the hoist off), and a flip of
    ``trace.STATIC_TRANSFORM_HOIST`` between two trace calls sweeps with
    the setting of each call."""
    flat, o, d, times = _sweep_case(name, tmp_path, monkeypatch)
    cpu = torch.device("cpu")
    on, off = ops_sweep.table(flat, cpu, True), ops_sweep.table(flat, cpu, False)
    assert on is not off and off.motion
    assert ops_sweep.table(flat, cpu, False) is off and ops_sweep.table(flat, cpu) is on
    lay = plain.layout(flat.prim_static)
    if (lay.spheres and not lay.sphere_motion) or any(not g.motion for g in lay.groups):
        assert off.table.numel() > on.table.numel()  # a static batch now moves
    else:  # every batch already moves (motionblur.tin: one sphere of the batch)
        assert torch.equal(off.table, on.table)
    seen = []
    real = plain.sweep_closest

    def spy(*a, hoist=True, **kw):
        seen.append(hoist)
        return real(*a, hoist=hoist, **kw)

    monkeypatch.setattr(plain, "sweep_closest", spy)
    for hoist in (False, True, False):
        monkeypatch.setattr(ttrace, "STATIC_TRANSFORM_HOIST", hoist)
        hit = ttrace.trace_closest(flat, o, d, times)
        t, prim, _ = real(flat, o, d, times, hoist=hoist)
        assert torch.equal(hit.prim, prim)
        assert torch.equal(hit.t, t)
    assert seen == [False, True, False]


# -------------------------------------------------- the gather's halves


def _pool(seed=0, rows=64):
    rng = np.random.default_rng(seed)
    planes = [torch.from_numpy(rng.normal(size=rows).astype(np.float32)) for _ in range(18)]
    return MeshPool(node_rows=torch.zeros((1, 72)), block_rows=torch.zeros((1, 192)),
                    tri_cdf=torch.zeros(rows), tri_planes=tuple(planes[:9]),
                    nrm_planes=tuple(planes[9:]))


def _old_gather(planes, idx):
    """``MeshPool.gather_tri`` before its own backward: advanced indexing,
    whose backward is the accumulating index_put."""
    return tuple(torch.stack([planes[3 * k][idx], planes[3 * k + 1][idx], planes[3 * k + 2][idx]],
                             -1) for k in range(3))


@pytest.mark.parametrize("shape", [(5000,), (40, 25), ()])
def test_gather_forward_is_advanced_indexing_bit_for_bit(shape):
    pool = _pool()
    idx = torch.from_numpy(np.random.default_rng(1).integers(0, 64, shape))
    for new, old in ((pool.gather_tri(idx), _old_gather(pool.tri_planes, idx)),
                     (pool.gather_normals(idx), _old_gather(pool.nrm_planes, idx))):
        for a, b in zip(new, old):
            assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("rows", [16, 200])  # the one-hot and the index_add_ backward
@pytest.mark.parametrize("regime", ["colliding", "spread"])
def test_gather_backward_equals_index_put(regime, rows):
    """The backward against index_put's on random upstream gradients:
    20,000 lanes on 2 rows of the pool, or spread over all of them; within
    f32 summation order (1e-5 of each plane's largest sum). A plane whose
    output takes no gradient gets none."""
    assert (rows <= ONEHOT_ROWS) == (rows == 16)
    rng = np.random.default_rng(2)
    idx = torch.from_numpy(rng.integers(0, 2 if regime == "colliding" else rows, 20000))
    grads = {}
    for how in ("new", "old"):
        pool = _pool(rows=rows)
        leaves = [p.clone().requires_grad_(True) for p in pool.tri_planes]
        if how == "new":
            corners = dataclasses.replace(pool, tri_planes=tuple(leaves)).gather_tri(idx)
        else:
            corners = _old_gather(leaves, idx)
        up = np.random.default_rng(3)
        loss = sum((r[..., :2] * torch.from_numpy(up.normal(size=(20000, 2)).astype(np.float32)))
                   .sum() for r in corners)
        grads[how] = torch.autograd.grad(loss, leaves, allow_unused=True)
    for k, (got, want) in enumerate(zip(grads["new"], grads["old"])):
        if k % 3 == 2:  # the z planes take no gradient here
            assert got is None or not got.any()
            continue
        scale = float(want.abs().max())
        assert scale > 0 and float((got - want).abs().max()) <= 1e-5 * scale, k


# ------------------------------------------- the guard and its two finds


# tinsel_tpu's upper-case module constants and public parameters with no
# counterpart in the port, each with its reason (ROADMAP.md section 1)
NOT_PORTED_CONSTANTS = {
    "accel/build.py": {
        "COUNT_SHIFT": "the stackless walk's count packing; the walks keep a compressed stack",
        "ITEM_MASK": "the stackless walk's item packing; the walks keep a compressed stack",
    },
    "accel/packets.py": dict.fromkeys(
        ("PACKET_G", "PACKET_PHASE1_CAP", "PACKET_TILE", "PHASE2_PERRAY", "PHASE_RESTART",
         "STACK_MATRIX"), "packets.py: the TPU's shared-walk packets, not ported"),
    "accel/traverse.py": dict.fromkeys(
        ("TILE", "PHASE1_CAP", "PHASE1_FORI", "PHASE_RESTART", "PHASE2_CAP"),
        "_run_tiled's TPU tiles and two-phase compaction; a kernel walks each lane to its end"),
    "render/integrator.py": dict.fromkeys(
        ("REMAT_SAVE_NAMES", "SCAN_SPLIT_TRANSPOSE", "GRAD_UNROLL", "GRAD_UNROLL_GROUP"),
        "XLA remat and scan choices; eager autograd has nothing to choose"),
    "render/trace.py": {
        "COHERENCE_SORT": "a TPU lane-ordering knob measured and rejected there",
        "PACKET_TRACE_G": "the TPU's shared-walk packets (packets.py)",
    },
}
NOT_PORTED_PARAMS = {
    "key": "a JAX PRNG key; the port draws from a UniformSource (its fold_in path)",
    "tile": "_run_tiled's TPU tile",
    "packet_g": "the TPU's shared-walk packets (packets.py)",
    "coherent": "trace_closest's packet hint (PACKET_TRACE_G)",
    "dead_bounce_skip": "an XLA cond around a dead bounce; eager code skips nothing",
    "grad_unroll": "XLA scan unrolling (GRAD_UNROLL)",
    "backend": "the XLA backend of a render pass; the port's device is its tensors'",
}
NOT_PORTED_MODULES = {"accel/packets.py": "the TPU's shared-walk packets",
                      "utils/compile_cache.py": "XLA's compile cache; kernels build once"}


def _module_names(tree):
    """Names a module binds at its top level: assignments, imports,
    functions and classes."""
    out = set()
    for n in tree.body:
        if isinstance(n, (ast.Assign, ast.AnnAssign)):
            for t in (n.targets if isinstance(n, ast.Assign) else [n.target]):
                out |= {x.id for x in ast.walk(t) if isinstance(x, ast.Name)}
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in n.names}
        elif isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            out.add(n.name)
    return out


def _constants(tree):
    """Public upper-case names a module assigns at its top level."""
    out = set()
    for n in tree.body:
        if isinstance(n, (ast.Assign, ast.AnnAssign)):
            for t in (n.targets if isinstance(n, ast.Assign) else [n.target]):
                out |= {x.id for x in ast.walk(t) if isinstance(x, ast.Name)
                        and x.id.isupper() and not x.id.startswith("_")}
    return out


def _params(tree):
    """{function or Class.method: parameter names} of a module's public
    functions and public classes' public methods (and __init__)."""
    out = {}

    def add(f, prefix=""):
        a = f.args
        names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
        names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
        out[prefix + f.name] = names

    for n in tree.body:
        if isinstance(n, ast.FunctionDef) and not n.name.startswith("_"):
            add(n)
        elif isinstance(n, ast.ClassDef) and not n.name.startswith("_"):
            for m in n.body:
                if isinstance(m, ast.FunctionDef) and (not m.name.startswith("_")
                                                       or m.name == "__init__"):
                    add(m, n.name + ".")
    return out


def _module_pairs():
    for path in sorted((REPO / "tinsel_tpu").rglob("*.py")):
        rel = path.relative_to(REPO / "tinsel_tpu").as_posix()
        port = REPO / "tinsel_tpu_torch" / rel
        if rel in NOT_PORTED_MODULES:
            continue
        yield rel, ast.parse(path.read_text()), ast.parse(port.read_text()) if port.exists() \
            else None


def test_every_module_constant_has_a_counterpart_or_a_reason():
    missing = {}
    for rel, jtree, ttree in _module_pairs():
        have = _module_names(ttree) if ttree is not None else set()
        gap = _constants(jtree) - have - set(NOT_PORTED_CONSTANTS.get(rel, {}))
        if gap:
            missing[rel] = sorted(gap)
    assert not missing, missing
    # every reason names a constant that still exists
    for rel, reasons in NOT_PORTED_CONSTANTS.items():
        assert set(reasons) <= _constants(ast.parse((REPO / "tinsel_tpu" / rel).read_text())), rel


def test_every_public_parameter_has_a_counterpart_or_a_reason():
    missing = {}
    for rel, jtree, ttree in _module_pairs():
        if ttree is None:
            continue
        have = _params(ttree)
        for fn, names in _params(jtree).items():
            if fn in have:
                gap = [p for p in names if p not in have[fn] and p not in NOT_PORTED_PARAMS]
                if gap:
                    missing[f"{rel}::{fn}"] = gap
    assert not missing, missing


@pytest.mark.parametrize("name,value", [("NEE_CLOSEST_SHADOW", False),
                                        ("MESH_VERTEX_GRADS", False),
                                        ("STATIC_TRANSFORM_HOIST", True)])
def test_switches_have_the_jax_names_modules_and_defaults(name, value):
    jmod = jlights if name == "NEE_CLOSEST_SHADOW" else jtrace
    tmod = tlights if name == "NEE_CLOSEST_SHADOW" else ttrace
    assert getattr(jmod, name) is value and getattr(tmod, name) is value


def test_tonemap_filmic_takes_limit_as_jax_does():
    rng = np.random.default_rng(0)
    c = rng.uniform(0.0, 4.0, (64, 3)).astype(np.float32)
    for limit in (1.0, 0.5, 8.0):
        want = np.asarray(jcolor.tonemap_filmic(jnp.asarray(c), limit=limit))
        got = tcolor.tonemap_filmic(torch.from_numpy(c), limit=limit).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        assert torch.equal(tcolor.tonemap_filmic(torch.from_numpy(c), limit),
                           tcolor.tonemap_filmic(torch.from_numpy(c)))


def test_render_report_every_matches_jax():
    """``render(..., report_every=2)`` over 3 passes against the JAX
    package's at its own key (rbg, seed 5); the image is the one without
    ``report_every``, bit for bit."""
    js, ts = jpresets.cornell_scene(16, 16, 1), tpresets.cornell_scene(16, 16, 1)
    a = np.asarray(jrenderer.render(js, spp=3, seed=5, samples_per_pass=1, report_every=2))
    key = jax.random.key(5, impl=getattr(js.options, "prng", "rbg"))
    b = trenderer.render(ts, spp=3, samples_per_pass=1, report_every=2, device="cpu",
                         source=JaxUniforms(key))
    c = trenderer.render(ts, spp=3, samples_per_pass=1, device="cpu", source=JaxUniforms(key))
    assert torch.equal(b, c)
    assert_pass_matches(a, b.numpy())


def test_report_every_waits_for_the_device_only_on_cuda(monkeypatch):
    """On CPU tensors ``report_every`` synchronizes nothing."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(a))
    trenderer.render(tpresets.cornell_scene(8, 8, 1), spp=2, samples_per_pass=1, report_every=1,
                     device="cpu")
    assert calls == []
