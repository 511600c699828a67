"""The sweep over spheres, planes and tiny meshes (the plain versions of
kernels K5c and K5a, accel/sweep.py) and its refit (render/trace.py) against
tinsel_tpu's trace_closest / trace_any, on the CPU.

Each case puts the same numpy rays (seeded) through the JAX functions and
through the port's plain sweep plus the refit: the winning primitive and
triangle and the occlusion bit must be equal, t and the normal within 1e-5,
the normal also within what the hit's conditioning carries from the JAX
package's rounding (XLA fuses multiply-adds; torch rounds each operation):
a sphere's t difference over its radius, a triangle's barycentric
rounding through its smooth normals (``_assert_normals``). The torch-op trace this sweep
replaced differed from JAX by the same on the same rays. The JAX side's triangle
comes from its own brute sweep of the winning instance. Cases: Cornell,
scenes/motionblur.tin (a moving sphere), scenes/veach_mis.json (4 spheres, 2
quads, 4 plates; its 2,208-triangle knob, which the walks take, is left out
of the sweep's comparison and kept in the whole-trace one) and a synthetic
scene of 2,000 spheres and 300 tiny instances, some moving, whose record
table spans three shared-memory chunks. The refit's gradients with respect
to the rays match jax.grad within 1e-4 (relative, and of the largest
entry). The kernels themselves run on the
card in tests/test_torch_sweep_cuda.py.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinsel_tpu.accel.traverse import intersect_mesh as jintersect_mesh
from tinsel_tpu.core import math as jmath
from tinsel_tpu.render import trace as jtrace
from tinsel_tpu.scene import model as jmodel
from tinsel_tpu.scene.presets import cornell_scene as jcornell
from tinsel_tpu_torch.accel import sweep as plain
from tinsel_tpu_torch.core.math import face_forward
from tinsel_tpu_torch.ops import sweep as ops
from tinsel_tpu_torch.render import trace as ttrace
from tinsel_tpu_torch.scene import model as tmodel
from tinsel_tpu_torch.scene.presets import cornell_scene as tcornell

from test_torch_sweep_cuda import camera_rays, synthetic_scene

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = 1e-4
BARY_ULPS = 4 * 2.0**-23
R = 4096
SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


# ------------------------------------------------------------------ scenes


def _load(name, tmp_path, monkeypatch):
    from tinsel_tpu.scene.loaders import mesh_io as jmesh_io
    from tinsel_tpu.scene.loaders.tin import load_tin as jload_tin
    from tinsel_tpu.scene.loaders.tungsten import load_tungsten as jload_tungsten
    from tinsel_tpu_torch.scene.loaders import mesh_io as tmesh_io
    from tinsel_tpu_torch.scene.loaders.tin import load_tin as tload_tin
    from tinsel_tpu_torch.scene.loaders.tungsten import load_tungsten as tload_tungsten

    monkeypatch.setattr(jmesh_io, "_CACHE_DIR", str(tmp_path / "jax_cache"))
    monkeypatch.setattr(tmesh_io, "_CACHE_DIR", str(tmp_path / "torch_cache"))
    path = os.path.join(SCENES, name)
    if name.endswith(".json"):
        return jload_tungsten(path), tload_tungsten(path)
    return jload_tin(path), tload_tin(path)


def _swept_only(sc):
    """The scene without its big meshes (what the sweep does not test)."""
    keep = [p for p in sc.primitives if p.mesh is None or len(p.mesh.indices) <= 16]
    return dataclasses.replace(sc, primitives=keep)


def _case(name, tmp_path, monkeypatch):
    """(JAX flat, port flat on the CPU, origins, dirs, times, tmax, full
    JAX flat, full port flat) of a case; the full pair only where the
    case has big meshes."""
    rng = np.random.default_rng(["cornell", "motionblur", "veach", "multichunk"].index(name))
    full = None
    if name == "cornell":
        js, ts = jcornell(32, 32, 4), tcornell(32, 32, 4)
        o = np.stack([rng.uniform(-0.95, 0.95, R), rng.uniform(0.05, 1.95, R),
                      rng.uniform(-0.95, 3.0, R)], -1).astype(np.float32)
        d = _unit(rng, R)
        q = R // 4  # a quarter aimed at the light quad (y = 1.9999)
        target = np.stack([rng.uniform(-0.3, 0.3, q), np.full(q, 1.9999),
                           rng.uniform(-0.3, 0.3, q)], -1).astype(np.float32)
        to = target - o[:q]
        d[:q] = to / np.linalg.norm(to, axis=-1, keepdims=True)
    elif name == "multichunk":
        js, ts = synthetic_scene(jmodel), synthetic_scene(tmodel)
        o = rng.uniform(-11, 11, (R, 3)).astype(np.float32)
        d = _unit(rng, R)
    else:
        js, ts = _load("motionblur.tin" if name == "motionblur" else "veach_mis.json", tmp_path,
                       monkeypatch)
        o, d = camera_rays(ts.camera, rng, R)
        if name == "veach":
            full = js.flatten(), ts.flatten(device="cpu")
            js, ts = _swept_only(js), _swept_only(ts)
    times = rng.random(R).astype(np.float32)
    tmax = np.where(rng.random(R) < 0.2, np.inf, rng.uniform(0.0, 6.0, R)).astype(np.float32)
    return js.flatten(), ts.flatten(device="cpu"), o, d, times, tmax, full


@pytest.fixture(scope="module", params=["cornell", "motionblur", "veach", "multichunk"])
def case(request, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        yield request.param, _case(request.param, tmp_path_factory.mktemp("cache"), mp)
    finally:
        mp.undo()


def _jax_tri(jf, o, d, times, prim):
    """The JAX package's winning triangle (pool index, else -1) of each ray
    whose winner is a tiny mesh: its own brute sweep of that instance,
    unbounded (the winner's lowest triangle at its smallest t). Also how
    far that hit's normal moves under rounding (0 elsewhere): the
    barycentrics' error, BARY_ULPS of |o - v0| |longest edge| / |d . n|
    (a far, thin triangle), times max |n_i - n_j| / |u n0 + v n1 + w n2|
    (vertex normals that turn against each other across the triangle, as
    at the edge of a plate)."""
    from tinsel_tpu.geometry.intersect import intersect_ray_tri as jray_tri

    tiny, _, _ = jtrace._mesh_partition(jf)
    out = np.full(prim.shape, -1, np.int64)
    cond = np.zeros(prim.shape, np.float32)
    for idxs in tiny.values():
        h = jf.prim_static[idxs[0]].mesh
        tr = jtrace._prim_transforms_batched(jf, idxs, jnp.asarray(times))
        ol = jmath.inverse_transform_point(tr, jnp.asarray(o)[None])
        dl = jmath.inverse_transform_vector(tr, jnp.asarray(d)[None])
        n = len(idxs) * o.shape[0]
        ol = jnp.broadcast_to(ol, (len(idxs),) + o.shape).reshape(n, 3)
        dl = jnp.broadcast_to(dl, (len(idxs),) + o.shape).reshape(n, 3)
        _, tri, *_ = jintersect_mesh(jf.pool, h.node_offset, h.tri_offset, ol, dl,
                                     jnp.full((n,), jnp.inf), num_tris=h.real_tris or h.num_tris)
        gt = h.tri_offset + jnp.maximum(tri, 0)
        v0, v1, v2 = jf.pool.gather_tri(gt)
        _, _, u, v, w, n_geo = jray_tri(v0, v1, v2, ol, dl)
        nv = jnp.stack(jf.pool.gather_normals(gt))  # (3, n, 3)
        ns = u[:, None] * nv[0] + v[:, None] * nv[1] + w[:, None] * nv[2]
        spread = jnp.max(jnp.linalg.norm(nv[:, None] - nv[None], axis=-1), axis=(0, 1))
        # barycentric error: a few ulps of |o - v0| |edge| over |d . n|
        edge = jnp.maximum(jnp.linalg.norm(v1 - v0, axis=-1), jnp.linalg.norm(v2 - v0, axis=-1))
        reach = jnp.linalg.norm(ol - v0, axis=-1) * edge / jnp.maximum(
            jnp.abs(jnp.sum(dl * n_geo, -1)), 1e-30)
        c = np.asarray(spread * (BARY_ULPS * (1.0 + reach))
                       / jnp.maximum(jnp.linalg.norm(ns, axis=-1), 1e-12))
        tri, c = np.asarray(tri).reshape(len(idxs), -1), c.reshape(len(idxs), -1)
        for k, p in enumerate(idxs):
            sel = prim == p
            out[sel] = h.tri_offset + tri[k][sel]
            cond[sel] = c[k][sel]
    return out, cond


def _assert_normals(tf, n, jn, t, jt, jprim, cond):
    """Normals within TOL of JAX's, beyond what the hit's conditioning
    carries: a sphere's normal, (o + d t - c) / r, moves by t's difference
    over the radius; a triangle's by ``_jax_tri``'s bound. The JAX package's
    arithmetic is fused by XLA (multiply-adds rounded once) where torch
    rounds each operation, so the two differ by more than an ulp exactly
    where the geometry amplifies."""
    hit = jprim >= 0
    row = np.maximum(jprim, 0)
    sph = hit & (tf.prim_type.numpy()[row] == tmodel.SPHERE)
    rad = (tf.prims.radius * tf.prims.start_s).numpy()[row]
    dt = np.zeros_like(t)
    dt[hit] = t[hit] - jt[hit]
    slack = np.where(sph, np.abs(dt) / rad, cond)
    err = np.abs(n - jn) - (TOL["atol"] + TOL["rtol"] * np.abs(jn)) - slack[:, None]
    assert (err[hit] <= 0).all(), err[hit].max()


def _jax_trace(jf, o, d, times, tmax, eager):
    fc, fa = jtrace.trace_closest, jtrace.trace_any
    if not eager:
        fc, fa = jax.jit(fc), jax.jit(fa)
    h = fc(jf, *map(jnp.asarray, (o, d, times)))
    occ = fa(jf, *map(jnp.asarray, (o, d, times, tmax)))
    return np.asarray(h.t), np.asarray(h.prim), np.asarray(h.normal), np.asarray(occ)


@pytest.fixture(scope="module")
def jax_results(case):
    name, (jf, _, o, d, times, tmax, _) = case
    # the synthetic scene's 2,000 unrolled row merges: op by op, no compile
    return _jax_trace(jf, o, d, times, tmax, eager=name == "multichunk")


def test_sweep_closest_and_refit_match_jax(case, jax_results):
    name, (jf, tf, o, d, times, _, _) = case
    jt, jprim, jn, _ = jax_results
    ot, dt, tt = (torch.from_numpy(x) for x in (o, d, times))
    t, prim, tri = plain.sweep_closest(tf, ot, dt, tt)
    t_re, n_re = ttrace._refit(tf, plain.layout(tf.prim_static), ot, dt, tt, prim, tri)
    np.testing.assert_array_equal(prim.numpy(), jprim)
    jtri, cond = _jax_tri(jf, o, d, times, jprim)
    np.testing.assert_array_equal(tri.numpy(), jtri)
    hit = jprim >= 0
    assert 0.3 < hit.mean()
    np.testing.assert_array_equal(np.isfinite(t.numpy()), hit)
    np.testing.assert_allclose(t.numpy()[hit], jt[hit], **TOL)
    # the refit takes the sweep's formulas on the same numbers: equal bits
    assert torch.equal(t_re, t)
    _assert_normals(tf, face_forward(n_re, -dt).numpy(), jn, t.numpy(), jt, jprim, cond)
    # every kind of row wins somewhere
    kinds = set(tf.prim_type.numpy()[jprim[hit]].tolist())
    lay = plain.layout(tf.prim_static)
    want = {k for k, rows in ((tmodel.SPHERE, lay.spheres), (tmodel.PLANE, lay.planes),
                              (tmodel.MESH, lay.groups)) if rows}
    assert kinds == want
    if name == "multichunk":  # moving spheres and moving instances win too
        moving = np.array([p.motion for p in tf.prim_static])
        assert moving[jprim[hit]].any()
        assert (moving[jprim[hit]] & (tf.prim_type.numpy()[jprim[hit]] == tmodel.MESH)).any()


def test_sweep_any_matches_jax(case, jax_results):
    _, (_, tf, o, d, times, tmax, _) = case
    *_, jocc = jax_results
    occ = plain.sweep_any(tf, *map(torch.from_numpy, (o, d, times, tmax)))
    np.testing.assert_array_equal(occ.numpy(), jocc)
    assert 0.05 < jocc.mean() < 0.95


def test_whole_trace_matches_jax_with_the_big_mesh(tmp_path, monkeypatch):
    """veach_mis.json with its knob: the sweep's t bounds the walk."""
    *_, o, d, times, tmax, (jf, tf) = _case("veach", tmp_path, monkeypatch)
    jt, jprim, jn, jocc = _jax_trace(jf, o, d, times, tmax, eager=False)
    ot, dt, tt, tm = (torch.from_numpy(x) for x in (o, d, times, tmax))
    h = ttrace.trace_closest(tf, ot, dt, tt)
    np.testing.assert_array_equal(h.prim.numpy(), jprim)
    assert (jprim == plain.layout(tf.prim_static).big[0]).any()
    hit = jprim >= 0
    np.testing.assert_allclose(h.t.numpy()[hit], jt[hit], **TOL)
    _assert_normals(tf, h.normal.numpy(), jn, h.t.numpy(), jt, jprim,
                    _jax_tri(jf, o, d, times, jprim)[1])
    np.testing.assert_array_equal(ttrace.trace_any(tf, ot, dt, tt, tm).numpy(), jocc)


# ---------------------------------------------------------------- gradients


@pytest.mark.parametrize("name", ["cornell", "motionblur"])
def test_refit_gradients_match_jax(name, tmp_path, monkeypatch):
    """d/d(origins, dirs) of sum(a t) + sum(b n) over the rays that hit,
    through the port's sweep plus refit and through jax.grad of the JAX
    trace_closest."""
    jf, tf, o, d, times, _, _ = _case(name, tmp_path, monkeypatch)
    rng = np.random.default_rng(9)
    a = rng.normal(size=R).astype(np.float32)
    b = rng.normal(size=(R, 3)).astype(np.float32)

    def jloss(o_, d_):
        h = jtrace.trace_closest(jf, o_, d_, jnp.asarray(times))
        t = jnp.where(h.prim >= 0, h.t, 0.0)
        return jnp.sum(a * t) + jnp.sum(b * h.normal)

    jgo, jgd = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(o), jnp.asarray(d))
    ot = torch.from_numpy(o).requires_grad_(True)
    dt = torch.from_numpy(d).requires_grad_(True)
    h = ttrace.trace_closest(tf, ot, dt, torch.from_numpy(times))
    t = torch.where(h.prim >= 0, h.t, 0.0)
    loss = torch.sum(torch.from_numpy(a) * t) + torch.sum(torch.from_numpy(b) * h.normal)
    go, gd = torch.autograd.grad(loss, (ot, dt))
    assert np.abs(np.asarray(jgo)).max() > 0.1
    for g, jg in ((go.numpy(), np.asarray(jgo)), (gd.numpy(), np.asarray(jgd))):
        # atol scaled by the largest entry, as tests/test_torch_gradients.py
        # does: a ray grazing a sphere takes its gradient through
        # 1 / sqrt(disc) (to ~1e8 on motionblur.tin), and with it the
        # rounding of XLA's fused multiply-adds against torch's
        np.testing.assert_allclose(g, jg, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * max(1.0, np.abs(jg).max()))


def test_refit_gradient_reaches_only_the_winning_row():
    """d t / d (sphere centre): nonzero only on the sphere each ray hits,
    the one-hot backward of the gathered rows."""
    tf = tcornell(8, 8, 1).flatten(device="cpu")
    lay = plain.layout(tf.prim_static)
    start_p = tf.prims.start_p.clone().requires_grad_(True)
    prims = dataclasses.replace(tf.prims, start_p=start_p)
    sc = dataclasses.replace(tf, prims=prims)
    s = lay.spheres[0]
    c = tf.prims.start_p[s].numpy()
    rng = np.random.default_rng(3)
    o = np.tile(np.array([[0.0, 1.0, 3.0]], np.float32), (64, 1))
    d = (c[None] + rng.normal(size=(64, 3)) * 0.05 - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    h = ttrace.trace_closest(sc, torch.from_numpy(o), torch.from_numpy(d), torch.zeros(64))
    assert (h.prim == s).all()
    (g,) = torch.autograd.grad(h.t.sum(), start_p)
    rows = torch.nonzero(g.abs().sum(-1)).flatten().tolist()
    assert rows == [s]


# ---------------------------------------------------- dispatcher and table


def test_cpu_tensors_run_the_plain_version_and_count_nothing(case):
    _, (_, tf, o, d, times, tmax, _) = case
    ops.reset_launch_counts()
    ot, dt, tt, tm = (torch.from_numpy(x) for x in (o, d, times, tmax))
    got = ops.sweep_closest(tf, ot, dt, tt)
    for a, b in zip(got, plain.sweep_closest(tf, ot, dt, tt)):
        assert torch.equal(a, b)
    assert torch.equal(ops.sweep_any(tf, ot, dt, tt, tm), plain.sweep_any(tf, ot, dt, tt, tm))
    assert ops.launch_counts == {"sweep_closest": 0, "sweep_any": 0}


def test_the_kernel_wrappers_refuse_cpu_tensors():
    tf = tcornell(8, 8, 1).flatten(device="cpu")
    o, d, t = torch.zeros(4, 3), torch.ones(4, 3), torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA"):
        ops.sweep_closest_cuda(tf, o, d, t)
    with pytest.raises(ValueError, match="CUDA"):
        ops.sweep_any_cuda(tf, o, d, t, t)
    assert ops.launch_counts == {"sweep_closest": 0, "sweep_any": 0}


def _decode(table, bounds):
    """Each chunk's runs, checked against its header: {"spheres": [(prim,
    record)], "planes": [...], "groups": [(flags, first triangle, box
    (8,), triangles (T, 12), [(prim, record)])]}; every run starts on a
    16-byte boundary, id runs are padded with zeros and the runs fill the
    chunk."""
    ints = table.view(np.int32)
    chunks = []
    for c0, c1 in zip(bounds[:-1], bounds[1:]):
        assert c0 % 4 == 0 and c1 % 4 == 0
        ns, n_planes, ng, flags = ints[c0:c0 + 4]
        pos = c0 + ops.HEAD

        def run(n, width):
            nonlocal pos
            ids = ints[pos:pos + ops._pad4(n)]
            assert not ids[n:].any()  # padding
            pos += ops._pad4(n)
            recs = table[pos:pos + n * width].reshape(n, width)
            pos += n * width
            return list(zip(ids[:n].tolist(), recs))

        moves = bool(flags & ops.SPHERES_MOVE)
        spheres = run(ns, ops.SPHERE_MOVING if moves else ops.SPHERE_STATIC)
        planes = run(n_planes, ops.PLANE_LEN)
        groups = []
        for _ in range(ng):
            nt, ni, gflags, tri0 = ints[pos:pos + 4]
            box = table[pos + 4:pos + ops.GROUP_HEAD]
            pos += ops.GROUP_HEAD
            tris = table[pos:pos + nt * ops.TRI_LEN].reshape(nt, ops.TRI_LEN)
            pos += nt * ops.TRI_LEN
            width = ops.INSTANCE_MOVING if gflags & ops.MOVES else ops.INSTANCE_STATIC
            groups.append((int(gflags), int(tri0), box, tris, run(ni, width)))
        assert pos == c1
        chunks.append({"spheres": spheres, "planes": planes, "groups": groups,
                       "spheres_move": moves})
    return chunks


def _merge_order(chunks):
    """(kind, prim) in the order the kernels test them, a group's opening
    and closing as (kind, None)."""
    seen = []
    for ch in chunks:
        seen += [(tmodel.SPHERE, i) for i, _ in ch["spheres"]]
        seen += [(tmodel.PLANE, i) for i, _ in ch["planes"]]
        for flags, _, _, _, inst in ch["groups"]:
            seen += [("open", None)] if flags & ops.OPENS else []
            seen += [(tmodel.MESH, i) for i, _ in inst]
            seen += [("close", None)] if flags & ops.CLOSES else []
    return seen


@pytest.mark.parametrize("chunk_floats", [None, 600])
def test_record_table_in_merge_order_and_chunks(case, chunk_floats):
    """The table's runs in the plain version's merge order, in chunks of at
    most the limit: by default one chunk up to SMEM_FLOATS, else chunks of
    up to CHUNK_FLOATS; at 600 floats the synthetic scene's groups are cut,
    and a chunk that starts inside a group repeats its head and
    triangles, not opening it."""
    name, (_, tf, *_) = case
    table, bounds = ops.pack_records(tf, chunk_floats)
    sizes = np.diff(bounds)
    assert bounds[0] == 0 and bounds[-1] == table.size
    chunks = _decode(table, bounds)
    lay = plain.layout(tf.prim_static)
    order = [(tmodel.SPHERE, i) for i in lay.spheres] + [(tmodel.PLANE, i) for i in lay.planes]
    for g in lay.groups:
        order += [("open", None)] + [(tmodel.MESH, i) for i in g.prims] + [("close", None)]
    assert _merge_order(chunks) == order
    if chunk_floats is not None:
        assert (sizes <= chunk_floats).all()
    elif name == "multichunk":
        assert table.size > ops.SMEM_FLOATS and (sizes <= ops.CHUNK_FLOATS).all()
        assert len(chunks) == 3
    else:
        assert len(chunks) == 1 and table.size <= ops.SMEM_FLOATS
    if name == "multichunk" and chunk_floats is not None:
        cut = [ch["groups"][0] for ch in chunks[1:]
               if ch["groups"] and not ch["groups"][0][0] & ops.OPENS]
        assert cut and all(len(g[3]) > 0 for g in cut)
        # every part of a group carries its head and all its triangles
        heads = {}
        for ch in chunks:
            for flags, tri0, box, tris, _ in ch["groups"]:
                key = (tri0, tris.tobytes(), box.tobytes())
                heads.setdefault(tri0, key)
                assert heads[tri0] == key


def test_precomputed_fields_equal_the_plain_versions_bits(case):
    """Every field packed on the host equals, bit for bit, what the plain
    versions compute from the same vertices, radii and transforms: a
    triangle's edges (``_tri_hit``'s ab, ac) and normal (``ray_tri``'s
    ab x ac), a static sphere's radius * s, a moving record's end - start,
    a static instance's -q."""
    from tinsel_tpu_torch.accel import traverse as ttrav

    name, (_, tf, *_) = case
    table, bounds = ops.pack_records(tf)
    pr = tf.prims
    lay = plain.layout(tf.prim_static)
    cpu = torch.zeros(())

    def same(a, b):
        a = np.asarray(a, np.float32)
        b = torch.as_tensor(b, dtype=torch.float32).numpy()
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))

    n_tris = 0
    for ch in _decode(table, bounds):
        for i, rec in ch["spheres"]:
            same(rec[:3], pr.start_p[i])
            if ch["spheres_move"]:
                assert lay.sphere_motion
                same(rec[3], pr.start_s[i])
                same(rec[4:7], pr.end_p[i] - pr.start_p[i])
                same(rec[7], pr.end_s[i] - pr.start_s[i])
                same(rec[8], pr.radius[i])
            else:  # _sphere_rows: radius * s
                same(rec[3], pr.radius[i] * pr.start_s[i])
        for i, rec in ch["planes"]:
            same(rec, pr.plane[i])
        for flags, tri0, box, tris, inst in ch["groups"]:
            g = next(g for g in lay.groups if g.handle.tri_offset == tri0)
            assert bool(flags & ops.MOVES) == g.motion
            same(box, [*g.handle.root_lower, 0, *g.handle.root_upper, 0])
            for k, rec in enumerate(tris):
                v = [tuple(c[tri0 + k] for c in tf.pool.tri_planes[3 * j:3 * j + 3])
                     for j in range(3)]
                ab, ac, *_ = ttrav._mt_terms(*v, (cpu,) * 3, (cpu,) * 3, 1e-9)
                # d = 0: dot(-d, n) is +-0, so ray_tri's n_geo is ab x ac unflipped
                *_, n_geo = plain.ray_tri(*v, (cpu,) * 3, (cpu,) * 3)
                same(rec[0:3], v[0])
                same(rec[3:6], ab)
                same(rec[6:9], ac)
                same(rec[9:12], n_geo)
                n_tris += 1
            for i, rec in inst:
                same(rec[0:3], pr.start_p[i])
                same(rec[3], pr.start_s[i])
                if g.motion:
                    same(rec[4:8], pr.start_q[i])
                    same(rec[8:11], pr.end_p[i] - pr.start_p[i])
                    same(rec[11], pr.end_s[i] - pr.start_s[i])
                    same(rec[12:16], pr.end_q[i] - pr.start_q[i])
                else:  # inverse_rotate's u = -q.xyz, and q.w
                    same(rec[4:7], -pr.start_q[i][:3])
                    same(rec[7], pr.start_q[i][3])
    # a group cut by a chunk bound has its triangles in each part
    assert n_tris >= sum(g.tris for g in lay.groups)


def test_packed_table_is_kept_until_a_table_changes():
    tf = tcornell(8, 8, 1).flatten(device="cpu")
    a = ops.table(tf, torch.device("cpu"))
    assert ops.table(dataclasses.replace(tf, materials=tf.materials), torch.device("cpu")) is a
    tf.prims.radius.add_(0.0)  # in place: a new version
    b = ops.table(tf, torch.device("cpu"))
    assert b is not a and torch.equal(a.table, b.table)


# ------------------------------------------ the big batch's refit at a seam


def _jax_big_drops(jf, o, d, times, best_t):
    """The JAX package's big-mesh batch of trace_closest
    (``tinsel_tpu/render/trace.py:431-560``, eager, its own functions) on
    the given best t: (lanes where the walk finds a triangle under best t,
    lanes among them whose refit by ``intersect_ray_tri`` is dropped)."""
    from tinsel_tpu.geometry.intersect import intersect_ray_tri as jray_tri

    _, big, _ = jtrace._mesh_partition(jf)
    handles = [jf.prim_static[i].mesh for i in big]
    n, r = len(big), o.shape[0]
    tr_b = jtrace._prim_transforms_batched(jf, big, times)
    o_l = jmath.inverse_transform_point(tr_b, o[None])
    d_l = jmath.inverse_transform_vector(tr_b, d[None])
    tmax_b = jnp.broadcast_to(best_t[None], (n, r))
    may, tn = jtrace._instance_box_entry(handles, o_l, d_l, tmax_b)
    noff = np.asarray([h.node_offset for h in handles], np.int32)
    toff = np.asarray([h.tri_offset for h in handles], np.int32)
    slots = max(h.stack_slots for h in handles)
    ids = jnp.arange(n, dtype=jnp.int32)[:, None]
    if n <= jtrace.INSTANCE_TOPK_MIN:
        lanes = lambda x: jnp.broadcast_to(jnp.asarray(x)[:, None], (n, r)).reshape(-1)  # noqa: E731
        t_f, tri_f, *_ = jintersect_mesh(jf.pool, lanes(noff), lanes(toff), o_l.reshape(-1, 3),
                                         d_l.reshape(-1, 3),
                                         jnp.where(may, tmax_b, 0.0).reshape(-1),
                                         stack_slots=slots)
        t_i, tri_i = t_f.reshape(n, r), tri_f.reshape(n, r)
        t_min = t_i.min(0)
        inst = jnp.minimum(jnp.where(t_i == t_min[None], ids, n).min(0), n - 1)
        tri = jnp.where(ids == inst[None], tri_i, -1).max(0)
    else:
        t_min, tri, inst = jtrace._instance_rounds(jf, o_l, d_l, tn, best_t, noff, toff, slots)
    hit = jnp.isfinite(t_min) & (t_min < best_t)
    onehot = (ids == inst[None]).astype(jnp.float32)
    ow, dw = (onehot[..., None] * o_l).sum(0), (onehot[..., None] * d_l).sum(0)
    v0, v1, v2 = jf.pool.gather_tri(jnp.asarray(toff)[inst] + jnp.maximum(tri, 0))
    _, t, *_ = jray_tri(v0, v1, v2, ow, dw)
    t = jnp.where(hit & (tri >= 0), t, jnp.inf)
    closer = hit & (t > 0.0) & (t < best_t)
    return np.asarray(hit), np.asarray(hit & ~closer)


def _seam_rays(tf, seed, n=R):
    """Rays from above the floor aimed at points on the edges of random
    big-mesh triangles (world = p + s v: these presets do not rotate)."""
    rng = np.random.default_rng(seed)
    big = plain.layout(tf.prim_static).big
    o = np.stack([rng.uniform(-3, 3, n), rng.uniform(0.5, 3, n), rng.uniform(-3, 3, n)], -1)
    prim = np.asarray(big)[rng.integers(len(big), size=n)]
    tris = np.array([tf.prim_static[p].mesh.tri_offset
                     + rng.integers(tf.prim_static[p].mesh.real_tris) for p in prim])
    verts = np.stack([np.stack([c.numpy()[tris] for c in tf.pool.tri_planes[3 * j:3 * j + 3]], -1)
                      for j in range(3)], 1)  # (n, 3, 3)
    a = rng.integers(3, size=n)
    b = (a + rng.integers(1, 3, size=n)) % 3
    rows = np.arange(n)
    x = verts[rows, a] + rng.random((n, 1)) * (verts[rows, b] - verts[rows, a])
    world = tf.prims.start_p.numpy()[prim] + tf.prims.start_s.numpy()[prim][:, None] * x
    d = world - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32), np.zeros(n, np.float32)


@pytest.mark.parametrize("preset, args", [("envmesh_scene", (32, 32, 4, 40)),
                                          ("many_mesh_scene", (20, 32, 32, 2))])
def test_big_batch_refit_drops_no_lane_that_jax_keeps(preset, args):
    """Rays aimed at the edges between big-mesh triangles (a Perlin sphere
    of 3,200 triangles; 14 big meshes in shortlist rounds and 6 tiny
    ones): the lanes where the walk finds a triangle under the sweep's
    best t and the refit then drops it. No tolerance: a set comparison.
    The port's drops must be a subset of the JAX package's; its refit
    takes the walk's own formula, so it drops none, and its t is the
    walk's. (With ``intersect_ray_tri``'s torch form, the refit the port
    took before, it dropped lanes here that JAX keeps, on both scenes.)"""
    from tinsel_tpu.scene import presets as jpresets
    from tinsel_tpu_torch.scene import presets as tpresets

    jf = getattr(jpresets, preset)(*args).flatten()
    tf = getattr(tpresets, preset)(*args).flatten(device="cpu")
    o, d, times = _seam_rays(tf, 3)
    lay = plain.layout(tf.prim_static)
    ot, dt, tt = (torch.from_numpy(x) for x in (o, d, times))
    _, prim, tri = plain.sweep_closest(tf, ot, dt, tt)
    with torch.no_grad():
        best_t, _ = ttrace._refit(tf, lay, ot, dt, tt, prim, tri)
        big = ttrace._big_closest(tf, lay, ot, dt, tt, best_t)
    drops = (big.hit & ~big.closer).numpy()
    jhit, jdrops = _jax_big_drops(jf, *map(jnp.asarray, (o, d, times, best_t.numpy())))
    assert big.hit.float().mean() > 0.9 and jhit.mean() > 0.9
    assert jdrops.sum() > 0.01 * R  # the rays reach seams where JAX's refit misses
    assert not (drops & ~jdrops).any()
    assert not drops.any()
