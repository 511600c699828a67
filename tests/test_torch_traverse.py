"""The plain wide-BVH walks (the plain versions of kernels K3 and K4)
against an all-triangles oracle and against tinsel_tpu's walks.

The walk and the oracle compute each triangle's t with the same f32
formula, so their closest t agree exactly; the triangle is compared as the
mesh's own triangle (padding slots repeat a real one) wherever no other
triangle's t lies within 1e-6 relative of the winner's. Against the JAX
walk t agrees to rtol 2e-5 and atol 1e-6 (XLA evaluates the
Moller-Trumbore products in another order and rounds them differently in
the last bits; atol for hits near the ray origin).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinsel_tpu.accel import traverse as jtrav
from tinsel_tpu.scene import model as jmodel
from tinsel_tpu.scene import procedural as jproc
from tinsel_tpu_torch.accel import traverse as ttrav
from tinsel_tpu_torch.accel.build import BLOCK_SIZE
from tinsel_tpu_torch.scene import model as tmodel
from tinsel_tpu_torch.scene import procedural as tproc

torch.set_num_threads(2)
R = 1024


def _soup(n, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-2, 2, (n, 1, 3))
    size = rng.choice([0.02, 0.2, 1.0], (n, 1, 1))
    pos = (c + rng.normal(size=(n, 3, 3)) * size).reshape(-1, 3).astype(np.float32)
    return pos, np.arange(3 * n, dtype=np.int32).reshape(n, 3)


def _scene(model, proc):
    """Two meshes in one pool: a random soup (deep, unbalanced tree) and a
    sphere."""
    sc = model.Scene()
    pos, idx = _soup(3000, 1)
    sc.add_primitive(model.Primitive(type=model.MESH, mesh=model.Mesh(pos, idx)))
    sc.add_primitive(model.Primitive(type=model.MESH, mesh=proc.sphere(1.5, 16, 32)))
    return sc


def _rays(seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, (R, 3)).astype(np.float32)
    d = (rng.uniform(-1, 1, (R, 3)) - 0.3 * o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    u = rng.random(R)
    tmax = np.where(u < 0.6, np.inf, np.where(u < 0.9, rng.uniform(0, 5, R), 0.0))
    return o, d, tmax.astype(np.float32)


@pytest.fixture(scope="module")
def case():
    tf = _scene(tmodel, tproc).flatten(device="cpu")
    jf = _scene(jmodel, jproc).flatten()
    h = [p.mesh for p in tf.prim_static]
    o, d, tmax = _rays(0)
    # per-lane offsets: even lanes walk the soup, odd lanes the sphere
    which = np.arange(R) % 2
    noff = np.array([h[0].node_offset, h[1].node_offset], np.int32)[which]
    toff = np.array([h[0].tri_offset, h[1].tri_offset], np.int32)[which]
    slots = max(m.stack_slots for m in h)
    args = [jnp.asarray(a) for a in (noff, toff, o, d, tmax)]
    jt, jtri, *_ = jax.jit(
        lambda *a: jtrav.intersect_mesh(jf.pool, *a, stack_slots=slots)
    )(*args)
    jocc = jax.jit(lambda *a: jtrav.intersect_mesh_any(jf.pool, *a, stack_slots=slots))(*args)
    T = {k: torch.from_numpy(v) for k, v in dict(noff=noff, toff=toff, o=o, d=d, tmax=tmax).items()}
    t, tri = ttrav.intersect_mesh(tf.pool, T["noff"], T["toff"], T["o"], T["d"], T["tmax"],
                                  stack_slots=slots)
    occ = ttrav.intersect_mesh_any(tf.pool, T["noff"], T["toff"], T["o"], T["d"], T["tmax"],
                                   stack_slots=slots)
    return dict(tf=tf, handles=h, which=which, T=T, slots=slots, t=t.numpy(), tri=tri.numpy(),
                occ=occ.numpy(), jt=np.asarray(jt), jtri=np.asarray(jtri), jocc=np.asarray(jocc))


def _oracle(pool, handle, o, d, tmax):
    """Every padded triangle of one mesh against every ray: (T, R) t with
    +inf where missed or not below tmax."""
    sl = slice(handle.tri_offset, handle.tri_offset + handle.num_tris)
    p = pool.tri_planes
    va, vb, vc = (tuple(p[3 * k + i][sl][:, None] for i in range(3)) for k in range(3))
    hit, t = ttrav._tri_hit(va, vb, vc, tuple(o.T[:, None, :]), tuple(d.T[:, None, :]))
    return torch.where(hit & (t < tmax[None, :]), t, torch.inf)


def _oracle_case(c):
    """(t_min, unique, real winner ids) per lane of ``case`` from the oracle."""
    T = c["T"]
    t_all = [_oracle(c["tf"].pool, h, T["o"], T["d"], T["tmax"]) for h in c["handles"]]
    t_min = np.where(c["which"] == 0, t_all[0].min(0).values, t_all[1].min(0).values)
    unique = np.ones(R, bool)
    for m, ta in enumerate(t_all):
        ta = ta.numpy()
        near = np.abs(ta - t_min[None, :]) <= 1e-6 * np.abs(t_min[None, :])
        # padding repeats a real triangle: count distinct real triangles
        perm = _real_ids(c, m)
        n_near = np.array([len(set(perm[near[:, i]])) for i in range(R)])
        unique &= (c["which"] != m) | (n_near <= 1)
    return t_min, unique


_REAL = {}


def _real_ids(c, m):
    """Padded slot -> real triangle id of mesh m (slots of one leaf block
    past its real count repeat its last triangle)."""
    if m not in _REAL:
        h = c["handles"][m]
        sl = slice(h.tri_offset, h.tri_offset + h.num_tris)
        v = np.stack([c["tf"].pool.tri_planes[i][sl].numpy() for i in range(9)], -1)
        _, inv = np.unique(v, axis=0, return_inverse=True)
        _REAL[m] = inv.ravel()
    return _REAL[m]


def test_closest_matches_oracle(case):
    t_min, unique = _oracle_case(case)
    np.testing.assert_array_equal(case["t"], t_min)
    hit = np.isfinite(t_min)
    assert 0.2 < hit.mean() < 0.8
    assert np.all(case["tri"][~hit] == -1)
    for m in (0, 1):
        lanes = hit & unique & (case["which"] == m)
        orc = _oracle(case["tf"].pool, case["handles"][m], *(case["T"][k] for k in ("o", "d", "tmax")))
        want = _real_ids(case, m)[orc.argmin(0).numpy()[lanes]]
        got = _real_ids(case, m)[case["tri"][lanes]]
        np.testing.assert_array_equal(got, want)


def test_any_matches_oracle(case):
    t_min, _ = _oracle_case(case)
    np.testing.assert_array_equal(case["occ"], np.isfinite(t_min))
    assert not case["occ"][case["T"]["tmax"].numpy() == 0].any()


def test_closest_matches_jax(case):
    t, jt = case["t"], case["jt"]
    np.testing.assert_array_equal(np.isfinite(t), np.isfinite(jt))
    hit = np.isfinite(jt)
    np.testing.assert_allclose(t[hit], jt[hit], rtol=2e-5, atol=1e-6)
    _, unique = _oracle_case(case)
    np.testing.assert_array_equal(case["tri"][hit & unique], case["jtri"][hit & unique])


def test_any_matches_jax(case):
    np.testing.assert_array_equal(case["occ"], case["jocc"])


def test_exact_stack_bound_is_enough(case):
    """With exactly ``stack_slots`` entries the soup's walk equals the
    walk with room to spare (the bound is the true worst case)."""
    T, h = case["T"], case["handles"][0]
    assert h.stack_slots >= 2
    a = ttrav.intersect_mesh(case["tf"].pool, h.node_offset, h.tri_offset, T["o"], T["d"],
                             T["tmax"], stack_slots=h.stack_slots)
    b = ttrav.intersect_mesh(case["tf"].pool, h.node_offset, h.tri_offset, T["o"], T["d"],
                             T["tmax"], stack_slots=h.stack_slots + 8)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_axis_aligned_rays_on_box_bounds():
    """Zero direction components and origins on box bounds: rays straight
    down onto a flat 40-triangle disc. No NaN reaches the slab test (the
    reciprocal is nudged to +/-1e30); rays inside the disc hit it as the
    oracle does, rays outside miss, and every lane, the on-bound ones
    included, matches the JAX walk."""
    def disc_scene(model, proc):
        sc = model.Scene()
        sc.add_primitive(model.Primitive(type=model.MESH, mesh=proc.disc(1.0, 40)))
        return sc

    flat = disc_scene(tmodel, tproc).flatten(device="cpu")
    jflat = disc_scene(jmodel, jproc).flatten()
    h = flat.prim_static[0].mesh
    assert h.num_tris > BLOCK_SIZE
    xs = np.linspace(-1.2, 1.2, 25, dtype=np.float32)
    grid = np.stack(np.meshgrid(xs, xs), -1).reshape(-1, 2)
    o = np.stack([grid[:, 0], np.ones(len(grid)), grid[:, 1]], -1).astype(np.float32)
    o[:4, 0] = [1.0, -1.0, 0.0, 0.0]  # on the root box's bounds
    o[:4, 2] = [0.0, 0.0, 1.0, -1.0]
    d = np.tile(np.array([[0.0, -1.0, 0.0]], np.float32), (len(o), 1))
    tmax = np.full(len(o), np.inf, np.float32)
    args = [torch.from_numpy(a) for a in (o, d, tmax)]
    t, _ = ttrav.intersect_mesh(flat.pool, 0, 0, *args, stack_slots=h.stack_slots)
    t = t.numpy()
    assert not np.isnan(t).any()
    orc = _oracle(flat.pool, h, *args).min(0).values.numpy()
    r = np.hypot(o[:, 0], o[:, 2])
    inside = r < 0.99 * np.cos(np.pi / 40)
    np.testing.assert_array_equal(t[inside], orc[inside])
    assert np.isfinite(t[inside]).all() and not np.isfinite(t[r > 1.01]).any()
    jt, *_ = jtrav.intersect_mesh(jflat.pool, 0, 0, *map(jnp.asarray, (o, d, tmax)),
                                  stack_slots=h.stack_slots)
    np.testing.assert_allclose(t, np.asarray(jt), rtol=2e-5, atol=1e-6)
    occ = ttrav.intersect_mesh_any(flat.pool, 0, 0, *args, stack_slots=h.stack_slots)
    np.testing.assert_array_equal(occ.numpy(), np.isfinite(t))
