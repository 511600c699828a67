"""The instance shortlist rounds: their plain version (``accel/instances.py``,
the plain version of kernels K6c and K6a) against tinsel_tpu's
``_instance_rounds`` / ``_instance_rounds_any``, both on given (I, R)
local rays and box entries and from world rays (``rounds_closest_world``
/ ``rounds_any_world`` against the JAX chain ``_instance_box_entry`` ->
``_instance_rounds``); the kernels' way, emulated here with torch ops from
world rays and the instance table's records (each lane's entries, kept
or computed again at each scan, the picks, the walks from each record),
against the plain rounds bit for bit; the instance table and its cache;
the rounds path's gradients against jax.grad.

Each package builds its own inputs with its own functions (local rays,
box entries, offsets) from the same numpy rays. Tolerances as
tests/test_torch_traverse.py: the hit sets equal, t within rtol 2e-5 /
atol 1e-6 (XLA rounds the JAX walk's products in another order), the
triangle and instance equal where the hit is unique (no other instance's
t within 1e-5 relative), occlusion equal. The kernels themselves run in
tests/test_torch_instances_cuda.py on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinsel_tpu.scene as jpkg
import tinsel_tpu_torch.scene as tpkg
from tinsel_tpu.core import math as jmath
from tinsel_tpu.render import trace as jtrace
from tinsel_tpu.scene import model as jmodel  # noqa: F401 (jpkg.model)
from tinsel_tpu.scene import presets as jpresets  # noqa: F401 (jpkg.presets)
from tinsel_tpu.scene import procedural as jprocedural  # noqa: F401
from tinsel_tpu_torch.accel import instances as plain
from tinsel_tpu_torch.accel import traverse as ttrav
from tinsel_tpu_torch.accel.sweep import box_entry, inverse_rotate, layout
from tinsel_tpu_torch.geometry.intersect import INF
from tinsel_tpu_torch.ops import bvh as ops_bvh
from tinsel_tpu_torch.ops import instances as ops
from tinsel_tpu_torch.ops import sweep as ops_sweep
from tinsel_tpu_torch.render import trace as ttrace
from tinsel_tpu_torch.scene import model as tmodel  # noqa: F401 (tpkg.model)
from tinsel_tpu_torch.scene import presets as tpresets  # noqa: F401 (tpkg.presets)
from tinsel_tpu_torch.scene import procedural as tprocedural  # noqa: F401

from test_torch_instances_cuda import rays, sphere_line, turned_capsules

torch.set_num_threads(2)
R = 1024
# 16 instances of one capsule; 19 meshes, 13 of them big; 81 capsules; a
# line of 21 sphere instances whose boxes a ray can cross without a hit
SCENES = {
    "instances16": ("instances_scene", (32, 32, 3, 4)),
    "many_mesh19": ("many_mesh_scene", (19, 16, 16, 2)),
    "grid81": ("instances_scene", (16, 16, 3, 9)),
    "line21": ("sphere_line", ()),
}
_CACHE = {}


def _build(pkg, preset, args):
    if preset == "sphere_line":
        return sphere_line(pkg.model, pkg.procedural)
    return getattr(pkg.presets, preset)(*args)


def _case(name):
    """Both packages' inputs and outputs of the rounds on one scene."""
    if name in _CACHE:
        return _CACHE[name]
    preset, args = SCENES[name]
    jf = _build(jpkg, preset, args).flatten()
    tf = _build(tpkg, preset, args).flatten(device="cpu")
    big = list(layout(tf.prim_static).big)
    _, jbig, _ = jtrace._mesh_partition(jf)
    assert list(jbig) == big and len(big) > ttrace.INSTANCE_TOPK_MIN
    o, d, times, best, occ0 = rays(tf, big, R, 7, line=name == "line21")
    tmax = np.where(occ0, 0.0, best).astype(np.float32)  # 0 where already occluded
    n = len(big)
    handles = [tf.prim_static[i].mesh for i in big]
    # the port's inputs, with its own functions
    _, o_l, d_l = ttrace._local_rays(tf, big, *map(torch.from_numpy, (o, d, times)))
    noff, toff, slots = ttrace._offsets(handles, torch.device("cpu"))
    tn = {w: ttrace._instance_box_entry(handles, o_l, d_l,
                                         torch.from_numpy(b)[None].expand(n, R))[1]
          for w, b in (("closest", best), ("any", tmax))}
    # the JAX package's, with its own
    jhandles = [jf.prim_static[i].mesh for i in big]
    tr_b = jtrace._prim_transforms_batched(jf, big, jnp.asarray(times))
    jo_l = jmath.inverse_transform_point(tr_b, jnp.asarray(o)[None])
    jd_l = jmath.inverse_transform_vector(tr_b, jnp.asarray(d)[None])
    jtn = {w: jtrace._instance_box_entry(jhandles, jo_l, jd_l,
                                         jnp.broadcast_to(jnp.asarray(b)[None], (n, R)))[1]
           for w, b in (("closest", best), ("any", tmax))}
    joff = noff.numpy(), toff.numpy()
    jt, jtri, jinst = jtrace._instance_rounds(jf, jo_l, jd_l, jtn["closest"], jnp.asarray(best),
                                              *joff, slots)
    jocc = jtrace._instance_rounds_any(jf, jo_l, jd_l, jtn["any"], jnp.asarray(tmax),
                                       jnp.asarray(occ0), *joff, slots)
    _CACHE[name] = c = dict(
        jf=jf, tf=tf, o_l=o_l, d_l=d_l, tn=tn, noff=noff, toff=toff, slots=slots,
        tab=ops.table(tf, torch.device("cpu")),
        o=torch.from_numpy(o), d=torch.from_numpy(d), times=torch.from_numpy(times),
        best=torch.from_numpy(best), tmax=torch.from_numpy(tmax), occ0=torch.from_numpy(occ0),
        jt=np.asarray(jt), jtri=np.asarray(jtri), jinst=np.asarray(jinst), jocc=np.asarray(jocc))
    return c


def _closest_args(c):
    return (c["tf"], c["o_l"], c["d_l"], c["tn"]["closest"], c["best"], c["noff"], c["toff"],
            c["slots"])


def _any_args(c):
    return (c["tf"], c["o_l"], c["d_l"], c["tn"]["any"], c["tmax"], c["occ0"], c["noff"],
            c["toff"], c["slots"])


def _world_closest_args(c):
    return c["tf"], c["tab"], c["o"], c["d"], c["times"], c["best"]


def _world_any_args(c):
    return c["tf"], c["tab"], c["o"], c["d"], c["times"], c["tmax"], c["occ0"]


def _per_instance_t(c):
    """(I, R) closest t of every instance under the ray's best t (+inf
    where culled), from the plain walk over every (instance, ray) pair."""
    n = c["o_l"].shape[0]
    tn, best = c["tn"]["closest"], c["best"]
    tm = torch.where(torch.isfinite(tn), best[None].expand(n, R), 0.0).reshape(-1)
    t, _ = ttrav.intersect_mesh(c["tf"].pool, c["noff"].repeat_interleave(R),
                                c["toff"].repeat_interleave(R), c["o_l"].reshape(-1, 3),
                                c["d_l"].reshape(-1, 3), tm, stack_slots=c["slots"])
    return t.reshape(n, R)


@pytest.mark.parametrize("name", list(SCENES))
def test_rounds_closest_match_jax(name):
    c = _case(name)
    t, tri, inst = plain.rounds_closest(*_closest_args(c))
    assert t.dtype == torch.float32 and tri.dtype == torch.int32 and inst.dtype == torch.long
    t, tri, inst = t.numpy(), tri.numpy(), inst.numpy()
    hit, jhit = tri >= 0, c["jtri"] >= 0
    np.testing.assert_array_equal(hit, jhit)
    assert 0.15 < hit.mean() < 0.9
    np.testing.assert_allclose(t[hit], c["jt"][hit], rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(t[~hit], c["best"].numpy()[~hit])  # best t kept on a miss
    srt = np.sort(_per_instance_t(c).numpy(), axis=0)
    unique = hit & ~(srt[1] <= srt[0] * (1 + 1e-5))
    assert unique.mean() > 0.8 * hit.mean()
    np.testing.assert_array_equal(inst[unique], c["jinst"][unique])
    np.testing.assert_array_equal(tri[unique], c["jtri"][unique])
    # two instances with the same hit (line21's fourth sphere twice): the
    # lower id, in both packages
    tie = hit & (srt[1] == srt[0])
    assert tie.any() == (name == "line21")
    np.testing.assert_array_equal(inst[tie], c["jinst"][tie])
    assert (inst[tie] == 3).all()
    # the rounds find what walking every instance finds
    np.testing.assert_array_equal(t[hit], srt[0][hit])


@pytest.mark.parametrize("name", list(SCENES))
def test_world_rounds_match_jax(name):
    """The plain version from world rays (the kernels' component formulas
    for the local rays and box entries, then the plain rounds) against the
    JAX chain from the same world rays, at the tolerances above."""
    c = _case(name)
    t, tri, inst = plain.rounds_closest_world(*_world_closest_args(c))
    assert t.dtype == torch.float32 and tri.dtype == torch.int32 and inst.dtype == torch.long
    t, tri, inst = t.numpy(), tri.numpy(), inst.numpy()
    hit = tri >= 0
    np.testing.assert_array_equal(hit, c["jtri"] >= 0)
    np.testing.assert_allclose(t[hit], c["jt"][hit], rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(t[~hit], c["best"].numpy()[~hit])
    srt = np.sort(_per_instance_t(c).numpy(), axis=0)
    unique = hit & ~(srt[1] <= srt[0] * (1 + 1e-5))
    assert unique.mean() > 0.8 * hit.mean()
    np.testing.assert_array_equal(inst[unique], c["jinst"][unique])
    np.testing.assert_array_equal(tri[unique], c["jtri"][unique])
    occ = plain.rounds_any_world(*_world_any_args(c)).numpy()
    np.testing.assert_array_equal(occ, c["jocc"])


@pytest.mark.parametrize("name", list(SCENES))
def test_rounds_any_match_jax(name):
    c = _case(name)
    occ = plain.rounds_any(*_any_args(c)).numpy()
    np.testing.assert_array_equal(occ, c["jocc"])
    assert occ[c["occ0"].numpy()].all()
    fresh = occ[~c["occ0"].numpy() & (c["tmax"].numpy() > 0)]
    assert 0.1 < fresh.mean() < 0.9


# ------------------------------------------- the kernels' way, emulated


def _next_entry(work0, last_tn, last_id):
    """The kernels' next pick for every ray: lane j of the ray's group takes
    the least (tn, id) among entries j, j + 16, ... after (last_tn,
    last_id), then a butterfly of shuffles (offsets 8, 4, 2, 1) takes the
    least over the 16 lanes; (+inf, I) where no entry is left."""
    n, r = work0.shape
    ids = torch.arange(n)[:, None].expand(n, r)
    after = (work0 > last_tn) | ((work0 == last_tn) & (ids > last_id))
    lanes_t = torch.full((16, r), INF)
    lanes_i = torch.full((16, r), n, dtype=torch.long)
    for i in range(n):  # each lane in its own order of i
        j = i % 16
        better = after[i] & ((work0[i] < lanes_t[j])
                             | ((work0[i] == lanes_t[j]) & (i < lanes_i[j])))
        lanes_t[j] = torch.where(better, work0[i], lanes_t[j])
        lanes_i[j] = torch.where(better, i, lanes_i[j])
    for off in (8, 4, 2, 1):
        partner = torch.arange(16) ^ off
        ot, oi = lanes_t[partner], lanes_i[partner]
        better = (ot < lanes_t) | ((ot == lanes_t) & (oi < lanes_i))
        lanes_t, lanes_i = torch.where(better, ot, lanes_t), torch.where(better, oi, lanes_i)
    assert (lanes_t == lanes_t[0]).all() and (lanes_i == lanes_i[0]).all()
    done = torch.isinf(last_tn) & (last_tn > 0)  # after a +inf pick: no scan
    return torch.where(done, INF, lanes_t[0]), torch.where(done, n, lanes_i[0])


def _tables():
    """(I, R) entry tables: random entries with +inf culls, columns all
    +inf, ties in tn across instances (and equal to 0), for I not a
    multiple of 16 and above it."""
    rng = np.random.default_rng(11)
    out = {}
    for n in (13, 16, 17, 37, 81):
        w = rng.choice(np.array([0.0, 0.5, 1.0, 2.0], np.float32), (n, 64))
        w = np.where(rng.random((n, 64)) < 0.5, w, rng.uniform(0, 3, (n, 64)))
        w[rng.random((n, 64)) < 0.3] = np.inf
        w[:, :4] = np.inf  # columns with no entry at all
        w[:, 4] = 1.0  # every instance tied
        out[n] = torch.from_numpy(w.astype(np.float32))
    return out


@pytest.mark.parametrize("n", [13, 16, 17, 37, 81])
def test_kernel_picks_equal_the_shortlist_round_by_round(n):
    """The kernels pick the entries in (tn, id) order after the last pick;
    ``shortlist_candidates`` picks the k argmins of the entries not yet
    set to +inf. Every round the picked entries are equal, and so are the
    ids of every finite pick (a +inf pick is never walked, and the plain
    version then re-picks entries it already set to +inf)."""
    work0 = _tables()[n]
    work = work0
    last_tn = torch.full((work0.shape[1],), -INF)
    last_id = torch.full((work0.shape[1],), -1, dtype=torch.long)
    for _ in range(-(-n // plain.INSTANCE_TOPK) + 1):
        ids, tns, work = plain.shortlist_candidates(work, plain.INSTANCE_TOPK)
        for k in range(plain.INSTANCE_TOPK):
            last_tn, last_id = _next_entry(work0, last_tn, last_id)
            assert torch.equal(last_tn, tns[k])
            fin = torch.isfinite(tns[k])
            assert torch.equal(last_id[fin], ids[k][fin])
    assert torch.isinf(work).all() and torch.isinf(last_tn).all()


def _record_frames(rec, motion, o, d, times):
    """csrc/bvh.cu's to_local, transcribed: the world rays (R, 3) in the
    frames of the records rec (N, 24) (one a ray, N = R, or (I, 1, 24)
    against every ray): moving_frame where the batch moves (q0 + dq t,
    normalized by its squares summed in order; p and s lerped with the
    host's end - start), else the start transform; then inverse_rotate
    with u = -q.xyz. Returns the local (o, d) as 3-tuples."""
    f = rec.unbind(-1)
    if motion:
        q = [f[4 + k] + f[12 + k] * times for k in range(4)]
        n = torch.sqrt(torch.clamp(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) + q[3] * q[3],
                                   min=1e-30))
        q = [x / n for x in q]
        p = [f[k] + f[8 + k] * times for k in range(3)]
        s = f[3] + f[11] * times
    else:
        q, p, s = f[4:8], f[0:3], f[3]
    o, d = o.unbind(-1), d.unbind(-1)
    return (inverse_rotate(q, tuple(o[k] - p[k] for k in range(3)), s),
            inverse_rotate(q, d, s))


def _record_entries(tab, o, d, times, tmax):
    """entry_of for every (instance, ray): (I, R), +inf where the box is
    missed or entered at or beyond tmax."""
    rec = tab.table[:, None, :]
    ol, dl = _record_frames(rec, tab.motion, o, d, times)
    f = rec.unbind(-1)
    may, tn = box_entry(f[16:19], f[20:23], ol, dl, tmax)
    return torch.where(may, tn, INF)


def _lane_entries(tab, o, d, times, tmax, kept):
    """The entries each scan reads: computed once (kept: the register
    form, each lane's KEPT entries) or again at every scan (kept 0)."""
    fixed = _record_entries(tab, o, d, times, tmax)
    if kept:
        assert len(tab.prims) <= 16 * kept
        return lambda: fixed
    return lambda: _record_entries(tab, o, d, times, tmax)


def _walk_pick(scene, tab, p_id, o, d, times, tmax, any_hit):
    """walk_instance: each ray's pick taken into its frame from its record
    again, walked under tmax (the plain walk, K3 / K4's plain version)."""
    rec = tab.table[torch.clamp(p_id, max=len(tab.prims) - 1)]
    ol, dl = _record_frames(rec, tab.motion, o, d, times)
    ints = rec.view(torch.int32)
    walk = ttrav.intersect_mesh_any if any_hit else ttrav.intersect_mesh
    return walk(scene.pool, ints[:, 19].contiguous(), ints[:, 23].contiguous(),
                torch.stack(ol, -1), torch.stack(dl, -1), tmax, stack_slots=tab.slots)


def _emulated_closest(scene, tab, o, d, times, best_t0, kept):
    """K6c's loop per ray from world rays: a ray with best t <= 0 does
    nothing; a round takes its k picks, each under the round-start best t,
    ends at its first pick not below that t, and takes the first of the
    least t; a ray leaves when its next pick is not below its best t."""
    entries = _lane_entries(tab, o, d, times, best_t0, kept)
    r = o.shape[0]
    last_tn, last_id = torch.full((r,), -INF), torch.full((r,), -1, dtype=torch.long)
    t_b, tri_b = best_t0.clone(), torch.full((r,), -1, dtype=torch.int32)
    inst_b = torch.zeros((r,), dtype=torch.long)
    live = best_t0 > 0
    p_tn, p_id = _next_entry(entries(), last_tn, last_id)
    live = live & (p_tn < t_b)
    while bool(live.any()):
        t_r, tri_r = torch.full((r,), INF), torch.full((r,), -1, dtype=torch.int32)
        inst_r = torch.zeros((r,), dtype=torch.long)
        in_round = live.clone()
        for k in range(plain.INSTANCE_TOPK):
            if k:
                nt, ni = _next_entry(entries(), last_tn, last_id)
                p_tn, p_id = torch.where(in_round, nt, p_tn), torch.where(in_round, ni, p_id)
            last_tn = torch.where(in_round, p_tn, last_tn)
            last_id = torch.where(in_round, p_id, last_id)
            in_round = in_round & (p_tn < t_b)
            t, tri = _walk_pick(scene, tab, p_id, o, d, times, torch.where(in_round, t_b, 0.0),
                                False)
            better = in_round & (tri >= 0) & (t < t_r)
            t_r, tri_r = torch.where(better, t, t_r), torch.where(better, tri, tri_r)
            inst_r = torch.where(better, p_id, inst_r)
        closer = live & (t_r < t_b)
        t_b, tri_b = torch.where(closer, t_r, t_b), torch.where(closer, tri_r, tri_b)
        inst_b = torch.where(closer, inst_r, inst_b)
        nt, ni = _next_entry(entries(), last_tn, last_id)
        p_tn, p_id = torch.where(live, nt, p_tn), torch.where(live, ni, p_id)
        live = live & (p_tn < t_b)
    return t_b, tri_b, inst_b


def _emulated_any(scene, tab, o, d, times, tmax, occ0, kept):
    """K6a's loop per ray from world rays: the entries below tmax in
    (entry, id) order, one at a time, until one occludes."""
    entries = _lane_entries(tab, o, d, times, tmax, kept)
    r = o.shape[0]
    last_tn, last_id = torch.full((r,), -INF), torch.full((r,), -1, dtype=torch.long)
    occ = occ0.clone()
    live = ~occ & (tmax > 0)
    while bool(live.any()):
        p_tn, p_id = _next_entry(entries(), last_tn, last_id)
        live = live & (p_tn < tmax)
        last_tn, last_id = torch.where(live, p_tn, last_tn), torch.where(live, p_id, last_id)
        hit = _walk_pick(scene, tab, p_id, o, d, times, torch.where(live, tmax, 0.0), True)
        occ = occ | (live & hit)
        live = live & ~hit
    return occ


def _assert_emulation_equals_plain(closest_args, any_args, kept):
    for a, b in zip(_emulated_closest(*closest_args, kept),
                    plain.rounds_closest_world(*closest_args)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(_emulated_any(*any_args, kept), plain.rounds_any_world(*any_args))


@pytest.mark.parametrize("name", list(SCENES))
def test_kernel_loop_equals_the_plain_rounds(name):
    """The kernels' per-ray loops from world rays (each lane's entries in
    registers, the picks, per-ray exit, walks under the round-start best
    t from the pick's record, the combine, K6a's stop at the first
    occluder) give the plain rounds' outputs bit for bit."""
    c = _case(name)
    _assert_emulation_equals_plain(_world_closest_args(c), _world_any_args(c),
                                   ops.kept_entries(len(c["tab"].prims)))


FRAME_CASES = {
    # (scene, hoist, rays): the recompute form on the line and the grid,
    # 144 turned and scaled instances (above 128: the recompute form),
    # 40 of which a third move, and the hoist off (every instance
    # interpolated at the ray's time)
    "line21 recompute": ("line21", True, 512),
    "grid81 recompute": ("grid81", True, 256),
    "turned144": ("turned144", True, 192),
    "moving40": ("moving40", True, 384),
    "moving40 recompute": ("moving40", True, 256),
    "turned40 hoist off": ("turned40", False, 384),
}
_FRAME_SCENES = {}


def _frame_scene(name):
    if name not in _FRAME_SCENES:
        if name in SCENES:
            _FRAME_SCENES[name] = _case(name)["tf"]
        else:
            n, moving = {"turned144": (144, False), "moving40": (40, True),
                         "turned40": (40, False)}[name]
            sc = turned_capsules(tmodel, tprocedural, n, moving=moving, seed=n)
            _FRAME_SCENES[name] = sc.flatten(device="cpu")
    return _FRAME_SCENES[name]


@pytest.mark.parametrize("case", list(FRAME_CASES))
def test_kernel_loop_forms_and_frames(case):
    """As ``test_kernel_loop_equals_the_plain_rounds``, with the entries
    computed again at every scan (the kernels' form above 128 instances),
    and on turned, scaled, moving instances and with the hoist off."""
    name, hoist, n = FRAME_CASES[case]
    tf = _frame_scene(name)
    tab = ops.table(tf, torch.device("cpu"), hoist)
    kept = 0 if "recompute" in case else ops.kept_entries(len(tab.prims))
    assert (kept == 0) == (len(tab.prims) > 128 or "recompute" in case)
    assert tab.motion == ("moving" in case or not hoist)
    big = list(layout(tf.prim_static, hoist).big)
    o, d, times, best, occ0 = map(torch.from_numpy, rays(tf, big, n, 3, line=name == "line21",
                                                          moving=tab.motion))
    tmax = torch.where(occ0, 0.0, best)
    closest = (tf, tab, o, d, times, best)
    _assert_emulation_equals_plain(closest, (tf, tab, o, d, times, tmax, occ0), kept)
    hit = plain.rounds_closest_world(*closest)[1] >= 0
    assert 0.05 < float(hit.float().mean()) < 0.95


# ------------------------------------------------------ the instance table


@pytest.mark.parametrize("case", ["instances16", "many_mesh19", "moving40", "turned40 hoist off"])
def test_instance_table_records(case):
    """Each record as csrc/bvh.cu reads it: start p, s, q, the host's end -
    start in f32, the root box in the mesh's frame, the node and triangle
    offsets as int bits; the batch's primitives, motion rule and stack
    bound."""
    name, hoist = (case.split()[0], False) if "hoist off" in case else (case, True)
    tf = _case(name)["tf"] if name in SCENES else _frame_scene(name)
    tab = ops.table(tf, torch.device("cpu"), hoist)
    big = list(layout(tf.prim_static, hoist).big)
    assert tab.prims == tuple(big) and tab.table.shape == (len(big), ops.RECORD_FLOATS)
    assert tab.table.dtype == torch.float32 and tab.table.is_contiguous()
    pr, sel = tf.prims, torch.tensor(big)
    rec = tab.table
    assert torch.equal(rec[:, 0:3], pr.start_p[sel]) and torch.equal(rec[:, 3], pr.start_s[sel])
    assert torch.equal(rec[:, 4:8], pr.start_q[sel])
    assert torch.equal(rec[:, 8:11], pr.end_p[sel] - pr.start_p[sel])
    assert torch.equal(rec[:, 11], pr.end_s[sel] - pr.start_s[sel])
    assert torch.equal(rec[:, 12:16], pr.end_q[sel] - pr.start_q[sel])
    handles = [tf.prim_static[i].mesh for i in big]
    assert torch.equal(tab.lower, torch.tensor([h.root_lower for h in handles], dtype=torch.float32))
    assert torch.equal(tab.upper, torch.tensor([h.root_upper for h in handles], dtype=torch.float32))
    assert tab.noff.tolist() == [h.node_offset for h in handles]
    assert tab.toff.tolist() == [h.tri_offset for h in handles]
    assert tab.slots == max(h.stack_slots for h in handles)
    assert tab.motion == (not hoist or any(tf.prim_static[i].motion for i in big))


def test_instance_table_is_kept_until_a_table_changes():
    """The table is packed once per scene, device and hoist setting, and
    again after an in-place change of a transform table or for another
    scene's tensors."""
    tf = _case("instances16")["tf"]
    cpu = torch.device("cpu")
    tab = ops.table(tf, cpu)
    assert ops.table(tf, cpu) is tab
    assert torch.equal(tab.table, torch.from_numpy(ops.pack_instances(tf)[0]))
    off = ops.table(tf, cpu, hoist=False)
    assert off is not tab and off.motion and not tab.motion
    prims = dataclasses.replace(tf.prims, start_p=tf.prims.start_p.clone())
    moved = dataclasses.replace(tf, prims=prims)
    again = ops.table(moved, cpu)
    assert again is not tab and torch.equal(again.table, tab.table)
    with torch.no_grad():
        prims.start_p[tab.prims[0], 0] += 1.0
    changed = ops.table(moved, cpu)
    assert changed is not again and bool(changed.table[0, 0] == tab.table[0, 0] + 1.0)
    assert ops.table(moved, cpu) is changed


# ------------------------------------------------------- the dispatcher


@pytest.mark.parametrize("name", list(SCENES))
def test_cpu_tensors_run_the_plain_rounds_and_launch_nothing(name):
    c = _case(name)
    ops.reset_launch_counts()
    ops_bvh.reset_launch_counts()
    for a, b in zip(ttrace._instance_rounds(*_world_closest_args(c)),
                    plain.rounds_closest_world(*_world_closest_args(c))):
        assert torch.equal(a, b) and a.dtype == b.dtype
    assert torch.equal(ttrace._instance_rounds_any(*_world_any_args(c)),
                       plain.rounds_any_world(*_world_any_args(c)))
    assert ops.launch_counts == {"rounds_closest": 0, "rounds_any": 0}
    assert ops_bvh.launch_counts == {"bvh_closest": 0, "bvh_any": 0, "bvh_steps": 0}


def test_no_rays_give_empty_outputs():
    c = _case("instances16")
    n = len(c["tab"].prims)
    empty = (c["tf"], c["tab"], c["o"][:0], c["d"][:0], c["times"][:0])
    t, tri, inst = ops.rounds_closest(*empty, c["best"][:0])
    assert t.shape == tri.shape == inst.shape == (0,)
    assert ops.rounds_any(*empty, c["tmax"][:0], c["occ0"][:0]).shape == (0,)
    assert n > ttrace.INSTANCE_TOPK_MIN


def _bad(args, what):
    """A wrapper's arguments (either kernel's: scene, table, origins, dirs,
    times, ...) with one of them made wrong."""
    a = list(args)
    tab = a[1]
    if what == "origins dtype":
        a[2] = a[2].double()
    elif what == "origins shape":
        a[2] = a[2][:, :2].contiguous()
    elif what == "dirs shape":
        a[3] = a[3][:-1]
    elif what == "dirs transposed":
        a[3] = a[3].t().contiguous().t()
    elif what == "times shape":
        a[4] = a[4][:, None]
    elif what == "best_t0 dtype":
        a[5] = a[5].half()
    elif what == "table dtype":
        a[1] = dataclasses.replace(tab, table=tab.table.double())
    elif what == "table shape":
        a[1] = dataclasses.replace(tab, table=tab.table[:, :20].contiguous())
    elif what == "stack slots":
        a[1] = dataclasses.replace(tab, slots=0)
    return a


BAD = {"origins dtype": (TypeError, "origins"), "origins shape": (ValueError, "origins"),
       "dirs shape": (ValueError, "dirs: expected shape"),
       "dirs transposed": (ValueError, "dirs: expected a contiguous"),
       "times shape": (ValueError, "times: expected shape"),
       "best_t0 dtype": (TypeError, "best_t0|tmax"), "table dtype": (TypeError, "table"),
       "table shape": (ValueError, "table: expected shape"),
       "stack slots": (ValueError, "stack_slots"), "cpu tensors": (ValueError, "CUDA")}


@pytest.mark.parametrize("what", list(BAD))
def test_kernel_wrappers_refuse_bad_arguments(what):
    """Every argument check of the wrappers, reached with CPU tensors
    (dtype, shape and contiguity are checked before the device); nothing
    is launched or counted."""
    c = _case("instances16")
    ops.reset_launch_counts()
    error, match = BAD[what]
    with pytest.raises(error, match=match):
        ops.rounds_closest_cuda(*_bad(_world_closest_args(c), what))
    with pytest.raises(error, match=match):
        ops.rounds_any_cuda(*_bad(_world_any_args(c), what))
    assert ops.launch_counts == {"rounds_closest": 0, "rounds_any": 0}


@pytest.mark.parametrize("name", ["instances16", "many_mesh19"])
def test_trace_hands_the_kernels_what_they_take(name, monkeypatch):
    """What K6c / K6a's wrappers check on the card, checked on the calls
    trace_closest / trace_any make: f32 contiguous world rays, (R,) times
    and best t / tmax, bool occlusion, the scene's instance table."""
    c = _case(name)
    calls = []
    for fn in ("rounds_closest", "rounds_any"):
        orig = getattr(ops, fn)

        def rec(*a, _fn=fn, _orig=orig):
            calls.append((_fn, a))
            return _orig(*a)

        monkeypatch.setattr(ops, fn, rec)
    rng = np.random.default_rng(5)
    o = torch.from_numpy(np.stack([rng.uniform(-3, 3, 256), np.full(256, 3.0),
                                   rng.uniform(-3, 3, 256)], -1).astype(np.float32))
    d = torch.nn.functional.normalize(torch.tensor([[0.05, -1.0, 0.02]]).expand(256, 3), dim=-1)
    ttrace.trace_closest(c["tf"], o, d.contiguous(), torch.zeros(256))
    ttrace.trace_any(c["tf"], o, d.contiguous(), torch.zeros(256), 5.0)
    assert [k for k, _ in calls] == ["rounds_closest", "rounds_any"]
    n = len(c["tab"].prims)
    for kind, (_, tab, o_, d_, times, *per_ray) in calls:
        assert tab is ops.table(c["tf"], torch.device("cpu"))
        for t, dtype, shape in ((o_, torch.float32, (256, 3)), (d_, torch.float32, (256, 3)),
                                (times, torch.float32, (256,)), (per_ray[0], torch.float32, (256,)),
                                (tab.table, torch.float32, (n, ops.RECORD_FLOATS))):
            assert t.dtype == dtype and tuple(t.shape) == shape and t.is_contiguous()
        if kind == "rounds_any":
            assert per_ray[1].dtype == torch.bool and per_ray[1].is_contiguous()
        assert tab.slots == c["slots"]


@pytest.mark.parametrize("name", ["instances16", "grid81"])
def test_rounds_path_builds_no_instance_ray_tensor(name, monkeypatch):
    """trace_closest / trace_any on the rounds path build no tensor of I x
    R elements or more: every op's output is recorded while the sweep and
    the rounds (whose plain versions on this machine do build such tables,
    and whose kernels allocate their outputs only) return their results
    computed beforehand."""
    from torch.utils._python_dispatch import TorchDispatchMode

    c = _case(name)
    tf, o, d, times = c["tf"], c["o"], c["d"], c["times"]
    n_inst, r = len(c["tab"].prims), o.shape[0]
    tmax = torch.where(torch.isfinite(c["best"]), c["best"], 20.0)
    done = {}
    for mod, fn in ((ops_sweep, "sweep_closest"), (ops_sweep, "sweep_any"),
                    (ops, "rounds_closest"), (ops, "rounds_any")):
        real = getattr(mod, fn)

        def canned(*a, _fn=fn, _real=real, **k):
            if _fn not in done:
                done[_fn] = _real(*a, **k)
            return done[_fn]

        monkeypatch.setattr(mod, fn, canned)
    ttrace.trace_closest(tf, o, d, times)
    ttrace.trace_any(tf, o, d, times, tmax)

    class Sizes(TorchDispatchMode):
        largest = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if torch.is_tensor(t):
                    Sizes.largest = max(Sizes.largest, t.numel())
            return out

    with Sizes():
        ttrace.trace_closest(tf, o, d, times)
        ttrace.trace_any(tf, o, d, times, tmax)
    assert set(done) == {"sweep_closest", "sweep_any", "rounds_closest", "rounds_any"}
    assert 0 < Sizes.largest < n_inst * r


def test_rounds_path_gradients_match_jax():
    """d/d(origins, dirs, start_p, start_q, start_s) of sum(a t) + sum(b n)
    over the rays that hit, through trace_closest on instances16 (16
    instances: the rounds path, the winner refit from its own transform
    rows) and through jax.grad of the JAX trace_closest: every leaf within
    1e-3 of its largest entry (tests/test_torch_gradients.py's rule)."""
    c = _case("instances16")
    jf, tf = c["jf"], c["tf"]
    o, d, times = c["o"].numpy(), c["d"].numpy(), c["times"].numpy()
    rng = np.random.default_rng(9)
    a = rng.normal(size=R).astype(np.float32)
    b = rng.normal(size=(R, 3)).astype(np.float32)
    fields = ("start_p", "start_q", "start_s")

    def jloss(o_, d_, *leaves):
        f = dataclasses.replace(jf, prims=dataclasses.replace(jf.prims, **dict(zip(fields,
                                                                                  leaves))))
        h = jtrace.trace_closest(f, o_, d_, jnp.asarray(times))
        return jnp.sum(a * jnp.where(h.prim >= 0, h.t, 0.0)) + jnp.sum(b * h.normal), h.prim

    (_, jprim), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4), has_aux=True))(
        jnp.asarray(o), jnp.asarray(d), *(getattr(jf.prims, f) for f in fields))
    leaves = [torch.from_numpy(o).requires_grad_(True), torch.from_numpy(d).requires_grad_(True),
              *(getattr(tf.prims, f).detach().clone().requires_grad_(True) for f in fields)]
    sc = dataclasses.replace(tf, prims=dataclasses.replace(tf.prims, **dict(zip(fields,
                                                                               leaves[2:]))))
    h = ttrace.trace_closest(sc, leaves[0], leaves[1], torch.from_numpy(times))
    loss = (torch.sum(torch.from_numpy(a) * torch.where(h.prim >= 0, h.t, 0.0))
            + torch.sum(torch.from_numpy(b) * h.normal))
    tg = torch.autograd.grad(loss, leaves)
    np.testing.assert_array_equal(h.prim.numpy(), np.asarray(jprim))
    assert 0.15 < float((h.prim >= 0).float().mean()) < 0.9
    for name, got, want in zip(("origins", "dirs", *fields), tg, jg):
        want = np.asarray(want)
        assert got.shape == want.shape, name
        scale = max(float(np.abs(want).max()), 1e-12)
        assert float(np.abs(got.numpy() - want).max()) / scale <= 1e-3, name
    big = list(c["tab"].prims)
    assert float(tg[2][big].abs().max()) > 0 and float(tg[3][big].abs().max()) > 0
