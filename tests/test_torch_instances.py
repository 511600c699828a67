"""The instance shortlist rounds: their plain version (``accel/instances.py``,
the plain version of kernels K6c and K6a) against tinsel_tpu's
``_instance_rounds`` / ``_instance_rounds_any``, and the kernels' way of
picking and combining, emulated here with torch ops, against the plain
rounds.

Each package builds its own inputs with its own functions (local rays,
box entries, offsets) from the same numpy rays. Tolerances as
tests/test_torch_traverse.py: the hit sets equal, t within rtol 2e-5 /
atol 1e-6 (XLA rounds the JAX walk's products in another order), the
triangle and instance equal where the hit is unique (no other instance's
t within 1e-5 relative), occlusion equal. The kernels themselves run in
tests/test_torch_instances_cuda.py on the card.
"""

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
from tinsel_tpu_torch.accel.sweep import layout
from tinsel_tpu_torch.geometry.intersect import INF
from tinsel_tpu_torch.ops import bvh as ops_bvh
from tinsel_tpu_torch.ops import instances as ops
from tinsel_tpu_torch.render import trace as ttrace
from tinsel_tpu_torch.scene import model as tmodel  # noqa: F401 (tpkg.model)
from tinsel_tpu_torch.scene import presets as tpresets  # noqa: F401 (tpkg.presets)
from tinsel_tpu_torch.scene import procedural as tprocedural  # noqa: F401

from test_torch_instances_cuda import rays, sphere_line

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
        tf=tf, o_l=o_l, d_l=d_l, tn=tn, noff=noff, toff=toff, slots=slots,
        best=torch.from_numpy(best), tmax=torch.from_numpy(tmax), occ0=torch.from_numpy(occ0),
        jt=np.asarray(jt), jtri=np.asarray(jtri), jinst=np.asarray(jinst), jocc=np.asarray(jocc))
    return c


def _closest_args(c):
    return (c["tf"], c["o_l"], c["d_l"], c["tn"]["closest"], c["best"], c["noff"], c["toff"],
            c["slots"])


def _any_args(c):
    return (c["tf"], c["o_l"], c["d_l"], c["tn"]["any"], c["tmax"], c["occ0"], c["noff"],
            c["toff"], c["slots"])


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


def _emulated_closest(scene, o_l, d_l, tn, best_t0, noff, toff, slots):
    """K6c's loop per ray, with the plain walk: a ray leaves when its next
    pick is not below its best t; a round walks its k picks under the
    round-start best t and takes the first of the least t."""
    n, r = tn.shape
    lanes = torch.arange(r)
    last_tn, last_id = torch.full((r,), -INF), torch.full((r,), -1, dtype=torch.long)
    t_b, tri_b = best_t0.clone(), torch.full((r,), -1, dtype=torch.int32)
    inst_b = torch.zeros((r,), dtype=torch.long)
    p_tn, p_id = _next_entry(tn, last_tn, last_id)
    live = p_tn < t_b
    while bool(live.any()):
        t_r, tri_r = torch.full((r,), INF), torch.full((r,), -1, dtype=torch.int32)
        inst_r = torch.zeros((r,), dtype=torch.long)
        for k in range(plain.INSTANCE_TOPK):
            if k:
                p_tn, p_id = _next_entry(tn, last_tn, last_id)
            last_tn = torch.where(live, p_tn, last_tn)
            last_id = torch.where(live, p_id, last_id)
            walk = live & (p_tn < t_b) & (t_b > 0)
            i = torch.clamp(p_id, max=n - 1)
            t, tri = ttrav.intersect_mesh(scene.pool, noff[i], toff[i], o_l[i, lanes],
                                          d_l[i, lanes], torch.where(walk, t_b, 0.0),
                                          stack_slots=slots)
            better = walk & (tri >= 0) & (t < t_r)
            t_r, tri_r = torch.where(better, t, t_r), torch.where(better, tri, tri_r)
            inst_r = torch.where(better, p_id, inst_r)
        closer = live & (t_r < t_b)
        t_b, tri_b = torch.where(closer, t_r, t_b), torch.where(closer, tri_r, tri_b)
        inst_b = torch.where(closer, inst_r, inst_b)
        p_tn, p_id = _next_entry(tn, last_tn, last_id)
        live = live & (p_tn < t_b)
    return t_b, tri_b, inst_b


def _emulated_any(scene, o_l, d_l, tn, tmax, occ0, noff, toff, slots):
    """K6a's loop per ray: the entries below tmax in (tn, id) order, one
    at a time, until one occludes."""
    n, r = tn.shape
    lanes = torch.arange(r)
    last_tn, last_id = torch.full((r,), -INF), torch.full((r,), -1, dtype=torch.long)
    occ = occ0.clone()
    live = ~occ & (tmax > 0)
    while bool(live.any()):
        p_tn, p_id = _next_entry(tn, last_tn, last_id)
        live = live & (p_tn < tmax)
        last_tn, last_id = torch.where(live, p_tn, last_tn), torch.where(live, p_id, last_id)
        i = torch.clamp(p_id, max=n - 1)
        hit = ttrav.intersect_mesh_any(scene.pool, noff[i], toff[i], o_l[i, lanes],
                                       d_l[i, lanes], torch.where(live, tmax, 0.0),
                                       stack_slots=slots)
        occ = occ | (live & hit)
        live = live & ~hit
    return occ


@pytest.mark.parametrize("name", list(SCENES))
def test_kernel_loop_equals_the_plain_rounds(name):
    """The kernels' per-ray loops (per-ray exit, sequential picks, walks
    under the round-start best t, the combine, K6a's stop at the first
    occluder) give the plain rounds' outputs bit for bit."""
    c = _case(name)
    for a, b in zip(_emulated_closest(*_closest_args(c)), plain.rounds_closest(*_closest_args(c))):
        assert torch.equal(a, b)
    assert torch.equal(_emulated_any(*_any_args(c)), plain.rounds_any(*_any_args(c)))


# ------------------------------------------------------- the dispatcher


@pytest.mark.parametrize("name", list(SCENES))
def test_cpu_tensors_run_the_plain_rounds_and_launch_nothing(name):
    c = _case(name)
    ops.reset_launch_counts()
    ops_bvh.reset_launch_counts()
    for a, b in zip(ttrace._instance_rounds(*_closest_args(c)),
                    plain.rounds_closest(*_closest_args(c))):
        assert torch.equal(a, b) and a.dtype == b.dtype
    assert torch.equal(ttrace._instance_rounds_any(*_any_args(c)), plain.rounds_any(*_any_args(c)))
    assert ops.launch_counts == {"rounds_closest": 0, "rounds_any": 0}
    assert ops_bvh.launch_counts == {"bvh_closest": 0, "bvh_any": 0, "bvh_steps": 0}


def test_no_rays_give_empty_outputs():
    c = _case("instances16")
    n = c["o_l"].shape[0]
    empty = (c["tf"], c["o_l"][:, :0], c["d_l"][:, :0], c["tn"]["closest"][:, :0],
             c["best"][:0], c["noff"], c["toff"], c["slots"])
    t, tri, inst = ops.rounds_closest(*empty)
    assert t.shape == tri.shape == inst.shape == (0,)
    assert ops.rounds_any(*empty[:4], c["tmax"][:0], c["occ0"][:0], *empty[5:]).shape == (0,)
    assert n > ttrace.INSTANCE_TOPK_MIN


def _bad(c, what):
    """K6c's arguments with one of them made wrong."""
    a = list(_closest_args(c))
    if what == "o_l dtype":
        a[1] = a[1].double()
    elif what == "d_l shape":
        a[2] = a[2][:, :-1]
    elif what == "tn transposed":
        a[3] = a[3].t().contiguous().t()
    elif what == "best_t0 dtype":
        a[4] = a[4].half()
    elif what == "noff dtype":
        a[5] = a[5].long()
    elif what == "toff shape":
        a[6] = a[6][:-1]
    elif what == "stack slots":
        a[7] = 0
    return a


BAD = {"o_l dtype": (TypeError, "o_l"), "d_l shape": (ValueError, "d_l: expected shape"),
       "tn transposed": (ValueError, "tn: expected a contiguous"),
       "best_t0 dtype": (TypeError, "best_t0|occ"), "noff dtype": (TypeError, "noff"),
       "toff shape": (ValueError, "toff: expected shape"),
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
        ops.rounds_closest_cuda(*_bad(c, what))
    any_args = list(_any_args(c))
    if what == "best_t0 dtype":
        any_args[5] = any_args[5].float()  # occ as f32, not bool
    elif what == "stack slots":
        any_args[8] = 0
    elif what != "cpu tensors":
        any_args[1:4] = _bad(c, what)[1:4]
        any_args[6:8] = _bad(c, what)[5:7]
    with pytest.raises(error, match=match):
        ops.rounds_any_cuda(*any_args)
    assert ops.launch_counts == {"rounds_closest": 0, "rounds_any": 0}


@pytest.mark.parametrize("name", ["instances16", "many_mesh19"])
def test_trace_hands_the_kernels_what_they_take(name, monkeypatch):
    """What K6c / K6a's wrappers check on the card, checked on the calls
    trace_closest / trace_any make: f32 contiguous local rays and entries,
    (R,) best t / tmax and occlusion, (I,) int32 offsets."""
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
    n = c["o_l"].shape[0]
    for kind, (_, o_l, d_l, tn, *per_ray) in calls:
        noff, toff, slots = per_ray[-3:]
        for t, dtype, shape in ((o_l, torch.float32, (n, 256, 3)), (d_l, torch.float32, (n, 256, 3)),
                                (tn, torch.float32, (n, 256)), (noff, torch.int32, (n,)),
                                (toff, torch.int32, (n,)), (per_ray[0], torch.float32, (256,))):
            assert t.dtype == dtype and tuple(t.shape) == shape and t.is_contiguous()
        if kind == "rounds_any":
            assert per_ray[1].dtype == torch.bool and per_ray[1].is_contiguous()
        assert slots == c["slots"]
