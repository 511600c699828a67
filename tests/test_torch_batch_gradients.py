"""Gradients through the batch of at most 12 big instances against jax.grad:
d/d(origins, dirs, start_p, start_q, start_s, end_p, end_q, end_s) of
sum(a t) + sum(b n) over the rays that hit, through trace_closest on
envmesh (one instance, static), on five turned capsules of which two move
(the whole batch interpolates at the ray's time), and on envmesh with
STATIC_TRANSFORM_HOIST off (its static instance interpolates too, so end_*
gets the time's share). The discrete search runs without gradient in both
packages; the winner is intersected again under autograd from its own
transform rows (``render/trace.py::_big_closest``). Rule of
tests/test_torch_instances.py's rounds-path test: every leaf within 1e-3
of its largest entry, the hit primitives equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinsel_tpu.scene as jpkg
import tinsel_tpu_torch.scene as tpkg
from tinsel_tpu.render import trace as jtrace
from tinsel_tpu.scene import model as jmodel  # noqa: F401 (jpkg.model)
from tinsel_tpu.scene import presets as jpresets  # noqa: F401 (jpkg.presets)
from tinsel_tpu.scene import procedural as jprocedural  # noqa: F401
from tinsel_tpu_torch.accel.sweep import layout
from tinsel_tpu_torch.render import trace as ttrace
from tinsel_tpu_torch.scene import model as tmodel  # noqa: F401 (tpkg.model)
from tinsel_tpu_torch.scene import presets as tpresets  # noqa: F401 (tpkg.presets)
from tinsel_tpu_torch.scene import procedural as tprocedural  # noqa: F401

from test_torch_instances_cuda import rays, turned_capsules

torch.set_num_threads(2)
R = 512
FIELDS = ("start_p", "start_q", "start_s", "end_p", "end_q", "end_s")
# (scene builder, hoist, rays with times in [0, 1))
CASES = {
    "envmesh": (lambda pkg: pkg.presets.envmesh_scene(32, 32, 4, detail=24), True, False),
    "moving5": (lambda pkg: turned_capsules(pkg.model, pkg.procedural, 5, moving=True, seed=4),
                True, True),
    "envmesh_hoist_off": (lambda pkg: pkg.presets.envmesh_scene(32, 32, 4, detail=24), False,
                          True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_batch_transform_gradients_match_jax(case, monkeypatch):
    build, hoist, moving = CASES[case]
    monkeypatch.setattr(jtrace, "STATIC_TRANSFORM_HOIST", hoist)
    monkeypatch.setattr(ttrace, "STATIC_TRANSFORM_HOIST", hoist)
    jf, tf = build(jpkg).flatten(), build(tpkg).flatten(device="cpu")
    big = list(layout(tf.prim_static, hoist).big)
    assert 1 <= len(big) <= ttrace.INSTANCE_TOPK_MIN
    o, d, times, _, _ = rays(tf, big, R, 11, moving=moving)
    rng = np.random.default_rng(12)
    a = rng.normal(size=R).astype(np.float32)
    b = rng.normal(size=(R, 3)).astype(np.float32)

    def jloss(o_, d_, *leaves):
        f = dataclasses.replace(jf, prims=dataclasses.replace(jf.prims, **dict(zip(FIELDS,
                                                                                  leaves))))
        h = jtrace.trace_closest(f, o_, d_, jnp.asarray(times))
        return jnp.sum(a * jnp.where(h.prim >= 0, h.t, 0.0)) + jnp.sum(b * h.normal), h.prim

    (_, jprim), jg = jax.jit(jax.value_and_grad(jloss, argnums=tuple(range(8)), has_aux=True))(
        jnp.asarray(o), jnp.asarray(d), *(getattr(jf.prims, f) for f in FIELDS))
    leaves = [torch.from_numpy(o).requires_grad_(True), torch.from_numpy(d).requires_grad_(True),
              *(getattr(tf.prims, f).detach().clone().requires_grad_(True) for f in FIELDS)]
    sc = dataclasses.replace(tf, prims=dataclasses.replace(tf.prims, **dict(zip(FIELDS,
                                                                               leaves[2:]))))
    h = ttrace.trace_closest(sc, leaves[0], leaves[1], torch.from_numpy(times))
    loss = (torch.sum(torch.from_numpy(a) * torch.where(h.prim >= 0, h.t, 0.0))
            + torch.sum(torch.from_numpy(b) * h.normal))
    tg = torch.autograd.grad(loss, leaves, allow_unused=True)
    np.testing.assert_array_equal(h.prim.numpy(), np.asarray(jprim))
    on_big = np.isin(h.prim.numpy(), big)
    assert 0.15 < on_big.mean() < 0.95
    for name, got, want, leaf in zip(("origins", "dirs", *FIELDS), tg, jg, leaves):
        want = np.asarray(want)
        got = np.zeros(leaf.shape, np.float32) if got is None else got.numpy()
        assert got.shape == want.shape, name
        scale = max(float(np.abs(want).max()), 1e-12)
        assert float(np.abs(got - want).max()) / scale <= 1e-3, name
    grads = dict(zip(FIELDS, tg[2:]))
    for f in ("start_p", "start_q", "start_s"):
        assert float(grads[f][big].abs().max()) > 0, f
    # the time's share reaches end_* where the batch interpolates
    interpolated = moving or not hoist
    end = [grads[f] for f in ("end_p", "end_q", "end_s")]
    assert all(g is not None and float(g[big].abs().max()) > 0 for g in end) == interpolated
