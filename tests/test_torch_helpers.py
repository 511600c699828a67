"""The port's leftover public helpers against tinsel_tpu's, the path-seeded
uniform source, the profiling module, and the coverage of tinsel_tpu's
public names by the port.

Tolerances: the math helpers 1e-6 (the same f32 formulas; a rotation
goes through two cross products), Perlin noise exact (NumPy float64 on
both sides), the stratified offsets exact at equal draws, ``validate_bvh``
the same verdict.
"""

import ast
import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinsel_tpu.accel import build as jbuild
from tinsel_tpu.core import math as jmath
from tinsel_tpu.core import sampling as jsampling
from tinsel_tpu.geometry import intersect as jintersect
from tinsel_tpu.utils import perlin as jperlin
from tinsel_tpu_torch.accel import build as tbuild
from tinsel_tpu_torch.core import math as tmath
from tinsel_tpu_torch.core import sampling as tsampling
from tinsel_tpu_torch.core.sampling import PathUniforms
from tinsel_tpu_torch.geometry import intersect as tintersect
from tinsel_tpu_torch.utils import perlin as tperlin
from tinsel_tpu_torch.utils import profiling

from torch_parity import JaxUniforms

TOL = dict(rtol=1e-6, atol=1e-6)
REPO = pathlib.Path(__file__).resolve().parent.parent


def _transforms(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    p = rng.normal(size=(n, 3)).astype(np.float32)
    s = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return (jmath.Transform(p=jnp.asarray(p), q=jnp.asarray(q), s=jnp.asarray(s)),
            tmath.Transform(p=torch.from_numpy(p), q=torch.from_numpy(q), s=torch.from_numpy(s)))


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_transform_compose_and_inverse_match_jax():
    rng = np.random.default_rng(0)
    ja, ta = _transforms(rng, 64)
    jb, tb = _transforms(rng, 64)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    jc, tc = jmath.transform_compose(ja, jb), tmath.transform_compose(ta, tb)
    ji, ti = jmath.transform_inverse(ja), tmath.transform_inverse(ta)
    for f in ("p", "q", "s"):
        _close(getattr(tc, f), getattr(jc, f))
        _close(getattr(ti, f), getattr(ji, f))
    # composition is application in turn, inverse undoes
    tv = torch.from_numpy(v)
    got = tmath.transform_point(tc, tv)
    want = tmath.transform_point(ta, tmath.transform_point(tb, tv))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    back = tmath.transform_point(ti, tmath.transform_point(ta, tv))
    np.testing.assert_allclose(back.numpy(), v, rtol=1e-5, atol=1e-5)


def test_small_math_helpers_match_jax():
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(2, 5, 3)).astype(np.float32)
    _close(tmath.vdot(torch.from_numpy(a), torch.from_numpy(b)), jmath.vdot(a, b))
    assert tmath.vdot(torch.from_numpy(a), torch.from_numpy(b)).shape == (5, 1)
    for shape in ((), (3,), (2, 4)):
        _close(tmath.quat_identity(shape), jmath.quat_identity(shape))
    m = rng.normal(size=(4, 4)).astype(np.float32)
    pts = rng.normal(size=(7, 3)).astype(np.float32)
    _close(tmath.transform_point_mat44(torch.from_numpy(m), torch.from_numpy(pts)),
           jmath.transform_point_mat44(jnp.asarray(m), jnp.asarray(pts)))


def test_triangle_area_matches_jax():
    rng = np.random.default_rng(2)
    a, b, c = rng.normal(size=(3, 50, 3)).astype(np.float32)
    c[0] = a[0]  # a degenerate triangle: area 0
    got = tintersect.triangle_area(*(torch.from_numpy(x) for x in (a, b, c)))
    _close(got, jintersect.triangle_area(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)))
    assert float(got[0]) == 0.0


@pytest.mark.parametrize("period", [None, 8])
def test_perlin_1d_2d_equal_jax(period):
    x = np.linspace(-3, 17, 301)
    y = np.linspace(0.1, 5.3, 301)
    np.testing.assert_array_equal(tperlin.perlin1d(x, period), jperlin.perlin1d(x, period))
    np.testing.assert_array_equal(tperlin.perlin2d(x, y, period), jperlin.perlin2d(x, y, period))


def test_stratified_offsets_equal_jax_at_equal_draws():
    key = jax.random.key(9)
    src = JaxUniforms(key)
    got = tsampling.stratified_offsets_2d(4, 3, src)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsampling.stratified_offsets_2d(4, 3, key)))
    got1 = tsampling.stratified_offsets_1d(7, src)
    np.testing.assert_array_equal(got1.numpy(), np.asarray(jsampling.stratified_offsets_1d(7, key)))
    # one sample in each stratum
    cells = np.floor(got.numpy() * [4, 3]).astype(int)
    assert len({tuple(c) for c in cells}) == 12


def test_validate_bvh_same_verdict_as_jax():
    rng = np.random.default_rng(3)
    lo = rng.random((300, 3)).astype(np.float32)
    hi = lo + rng.random((300, 3)).astype(np.float32) * 0.1
    bvh = tbuild.build_bvh(lo, hi, use_native=False)
    jb = jbuild.build_bvh(lo, hi, use_native=False)
    assert tbuild.validate_bvh(bvh, lo, hi) is True
    assert jbuild.validate_bvh(jb, lo, hi) is True
    # an item in no leaf (one more item than the tree holds): both say False
    lo2, hi2 = np.concatenate([lo, lo[:1]]), np.concatenate([hi, hi[:1]])
    assert tbuild.validate_bvh(bvh, lo2, hi2) is False
    assert jbuild.validate_bvh(jb, lo2, hi2) is False
    # a node box that does not hold its items: both raise
    bvh.lower = bvh.lower + 0.5
    jb.lower = bvh.lower
    with pytest.raises(AssertionError):
        tbuild.validate_bvh(bvh, lo, hi)
    with pytest.raises(AssertionError):
        jbuild.validate_bvh(jb, lo, hi)


def test_path_uniforms_depend_on_seed_path_and_shape_only():
    a, b = PathUniforms(5, "cpu"), PathUniforms(5, "cpu")
    x = a.uniform((1, 2, 3), (4, 5))
    b.uniform((0,), (100,))  # another draw first: must not matter
    b.randint((7,), (3,), 0, 10)
    assert torch.equal(b.uniform((1, 2, 3), (4, 5)), x)
    assert x.dtype == torch.float32 and ((x >= 0) & (x < 1)).all()
    assert not torch.equal(a.uniform((1, 2, 4), (4, 5)), x)  # another path
    assert not torch.equal(PathUniforms(6, "cpu").uniform((1, 2, 3), (4, 5)), x)
    r = a.randint((2,), (1000,), 3, 9)
    assert torch.equal(r, b.randint((2,), (1000,), 3, 9))
    assert int(r.min()) == 3 and int(r.max()) == 8
    # a prefixed source names the same draws: (c,) + path
    assert torch.equal(tsampling.Prefixed(a, 1, 2).uniform((3,), (4, 5)), x)


def test_profiling_sync_timer_and_trace(tmp_path, capsys):
    x = torch.ones(3)
    assert profiling.sync(x) is x
    assert profiling.sync({"a": [1, (x,)]})["a"][1][0] is x
    assert profiling.sync(5) == 5
    with profiling.timer("blk", rays=1000) as t:
        t.watch(x * 2)
    assert t.elapsed > 0
    assert "[blk]" in capsys.readouterr().out
    with profiling.profiler_trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert trace["traceEvents"]


# tinsel_tpu's public names with no counterpart in the port, each for a
# reason ROADMAP.md records: TPU machinery, JAX key plumbing (the port's
# UniformSource replaces fold_key / uniforms), the Pallas kernels' own
# names (their port is ops/nlm.py).
NOT_PORTED = {
    "accel/build.py": {"set_wide_k", "set_block_size", "pack_nodes", "compute_skip_links"},
    "accel/packets.py": {"intersect_mesh_packets"},
    "core/sampling.py": {"fold_key", "uniforms"},
    "ops/pallas/nlm.py": {"nlm_filter_pallas", "nlm_guided_pallas", "nlm_denoise",
                          "nlm_guided_denoise"},
    "utils/compile_cache.py": {"enable_compile_cache"},
    "utils/profiling.py": {"xla_trace"},
}


def _public(path):
    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


def test_port_covers_the_public_names_of_tinsel_tpu():
    missing = {}
    for path in sorted((REPO / "tinsel_tpu").rglob("*.py")):
        rel = path.relative_to(REPO / "tinsel_tpu").as_posix()
        port = REPO / "tinsel_tpu_torch" / rel
        have = _public(port) if port.exists() else set()
        gap = _public(path) - have - NOT_PORTED.get(rel, set())
        if gap:
            missing[rel] = sorted(gap)
    assert not missing, missing
    assert os.path.exists(REPO / "tinsel_tpu_torch" / "ops" / "nlm.py")
