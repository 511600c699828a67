"""The port's native BVH builder (native/bvh_builder.cpp through
native/bvh_native.py) against tinsel_tpu's: binary and wide trees bit for
bit, the same dispatch thresholds, and a failed build raises."""

import numpy as np
import pytest

import torch_parity  # noqa: F401  (builds tinsel_tpu's native library once, locked)
from tinsel_tpu.accel import build as jbuild
from tinsel_tpu.native import bvh_native as jnative
from tinsel_tpu_torch.accel import build as tbuild
from tinsel_tpu_torch.native import bvh_native as tnative
from tinsel_tpu_torch.ops import _build
from tinsel_tpu_torch.scene import procedural as tproc
from tinsel_tpu_torch.utils.perlin import fractal3d

BVH_FIELDS = ("lower", "upper", "left", "right", "leaf", "count", "perm")


def _perlin_sphere(detail):
    """envmesh's mesh: a Perlin-displaced sphere of 2 * detail^2 triangles."""
    m = tproc.sphere(0.8, detail, detail)
    p = m.positions
    disp = np.asarray(fractal3d(p[:, 0] * 3.0, p[:, 1] * 3.0, p[:, 2] * 3.0, octaves=4))
    r = np.linalg.norm(p, axis=-1, keepdims=True)
    return (p / np.maximum(r, 1e-9)) * (0.8 + 0.18 * disp[:, None]).astype(np.float32), m.indices


def _soup(n, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-10, 10, (n, 1, 3))
    size = rng.choice([0.05, 0.5, 3.0], (n, 1, 1))
    pos = (c + rng.normal(size=(n, 3, 3)) * size).reshape(-1, 3).astype(np.float32)
    return pos, np.arange(3 * n, dtype=np.int32).reshape(n, 3)


MESHES = {
    "perlin_sphere_8192": lambda: _perlin_sphere(64),
    "soup_6000": lambda: _soup(6000, 7),
    "soup_40000": lambda: _soup(40000, 9),  # over 4,096 binary nodes
}


def assert_wide_equal(a, b):
    np.testing.assert_array_equal(a.node_rows.view(np.uint32), b.node_rows.view(np.uint32))
    np.testing.assert_array_equal(a.perm_padded, b.perm_padded)
    np.testing.assert_array_equal(a.real_mask, b.real_mask)
    np.testing.assert_array_equal(a.root_lower, b.root_lower)
    np.testing.assert_array_equal(a.root_upper, b.root_upper)
    assert a.k == b.k


@pytest.mark.parametrize("leaf_size", [16, 4])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_native_trees_match_jax(mesh, leaf_size):
    pos, idx = MESHES[mesh]()
    lo, hi = tbuild.triangle_bounds(pos, idx)
    a = tnative.build_bvh_native(lo, hi, leaf_size=leaf_size)
    b = jnative.build_bvh_native(lo, hi, leaf_size=leaf_size)
    for f in BVH_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    for k in (4, 8, 16):
        wa = tnative.collapse_wide_native(a, k=k, block_size=16)
        assert_wide_equal(wa, jnative.collapse_wide_native(b, k=k, block_size=16))
        # the native collapse equals the port's NumPy collapse
        assert_wide_equal(wa, tbuild.build_wide_bvh(a, k=k, use_native=False))
    if leaf_size == 16:
        assert tbuild.validate_wide_bvh(tbuild.build_wide_bvh(a), lo, hi, len(idx))


@pytest.mark.parametrize("n", [4095, 4096])
def test_build_bvh_dispatches_at_the_jax_threshold(n, monkeypatch):
    """SAH over n >= 4,096 items goes native in both packages (and their
    trees agree); median / midpoint and use_native=False stay NumPy."""
    pos, idx = _soup(n, 11)
    lo, hi = tbuild.triangle_bounds(pos, idx)
    calls = []
    real = tnative.build_bvh_native
    monkeypatch.setattr(tnative, "build_bvh_native",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    a = tbuild.build_bvh(lo, hi)
    assert len(calls) == (n >= 4096) == (tbuild.NATIVE_MIN_ITEMS <= n)
    b = jbuild.build_bvh(lo, hi)
    for f in BVH_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    for kw in (dict(method="median"), dict(method="midpoint"), dict(use_native=False)):
        tbuild.build_bvh(lo, hi, **kw)
    assert len(calls) == (n >= 4096)


def test_wide_collapse_dispatches_at_the_jax_threshold(monkeypatch):
    """Trees of 4,096 binary nodes or more collapse natively, smaller ones
    and root-leaf trees in NumPy, as in the JAX package; the result is the
    same either way."""
    pos, idx = _soup(40000, 9)
    big = tbuild.build_bvh(*tbuild.triangle_bounds(pos, idx))
    small = tbuild.build_bvh(*tbuild.triangle_bounds(*_soup(3000, 3)))
    leaf = tbuild.build_bvh(*tbuild.triangle_bounds(*_soup(9, 3)))
    assert big.num_nodes >= 4096 > small.num_nodes and leaf.count[0] > 0
    calls = []
    real = tnative.collapse_wide_native
    monkeypatch.setattr(tnative, "collapse_wide_native",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for bvh, native in ((big, True), (small, False), (leaf, False)):
        del calls[:]
        w = tbuild.build_wide_bvh(bvh)
        assert len(calls) == native
        assert_wide_equal(w, jbuild.build_wide_bvh(bvh))
    del calls[:]
    tbuild.build_wide_bvh(big, use_native=False)
    tbuild.build_wide_bvh(big, k=5)
    assert not calls


def test_failed_build_raises_instead_of_falling_back(tmp_path, monkeypatch):
    """A source g++ refuses: build_bvh raises with the compiler's output
    (the JAX package would fall back to NumPy); use_native=False still
    builds."""
    bad = tmp_path / "bvh_builder.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_build, "HOST_SOURCES", {"bvh_builder": bad})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    pos, idx = _soup(5000, 1)
    lo, hi = tbuild.triangle_bounds(pos, idx)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed .*error"):
        tbuild.build_bvh(lo, hi)
    assert not list((tmp_path / "build").glob("*.so"))
    assert tbuild.build_bvh(lo, hi, use_native=False).num_nodes > 1


def test_failed_native_call_raises(monkeypatch):
    """A native call that reports failure raises (no NumPy fallback)."""

    class Lib:
        class Fn:
            restype = argtypes = None

            def __call__(self, *a):
                return 0

        tinsel_build_bvh = Fn()
        tinsel_collapse_wide = Fn()

    monkeypatch.setattr(_build, "_libs", {"bvh_builder": Lib()})
    pos, idx = _soup(5000, 1)
    lo, hi = tbuild.triangle_bounds(pos, idx)
    with pytest.raises(RuntimeError, match="native BVH build failed"):
        tbuild.build_bvh(lo, hi)
    tree = tbuild.build_bvh(*tbuild.triangle_bounds(*_soup(40000, 2)), use_native=False)
    with pytest.raises(RuntimeError, match="native wide collapse failed"):
        tbuild.build_wide_bvh(tree)


def test_library_builds_into_the_build_dir_keyed_by_source_and_flags():
    path = _build.library_path("bvh_builder")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libbvh_builder-")
    assert _build.flags("bvh_builder") == ("-O3", "-shared", "-fPIC", "-std=c++17")
    assert _build.source("bvh_builder").name == "bvh_builder.cpp"
    assert _build.source("bvh").name == "bvh.cu"
    _build.load("bvh_builder")
    assert path.exists()
