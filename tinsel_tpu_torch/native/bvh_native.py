"""ctypes bridge to the native SAH BVH builder (``bvh_builder.cpp``): the
port's copy of ``tinsel_tpu/native/bvh_native.py``.

The library is built by ``ops/_build.py`` (g++) at first use into
``_build/``. ``build_bvh_native`` has the output contract of
``accel/build.py::build_bvh`` and ``collapse_wide_native`` that of
``build_wide_bvh``; both equal the JAX package's native builder bit for
bit. A failed build or a failed call raises: nothing falls back to NumPy.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..ops import _build

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _lib() -> ctypes.CDLL:
    lib = _build.load("bvh_builder")
    lib.tinsel_build_bvh.restype = ctypes.c_int32
    lib.tinsel_build_bvh.argtypes = [
        _F32P, _F32P, ctypes.c_int64, ctypes.c_int32,
        _F32P, _F32P, _I32P, _I32P, _I32P, _I32P, _I32P,
    ]
    lib.tinsel_collapse_wide.restype = ctypes.c_int64
    lib.tinsel_collapse_wide.argtypes = [
        _F32P, _F32P, _I32P, _I32P, _I32P, _I32P,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        _F32P, _I64P, _U8P, _I64P,
    ]
    return lib


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def build_bvh_native(lowers: np.ndarray, uppers: np.ndarray, leaf_size: int = 8):
    """SAH binary BVH over item AABBs (n, 3), ranged leaves of at most
    ``leaf_size`` items."""
    from ..accel.build import BVH

    lib = _lib()
    lowers = np.ascontiguousarray(lowers, np.float32)
    uppers = np.ascontiguousarray(uppers, np.float32)
    n = lowers.shape[0]
    cap = 2 * n
    out_lower = np.empty((cap, 3), np.float32)
    out_upper = np.empty((cap, 3), np.float32)
    ints = [np.empty(cap, np.int32) for _ in range(4)]  # left, right, leaf, count
    out_perm = np.empty(n, np.int32)
    used = lib.tinsel_build_bvh(
        _ptr(lowers, _F32P), _ptr(uppers, _F32P), ctypes.c_int64(n),
        ctypes.c_int32(leaf_size), _ptr(out_lower, _F32P), _ptr(out_upper, _F32P),
        *(_ptr(a, _I32P) for a in ints), _ptr(out_perm, _I32P),
    )
    if used <= 0:
        raise RuntimeError(f"native BVH build failed on {n} items (returned {used})")
    left, right, leaf, count = (a[:used].copy() for a in ints)
    return BVH(lower=out_lower[:used].copy(), upper=out_upper[:used].copy(),
               left=left, right=right, leaf=leaf, count=count, perm=out_perm)


def collapse_wide_native(bvh, k: int = 16, block_size: int = 16):
    """The k-ary traversal layout of a binary BVH whose root is internal
    (k in 4, 8, 16), bit-identical to the NumPy collapse."""
    from ..accel.build import WideBVH, _node_layout

    if k not in (4, 8, 16):
        raise ValueError(f"native collapse: unsupported k={k}")
    row_w, _, _ = _node_layout(k)
    lib = _lib()
    n = bvh.num_nodes
    lower = np.ascontiguousarray(bvh.lower, np.float32)
    upper = np.ascontiguousarray(bvh.upper, np.float32)
    left, right, count, perm = (np.ascontiguousarray(a, np.int32)
                                for a in (bvh.left, bvh.right, bvh.count, bvh.perm))
    out_rows = np.zeros((n, row_w), np.float32)
    out_perm = np.zeros(n * block_size, np.int64)
    out_mask = np.zeros(n * block_size, np.uint8)
    out_counts = np.zeros(2, np.int64)
    rc = lib.tinsel_collapse_wide(
        _ptr(lower, _F32P), _ptr(upper, _F32P), _ptr(left, _I32P), _ptr(right, _I32P),
        _ptr(count, _I32P), _ptr(perm, _I32P), ctypes.c_int64(n), ctypes.c_int32(k),
        ctypes.c_int32(block_size), _ptr(out_rows, _F32P), _ptr(out_perm, _I64P),
        _ptr(out_mask, _U8P), _ptr(out_counts, _I64P),
    )
    if rc <= 0:
        raise RuntimeError(f"native wide collapse failed on {n} nodes (returned {rc})")
    n_int, n_blocks = int(out_counts[0]), int(out_counts[1])
    return WideBVH(
        node_rows=out_rows[:n_int].copy(),
        perm_padded=out_perm[: n_blocks * block_size].copy(),
        real_mask=out_mask[: n_blocks * block_size].astype(bool),
        root_lower=lower[0].copy(),
        root_upper=upper[0].copy(),
        k=k,
    )
