"""Host-side BVH builder: the port's own copy of
``tinsel_tpu/accel/build.py``.

``build_bvh`` builds a binary ranged-leaf tree by a full SAH sweep (or a
median / midpoint split); ``build_wide_bvh`` collapses it into the 16-ary
traversal layout the BVH-walk kernels read: one (72,) f32 row per internal
node, child boxes bf16-packed component-major, and 16-triangle leaf blocks
owned by their parent row. The reference builds every tree with NumPy
(the port hands big inputs to its native C++ builder, which builds the
same trees); ``use_native=True`` raises. The JAX package's fan-out /
block-size switches are not ported.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

DEFAULT_LEAF_SIZE = 16  # items per binary leaf: one leaf fills one block
NATIVE_MIN_ITEMS = 4096  # build_bvh: SAH builds from here on are native
NATIVE_MIN_NODES = 4096  # build_wide_bvh: collapses from here on are native
BLOCK_SIZE = 16  # triangles per leaf block
WIDE_K = 16  # node fan-out
_NAN_PACKED = np.uint32(0x7FC07FC0)  # bf16 quiet NaN in both halves


@dataclasses.dataclass
class BVH:
    """Flat SoA binary BVH with ranged leaves. Internal nodes store child
    node indices in (left, right); a leaf (count > 0) stores in ``left``
    the start of its item range in ``perm``. Root is node 0."""

    lower: np.ndarray  # (N, 3) f32
    upper: np.ndarray  # (N, 3) f32
    left: np.ndarray  # (N,) i32
    right: np.ndarray  # (N,) i32
    leaf: np.ndarray  # (N,) i32 (0/1)
    count: np.ndarray  # (N,) i32 items in the leaf range (0 = internal)
    perm: np.ndarray  # (n,) i32 item order referenced by leaves

    @property
    def num_nodes(self) -> int:
        return int(self.lower.shape[0])


def _surface_area(lower, upper):
    e = np.maximum(upper - lower, 0.0)
    return 2.0 * (e[..., 0] * e[..., 1] + e[..., 0] * e[..., 2] + e[..., 1] * e[..., 2])


def build_bvh(lowers: np.ndarray, uppers: np.ndarray,
              max_items_per_leaf: int = DEFAULT_LEAF_SIZE,
              method: str = "sah", use_native: bool = False) -> BVH:
    """BVH over item AABBs (n, 3). ``method``: "sah" (full sweep along the
    longest axis), "median" (split at the item median) or "midpoint"
    (split at the spatial midpoint, median when that degenerates). SAH
    over ``NATIVE_MIN_ITEMS`` or more items runs the native builder unless
    ``use_native=False``."""
    lowers = np.asarray(lowers, np.float32).reshape(-1, 3)
    uppers = np.asarray(uppers, np.float32).reshape(-1, 3)
    n = lowers.shape[0]
    if n == 0:
        raise ValueError("cannot build BVH over zero items")
    if method not in ("sah", "median", "midpoint"):
        raise ValueError(f"unknown BVH build method: {method}")
    if use_native:
        raise ValueError("the reference builds its trees with NumPy only")

    centers = 0.5 * (lowers + uppers)
    max_nodes = 2 * n
    out_lower = np.empty((max_nodes, 3), np.float32)
    out_upper = np.empty((max_nodes, 3), np.float32)
    out_left = np.zeros(max_nodes, np.int32)
    out_right = np.zeros(max_nodes, np.int32)
    out_leaf = np.zeros(max_nodes, np.int32)
    out_count = np.zeros(max_nodes, np.int32)
    indices = np.arange(n, dtype=np.int64)
    used = 1
    stack = [(0, 0, n)]  # (node, start, end); children allocated in pairs
    while stack:
        node, start, end = stack.pop()
        idx = indices[start:end]
        lo = lowers[idx].min(axis=0)
        hi = uppers[idx].max(axis=0)
        out_lower[node] = lo
        out_upper[node] = hi
        count = end - start
        if count <= max_items_per_leaf:
            out_leaf[node] = 1
            out_left[node] = start
            out_count[node] = count
            continue

        axis = int(np.argmax(hi - lo))
        order = np.argsort(centers[idx, axis], kind="stable")
        idx_sorted = idx[order]
        indices[start:end] = idx_sorted
        if method == "median":
            split = count // 2
        elif method == "midpoint":
            mid = 0.5 * (lo[axis] + hi[axis])
            split = int(np.searchsorted(centers[idx_sorted, axis], mid, side="left"))
            if split <= 0 or split >= count:
                split = count // 2
        else:
            slo = lowers[idx_sorted]
            shi = uppers[idx_sorted]
            left_area = _surface_area(
                np.minimum.accumulate(slo, axis=0), np.maximum.accumulate(shi, axis=0)
            )
            right_area = _surface_area(
                np.minimum.accumulate(slo[::-1], axis=0)[::-1],
                np.maximum.accumulate(shi[::-1], axis=0)[::-1],
            )
            counts = np.arange(count, dtype=np.float64)
            cost = left_area * counts + right_area * (count - counts)
            split = int(np.argmin(cost)) + 1
            if split <= 0 or split >= count:
                split = count // 2

        lchild, rchild = used, used + 1
        used += 2
        out_left[node] = lchild
        out_right[node] = rchild
        stack.append((lchild, start, start + split))
        stack.append((rchild, start + split, end))

    return BVH(
        lower=out_lower[:used].copy(),
        upper=out_upper[:used].copy(),
        left=out_left[:used].copy(),
        right=out_right[:used].copy(),
        leaf=out_leaf[:used].copy(),
        count=out_count[:used].copy(),
        perm=indices.astype(np.int32),
    )


def triangle_bounds(positions: np.ndarray, indices: np.ndarray):
    """AABBs per triangle. positions (V, 3), indices (T, 3)."""
    tris = positions[indices]
    return tris.min(axis=1), tris.max(axis=1)


def _node_layout(k: int):
    """(row_width, word_col, skip_col) of a k-ary node row: 3k packed box
    columns, k child words and one skip word, padded to a multiple of 8."""
    return ((4 * k + 1 + 7) // 8) * 8, 3 * k, 4 * k


NODE_ROW_WIDTH, NODE_WORD_COL, NODE_SKIP_COL = _node_layout(WIDE_K)


def _bf16_pack_bounds(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """One u32 per (lo, hi) pair: bf16(hi) rounded up in the high half,
    bf16(lo) rounded down in the low half, so the packed box contains the
    true one."""
    lo = np.asarray(lo, np.float32).ravel()
    hi = np.asarray(hi, np.float32).ravel()
    lot = lo.view(np.uint32) & np.uint32(0xFFFF0000)
    hit = hi.view(np.uint32) & np.uint32(0xFFFF0000)
    # truncation rounds toward zero: step one bf16 ulp outward where needed
    lot[lot.view(np.float32) > lo] += np.uint32(0x10000)
    hit[hit.view(np.float32) < hi] += np.uint32(0x10000)
    return hit | (lot >> np.uint32(16))


def _bf16_unpack_bounds(packed: np.ndarray):
    """Host-side decode of ``_bf16_pack_bounds``: (lo, hi)."""
    packed = np.asarray(packed, np.uint32)
    hi = (packed & np.uint32(0xFFFF0000)).view(np.float32)
    lo = (packed << np.uint32(16)).view(np.float32)
    return lo, hi


@dataclasses.dataclass(frozen=True)
class WideBVH:
    """k-ary collapsed tree in traversal row layout (mesh-local ids).

    node_rows: (Ni, 72) f32 at k = 16: cols [0, k) x, [k, 2k) y, [2k, 3k)
        z packed child boxes (empty slots bf16 NaN: they always miss);
        [3k, 4k) i32 child words (>= 0 internal child, < 0 leaf block
        ``~word``); col 4k i32 skip link.
    perm_padded: (16 * n_blocks,) indices into the mesh's triangles; block
        b owns rows [16b, 16b + 16), padded with its last real triangle.
    real_mask: (16 * n_blocks,) bool, False on padding slots.
    root_lower / root_upper: (3,) f32 mesh root AABB.
    """

    node_rows: np.ndarray
    perm_padded: np.ndarray
    real_mask: np.ndarray
    root_lower: np.ndarray
    root_upper: np.ndarray
    k: int = WIDE_K

    @property
    def num_nodes(self) -> int:
        return int(self.node_rows.shape[0])

    @property
    def num_blocks(self) -> int:
        return len(self.perm_padded) // BLOCK_SIZE


def _nan_box():
    return np.full(3, _NAN_PACKED, np.uint32).view(np.float32)


def build_wide_bvh(bvh: BVH, k: int = WIDE_K, use_native: bool = False) -> WideBVH:
    """Collapse a binary ranged-leaf BVH into the k-ary traversal layout.
    Each internal node adopts the frontier of its binary descendants,
    expanding the largest-volume internal child first, until k entries;
    leaves become padded 16-triangle blocks owned by their parent row.
    Trees of ``NATIVE_MIN_NODES`` or more nodes take the native collapse
    (bit-identical) unless ``use_native=False``."""
    if use_native:
        raise ValueError("the reference builds its trees with NumPy only")
    row_w, word_col, skip_col = _node_layout(k)
    count, left, right = bvh.count, bvh.left, bvh.right
    lower, upper = bvh.lower, bvh.upper

    def expand(i):
        front = [int(left[i]), int(right[i])]
        while len(front) < k:
            pick, best = None, -1.0
            for j, c in enumerate(front):
                if count[c] == 0:
                    span = float(np.prod(np.maximum(upper[c] - lower[c], 0)))
                    if span > best:
                        best, pick = span, j
            if pick is None:
                break
            c = front.pop(pick)
            front[pick:pick] = [int(left[c]), int(right[c])]
        return front

    if count[0] > 0:  # the whole mesh is one leaf: a one-row root
        n_real = int(count[0])
        perm_padded = np.concatenate(
            [bvh.perm[:n_real], np.repeat(bvh.perm[n_real - 1], BLOCK_SIZE - n_real)]
        ).astype(np.int64)
        real_mask = np.zeros(BLOCK_SIZE, bool)
        real_mask[:n_real] = True
        row = np.zeros((1, row_w), np.float32)
        row[0, [0, k, 2 * k]] = _bf16_pack_bounds(lower[0], upper[0]).view(np.float32)
        for c in range(1, k):
            row[0, [c, k + c, 2 * k + c]] = _nan_box()
        words = np.zeros(k, np.int32)
        words[0] = ~np.int32(0)
        row[0, word_col:word_col + k] = words.view(np.float32)
        row[0, skip_col] = np.int32(-1).view(np.float32)
        return WideBVH(row, perm_padded, real_mask, lower[0].copy(), upper[0].copy(), k)

    # pass 1: internal ids in preorder, leaf block ids in DFS child order
    children: dict = {}
    internal_id: dict = {}
    block_id: dict = {}
    stack = [0]
    while stack:
        b = stack.pop()
        internal_id[b] = len(internal_id)
        ch = expand(b)
        children[b] = ch
        for c in reversed(ch):
            if count[c] == 0:
                stack.append(c)

    def walk_blocks(b):
        for c in children[b]:
            if count[c] > 0:
                block_id[c] = len(block_id)
            else:
                walk_blocks(c)

    old_lim = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_lim, 4 * bvh.num_nodes + 1000))
    try:
        walk_blocks(0)
    finally:
        sys.setrecursionlimit(old_lim)

    # pass 2: skip links thread internal siblings
    skip = {0: -1}
    stack = [0]
    while stack:
        b = stack.pop()
        internal_children = [c for c in children[b] if count[c] == 0]
        for j, c in enumerate(internal_children):
            skip[c] = (
                internal_children[j + 1] if j + 1 < len(internal_children) else skip[b]
            )
        stack.extend(internal_children)

    # pass 3: rows and the padded permutation
    rows = np.zeros((len(internal_id), row_w), np.float32)
    n_blocks = len(block_id)
    perm_padded = np.zeros(BLOCK_SIZE * n_blocks, np.int64)
    real_mask = np.zeros(BLOCK_SIZE * n_blocks, bool)
    for b, nid in internal_id.items():
        ch = children[b]
        words = np.zeros(k, np.int32)
        for c_idx in range(k):
            o = [c_idx, k + c_idx, 2 * k + c_idx]
            if c_idx >= len(ch):
                rows[nid, o] = _nan_box()
                continue
            c = ch[c_idx]
            rows[nid, o] = _bf16_pack_bounds(lower[c], upper[c]).view(np.float32)
            if count[c] > 0:
                blk = block_id[c]
                words[c_idx] = ~np.int32(blk)
                start = BLOCK_SIZE * blk
                n_real = int(count[c])
                src = bvh.perm[left[c]:left[c] + n_real]
                perm_padded[start:start + n_real] = src
                perm_padded[start + n_real:start + BLOCK_SIZE] = src[-1]
                real_mask[start:start + n_real] = True
            else:
                words[c_idx] = np.int32(internal_id[c])
        rows[nid, word_col:word_col + k] = words.view(np.float32)
        esc = skip[b]
        rows[nid, skip_col] = np.int32(-1 if esc == -1 else internal_id[esc]).view(np.float32)

    return WideBVH(rows, perm_padded, real_mask, lower[0].copy(), upper[0].copy(), k)


def wide_stack_bound(wide: WideBVH) -> int:
    """Worst-case stack depth of the compressed-stack walk: the largest
    number, over root-to-leaf paths, of ancestors with at least two
    internal children (each holds at most one live entry)."""
    _, word_col, _ = _node_layout(wide.k)
    words = wide.node_rows[:, word_col:word_col + wide.k].view(np.int32)
    best = 0
    stack = [(0, 0)]
    while stack:
        node, p = stack.pop()
        internals = [int(w) for w in words[node] if w >= 1]
        mine = 1 if len(internals) >= 2 else 0
        best = max(best, p + mine)
        for ch in internals:
            stack.append((ch, p + mine))
    return max(best, 1)
