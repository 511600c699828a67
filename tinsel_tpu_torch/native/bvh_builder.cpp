// Native SAH AABB-tree builder (host C++, not a kernel).
//
// Scene-load-time builder behind tinsel_tpu_torch/accel/build.py, a copy of
// tinsel_tpu/native/bvh_builder.cpp kept identical so both packages build
// the same trees bit for bit. Algorithm: full-sweep surface-area heuristic
// along the longest axis, middle-split fallback, ranged leaves of up to
// `leaf_size` items (contiguous in the output permutation), flat SoA output
// with the root at node 0. Exposed through a plain C ABI and loaded via
// ctypes (see bvh_native.py).
//
// Build (ops/_build.py, at first use):
//   g++ -O3 -shared -fPIC -std=c++17 -o libbvh_builder-<hash>.so bvh_builder.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
    float x, y, z;
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

inline double area(const Vec3& lo, const Vec3& hi) {
    double ex = std::max(0.0f, hi.x - lo.x);
    double ey = std::max(0.0f, hi.y - lo.y);
    double ez = std::max(0.0f, hi.z - lo.z);
    return 2.0 * (ex * ey + ex * ez + ey * ez);
}

struct Builder {
    const Vec3* lowers;
    const Vec3* uppers;
    std::vector<Vec3> centers;
    std::vector<int64_t> indices;

    float* out_lower;
    float* out_upper;
    int32_t* out_left;
    int32_t* out_right;
    int32_t* out_leaf;
    int32_t* out_count;
    int32_t leaf_size = 1;
    int32_t used = 0;

    // reusable sweep scratch
    std::vector<double> left_area, right_area;

    int32_t alloc() { return used++; }

    void build(int32_t node, int64_t start, int64_t end) {
        // compute node bounds
        Vec3 lo = lowers[indices[start]];
        Vec3 hi = uppers[indices[start]];
        for (int64_t i = start + 1; i < end; ++i) {
            lo = vmin(lo, lowers[indices[i]]);
            hi = vmax(hi, uppers[indices[i]]);
        }
        out_lower[node * 3 + 0] = lo.x;
        out_lower[node * 3 + 1] = lo.y;
        out_lower[node * 3 + 2] = lo.z;
        out_upper[node * 3 + 0] = hi.x;
        out_upper[node * 3 + 1] = hi.y;
        out_upper[node * 3 + 2] = hi.z;

        int64_t n = end - start;
        if (n <= leaf_size) {
            out_leaf[node] = 1;
            out_left[node] = (int32_t)start;  // range start in final perm
            out_right[node] = 0;
            out_count[node] = (int32_t)n;
            return;
        }

        // longest axis
        float ex = hi.x - lo.x, ey = hi.y - lo.y, ez = hi.z - lo.z;
        int axis = (ex > ey && ex > ez) ? 0 : (ey > ez ? 1 : 2);

        const Vec3* cs = centers.data();
        std::stable_sort(indices.begin() + start, indices.begin() + end,
                         [cs, axis](int64_t a, int64_t b) {
                             const float* ca = &cs[a].x;
                             const float* cb = &cs[b].x;
                             return ca[axis] < cb[axis];
                         });

        // prefix / suffix area sweeps
        left_area.resize(n);
        right_area.resize(n);
        Vec3 l_lo = lowers[indices[start]], l_hi = uppers[indices[start]];
        for (int64_t i = 0; i < n; ++i) {
            l_lo = vmin(l_lo, lowers[indices[start + i]]);
            l_hi = vmax(l_hi, uppers[indices[start + i]]);
            left_area[i] = area(l_lo, l_hi);
        }
        Vec3 r_lo = lowers[indices[end - 1]], r_hi = uppers[indices[end - 1]];
        for (int64_t i = n - 1; i >= 0; --i) {
            r_lo = vmin(r_lo, lowers[indices[start + i]]);
            r_hi = vmax(r_hi, uppers[indices[start + i]]);
            right_area[i] = area(r_lo, r_hi);
        }

        // minimize left_area[i] * i + right_area[i] * (n - i)
        int64_t best = 0;
        double best_cost = 1e300;
        for (int64_t i = 0; i < n; ++i) {
            double cost = left_area[i] * (double)i + right_area[i] * (double)(n - i);
            if (cost < best_cost) {
                best_cost = cost;
                best = i;
            }
        }
        int64_t split = best + 1;
        if (split <= 0 || split >= n) split = n / 2;

        int32_t lchild = alloc();
        int32_t rchild = alloc();
        out_leaf[node] = 0;
        out_left[node] = lchild;
        out_right[node] = rchild;
        out_count[node] = 0;
        // recurse (depth is O(log n) in practice; SAH trees are balanced
        // enough that native stack depth is not a concern at 10M items)
        build(lchild, start, start + split);
        build(rchild, start + split, end);
    }
};

}  // namespace

extern "C" {

// Returns the number of nodes written (<= 2*n). Output arrays must have
// capacity 2*n.
int32_t tinsel_build_bvh(const float* lowers, const float* uppers, int64_t n,
                         int32_t leaf_size, float* out_lower, float* out_upper,
                         int32_t* out_left, int32_t* out_right,
                         int32_t* out_leaf, int32_t* out_count,
                         int32_t* out_perm) {
    if (n <= 0) return 0;
    Builder b;
    b.leaf_size = leaf_size < 1 ? 1 : leaf_size;
    b.out_count = out_count;
    b.lowers = reinterpret_cast<const Vec3*>(lowers);
    b.uppers = reinterpret_cast<const Vec3*>(uppers);
    b.centers.resize(n);
    for (int64_t i = 0; i < n; ++i) {
        b.centers[i] = {0.5f * (b.lowers[i].x + b.uppers[i].x),
                        0.5f * (b.lowers[i].y + b.uppers[i].y),
                        0.5f * (b.lowers[i].z + b.uppers[i].z)};
    }
    b.indices.resize(n);
    for (int64_t i = 0; i < n; ++i) b.indices[i] = i;
    b.out_lower = out_lower;
    b.out_upper = out_upper;
    b.out_left = out_left;
    b.out_right = out_right;
    b.out_leaf = out_leaf;
    int32_t root = b.alloc();
    b.build(root, 0, n);
    for (int64_t i = 0; i < n; ++i) out_perm[i] = (int32_t)b.indices[i];
    return b.used;
}

// ---------------------------------------------------------------- wide (4-ary)
//
// Native path of accel/build.py::build_wide_bvh — collapses the binary
// ranged-leaf tree into the k-ary traversal row layout (bf16-packed child
// boxes, padded leaf blocks). Must match the NumPy implementation
// EXACTLY (same frontier-expansion pick, DFS id/block order, skip wiring,
// bf16 rounding); tests assert bit-equality.

// bf16(hi) rounded up in the high half, bf16(lo) rounded down in the low
// half (see accel/build.py::_bf16_pack_bounds).
static uint32_t pack_axis(float lo, float hi) {
    uint32_t lb, hb;
    std::memcpy(&lb, &lo, 4);
    std::memcpy(&hb, &hi, 4);
    uint32_t lt = lb & 0xFFFF0000u;
    uint32_t ht = hb & 0xFFFF0000u;
    float ltf, htf;
    std::memcpy(&ltf, &lt, 4);
    std::memcpy(&htf, &ht, 4);
    if (ltf > lo) lt += 0x10000u;  // only possible when lo < 0
    if (htf < hi) ht += 0x10000u;  // only possible when hi > 0
    return ht | (lt >> 16);
}

// Returns the number of internal wide nodes written, or -1 on error.
// out_counts[0] = n_internal, out_counts[1] = n_blocks.
// Capacities: out_rows n_nodes*24 floats; out_perm/out_mask
// n_nodes*block_size entries (leaves <= binary nodes).
int64_t tinsel_collapse_wide(
    const float* lower, const float* upper,  // (N, 3)
    const int32_t* left, const int32_t* right, const int32_t* count,
    const int32_t* perm, int64_t n_nodes, int32_t k, int32_t block_size,
    float* out_rows, int64_t* out_perm, uint8_t* out_mask,
    int64_t* out_counts) {
    // k-ary node layout (matches accel/build.py::_node_layout)
    const int word_col = 3 * k, skip_col = 4 * k;
    const int row_w = ((4 * k + 1 + 7) / 8) * 8;
    if (n_nodes <= 0 || count[0] > 0) return -1;  // root-leaf: python path

    auto volume = [&](int32_t c) {
        double ex = upper[3 * c + 0] - lower[3 * c + 0];
        double ey = upper[3 * c + 1] - lower[3 * c + 1];
        double ez = upper[3 * c + 2] - lower[3 * c + 2];
        ex = ex > 0 ? ex : 0; ey = ey > 0 ? ey : 0; ez = ez > 0 ? ez : 0;
        return ex * ey * ez;
    };

    // pass 1: preorder ids + children frontiers (matches python stack pops)
    std::vector<int32_t> internal_id(n_nodes, -1);
    std::vector<int32_t> order;            // binary ids in id order
    std::vector<std::vector<int32_t>> kids;
    std::vector<int32_t> stack = {0};
    while (!stack.empty()) {
        int32_t b = stack.back();
        stack.pop_back();
        internal_id[b] = (int32_t)order.size();
        order.push_back(b);
        std::vector<int32_t> front = {left[b], right[b]};
        while ((int32_t)front.size() < k) {
            int pick = -1;
            double best = -1.0;
            for (size_t j = 0; j < front.size(); ++j) {
                if (count[front[j]] == 0) {
                    double v = volume(front[j]) + 1e-30;
                    if (v > best) { best = v; pick = (int)j; }
                }
            }
            if (pick < 0) break;
            int32_t c = front[pick];
            front.erase(front.begin() + pick);
            front.insert(front.begin() + pick, right[c]);
            front.insert(front.begin() + pick, left[c]);
        }
        kids.push_back(front);
        for (auto it = front.rbegin(); it != front.rend(); ++it)
            if (count[*it] == 0) stack.push_back(*it);
    }
    int64_t n_int = (int64_t)order.size();

    // forward-DFS block ids
    std::vector<int32_t> block_id(n_nodes, -1);
    int64_t n_blocks = 0;
    {
        std::vector<std::pair<int32_t, size_t>> st = {{0, 0}};
        while (!st.empty()) {
            auto& top = st.back();
            const auto& ch = kids[internal_id[top.first]];
            if (top.second == ch.size()) { st.pop_back(); continue; }
            int32_t c = ch[top.second++];
            if (count[c] > 0) block_id[c] = (int32_t)n_blocks++;
            else st.push_back({c, 0});
        }
    }

    // skip links over internal nodes
    std::vector<int32_t> skip(n_nodes, -1);
    stack = {0};
    while (!stack.empty()) {
        int32_t b = stack.back();
        stack.pop_back();
        int32_t esc = skip[b];
        const auto& ch = kids[internal_id[b]];
        std::vector<int32_t> internals;
        for (int32_t c : ch)
            if (count[c] == 0) internals.push_back(c);
        for (size_t j = 0; j < internals.size(); ++j)
            skip[internals[j]] =
                j + 1 < internals.size() ? internals[j + 1] : esc;
        for (int32_t c : internals) stack.push_back(c);
    }

    // emit rows + padded permutation
    const uint32_t NANP = 0x7FC07FC0u;
    for (int64_t oi = 0; oi < n_int; ++oi) {
        int32_t b = order[oi];
        float* row = out_rows + oi * row_w;
        std::memset(row, 0, row_w * sizeof(float));
        const auto& ch = kids[oi];
        int32_t words[16] = {0};
        for (int32_t ci = 0; ci < k; ++ci) {
            if (ci < (int32_t)ch.size()) {
                int32_t c = ch[ci];
                // component-major box columns: x cols [0,k), y [k,2k),
                // z [2k,3k) (matches accel/build.py emit)
                for (int a = 0; a < 3; ++a) {
                    uint32_t p = pack_axis(lower[3 * c + a], upper[3 * c + a]);
                    std::memcpy(row + a * k + ci, &p, 4);
                }
                if (count[c] > 0) {
                    int32_t blk = block_id[c];
                    words[ci] = ~blk;
                    int64_t s0 = (int64_t)block_size * blk;
                    int32_t n_real = count[c];
                    for (int32_t t = 0; t < n_real; ++t) {
                        out_perm[s0 + t] = perm[left[c] + t];
                        out_mask[s0 + t] = 1;
                    }
                    for (int32_t t = n_real; t < block_size; ++t) {
                        out_perm[s0 + t] = perm[left[c] + n_real - 1];
                        out_mask[s0 + t] = 0;
                    }
                } else {
                    words[ci] = internal_id[c];
                }
            } else {
                for (int a = 0; a < 3; ++a)
                    std::memcpy(row + a * k + ci, &NANP, 4);
            }
        }
        std::memcpy(row + word_col, words, k * sizeof(int32_t));
        int32_t esc = skip[b];
        int32_t esc_id = esc == -1 ? -1 : internal_id[esc];
        std::memcpy(row + skip_col, &esc_id, sizeof(int32_t));
    }
    out_counts[0] = n_int;
    out_counts[1] = n_blocks;
    return n_int;
}

}
