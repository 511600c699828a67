// Wide-BVH walks for Hopper (sm_90a): kernels K3 (closest hit), K4 (any
// hit with t < tmax), K7 (the closest-hit walk's step count), and K6c /
// K6a (the instance shortlist rounds, closest hit and occlusion, which
// walk with the same code; their note is above bvh_rounds_closest_kernel).
//
// Replaces: tinsel_tpu/accel/traverse.py:761 intersect_mesh (its walk
// _run_tiled :635 / _traverse_tile :491 / _step :390), :903
// intersect_mesh_any (_traverse_tile_any :811), :963 traversal_cost
// (_run_tiled with with_steps=True), and tinsel_tpu/render/trace.py:267
// _instance_rounds / :330 _instance_rounds_any with the inputs built for
// them (:216 _instance_box_entry, the local rays of :434-436). In the JAX
// package these are pure JAX lockstep loops over tiles of rays (the
// rounds a jax.lax.while_loop around them).
//
// Layout (accel/build.py, built on the host):
//   node row (72 floats, 288 B): cols [0,16) x, [16,32) y, [32,48) z child
//     boxes, one u32 per child and axis with bf16(upper) in the high half
//     and bf16(lower) in the low half, both rounded outward; empty slots
//     are bf16 NaN and always miss; cols [48,64) i32 child words: >= 0 an
//     internal child, < 0 the leaf block ~word.
//   block row (192 floats, 768 B): 16 x v0x, 16 x v0y, 16 x v0z, 16 x v1x,
//     ..., 16 x v2z, 48 pad.
//
// The walk (the plain version is accel/traverse.py::_walk): at a node the
// ray tests, in slot order, each hit leaf child's 16 triangles under its
// current best t (strict <, first slot on a tie); then it descends into
// the first hit internal child at slot >= ic, pushing one compressed
// entry (cur << 4 | next hit internal slot) if there is one; with none it
// pops, re-tests that node's children under the tightened best t and
// resumes at the stored slot. MeshHandle.stack_slots bounds the stack.
//
// What bounds it on this card: a walk is a chain of dependent loads (node
// row -> leaf block -> next node row) of a few hundred bytes each, so it
// is bounded by the latency of each step and by how many walks are in
// flight, far below the card's byte and operation rates. With one thread
// per ray a walk issues about 32 small dependent loads per node and 16
// serial triangle tests per leaf block. Measured on
// the H100: with fewer blocks per SM the walk slows in proportion, so
// latency bounds it; each step's latency is the row's round trip plus the
// dependent slab or triangle arithmetic and the group's ballots.
//
// The design: a half-warp (16 lanes) per ray, one lane per child slot and
// per triangle slot, so that every row arrives in one round trip.
//   * Node step: lane c holds child c's x, y, z box words and its child
//     word: four coalesced 64-byte runs of the row, issued together (a
//     288-byte row starts on a 32-byte sector when the table's base does,
//     as torch's allocations do, so each run is two sectors). With a
//     scalar node offset the root row comes in the same round trip as
//     the ray. Lane c computes its slab tn, tf once; one OR-reduction over
//     the group gives the leaf candidates (bits 0-15) and the internal
//     ones at slot >= ic (bits 16-31) under the current best t.
//   * Leaf children in slot order: the lowest candidate slot c is tested
//     next. Its block is tested by the 16 lanes at once, lane j on
//     triangle j (nine coalesced 64-byte runs); every lane reads c's word
//     from the row again (in L1 by then) rather than shuffling it. Without
//     a hit the candidates stand; after a hit both masks are taken again
//     under the tightened best t, the leaves from slot c + 1 on.
//   * The block's combine: the smallest t over the lanes with a hit and
//     t < best_t (one shuffle for a single hit, else a 4-step shuffle
//     min), then the lowest such lane with that t (a ballot). That is the
//     sequential loop's winner (strict <, first slot on a tie) and
//     _block_test's tt.min(dim=1), in any order of the 16 tests. Blocks
//     stay in slot order: whether a block is tested at all depends on the
//     best t the blocks before it left. K4 ends the walk when any lane has
//     a hit with t < tmax.
//   * Internal children: the first and second hit slots >= ic under the
//     best t after the leaves. Push, descend and pop as the sequential
//     walk does, with its overflow behaviour when slots is smaller than a
//     walk needs (a push past the stack is dropped, a pop past it ends the
//     walk).
//   * The stack lives in shared memory, `slots` 4-byte entries per ray:
//     lane 0 of the group pushes and pops, the group reads the entry back
//     by a shuffle. No local-memory frame.
//   * Culled rays: tn >= 0 or NaN, so with tmax <= 0 or NaN no child
//     passes tn < best_t and the result is (+inf, -1) / false. Such a ray
//     writes it without loading its ray, offsets or any row.
//   * One loop iteration is one node (its leaf blocks, then descend or
//     pop), so the two half-warps of a warp, which walk different rays,
//     run one instruction stream and diverge only in their numbers of
//     leaf blocks and nodes.
//   * Rows are addressed by 32-bit float offsets from the tables' bases
//     (ops/bvh.py refuses tables of 2^32 floats or more), which keeps the
//     walk at 48 registers: ten 128-thread blocks per SM.
//   * K7 walks as K3 does, from best t = +inf (it takes no tmax: the
//     complexity view always walks unbounded rays), and counts one step
//     per loop iteration (a node arrival: root, descent or pop) and one
//     per leaf block tested. That is the plain walk's count of iterations
//     in which the lane is unfinished (accel/traverse.py::traversal_cost):
//     there a node with b leaf blocks takes b dwell steps and one advance,
//     and a lane never ends with a block still pending.
// The launch geometry (threads, rays per block, shared bytes, grid) comes
// from ops/bvh.py::launch_geometry; the entry points check it.
//
// Rounding: this file is compiled with -fmad=false, so every product and
// sum rounds on its own, in the plain version's order, and t and the
// winning triangle equal the plain version's bit for bit. Division is
// IEEE (no fast math). min/max propagate NaN as torch.minimum does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "frame.cuh"  // nmin / nmax, rcp_nudged, an instance's frame and its root-box test

namespace {

constexpr int K = 16;          // node fan-out
constexpr int ROW = 72;        // floats per node row
constexpr int BS = 16;         // triangles per leaf block
constexpr int BROW = 12 * BS;  // floats per block row
constexpr int SLOT_BITS = 4;
constexpr int MAX_STACK = 128;
constexpr int GROUP = 16;                    // lanes per ray
constexpr int THREADS = 128;                 // threads per block
constexpr int RAYS = THREADS / GROUP;        // rays per block
static_assert(K == GROUP && BS == GROUP, "one lane per child and per triangle");
static_assert((ROW * 4) % 32 == 0, "node rows start on 32-byte sectors");

struct Ray {
  float ox, oy, oz, dx, dy, dz, rx, ry, rz;
};

// The 16 lanes of one ray inside their warp.
struct Group {
  int lane;       // 0..15: child slot and triangle slot
  int shift;      // 0 or 16: the group's first lane in the warp
  __device__ explicit Group(int tid) : lane(tid & (GROUP - 1)), shift(tid & GROUP) {}
  __device__ __forceinline__ unsigned mask() const { return 0xFFFFu << shift; }
  __device__ __forceinline__ unsigned ballot(bool p) const {
    return (__ballot_sync(mask(), p) >> shift) & 0xFFFFu;
  }
  template <typename T>
  __device__ __forceinline__ T shfl(T v, int src) const {
    return __shfl_sync(mask(), v, src, GROUP);
  }
};

// slab test of one child box: returns tn <= tf, and tn
__device__ __forceinline__ bool slab(uint32_t bx, uint32_t by, uint32_t bz, const Ray& r,
                                     float& tn) {
  const float t0x = (__uint_as_float(bx << 16) - r.ox) * r.rx;
  const float t1x = (__uint_as_float(bx & 0xFFFF0000u) - r.ox) * r.rx;
  const float t0y = (__uint_as_float(by << 16) - r.oy) * r.ry;
  const float t1y = (__uint_as_float(by & 0xFFFF0000u) - r.oy) * r.ry;
  const float t0z = (__uint_as_float(bz << 16) - r.oz) * r.rz;
  const float t1z = (__uint_as_float(bz & 0xFFFF0000u) - r.oz) * r.rz;
  tn = nmax(nmax(nmin(t0x, t1x), nmin(t0y, t1y)), nmax(nmin(t0z, t1z), 0.0f));
  const float tf = nmin(nmin(nmax(t0x, t1x), nmax(t0y, t1y)), nmax(t0z, t1z));
  return tn <= tf;
}

// two-sided Moller-Trumbore (accel/traverse.py::_tri_hit), eps 1e-9, on
// the lane's triangle of a block (b: the block row plus the lane)
__device__ __forceinline__ bool tri_hit(const float* b, const Ray& r, float& t) {
  const float v0x = __ldg(b), v0y = __ldg(b + BS), v0z = __ldg(b + 2 * BS);
  const float v1x = __ldg(b + 3 * BS), v1y = __ldg(b + 4 * BS), v1z = __ldg(b + 5 * BS);
  const float v2x = __ldg(b + 6 * BS), v2y = __ldg(b + 7 * BS), v2z = __ldg(b + 8 * BS);
  const float abx = v1x - v0x, aby = v1y - v0y, abz = v1z - v0z;
  const float acx = v2x - v0x, acy = v2y - v0y, acz = v2z - v0z;
  const float px = r.dy * acz - r.dz * acy;
  const float py = r.dz * acx - r.dx * acz;
  const float pz = r.dx * acy - r.dy * acx;
  const float det = abx * px + aby * py + abz * pz;
  const bool ok = fabsf(det) >= 1e-9f;
  const float inv = 1.0f / (ok ? det : 1.0f);
  const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  const float u = (tx * px + ty * py + tz * pz) * inv;
  const float qx = ty * abz - tz * aby;
  const float qy = tz * abx - tx * abz;
  const float qz = tx * aby - ty * abx;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
  t = (acx * qx + acy * qy + acz * qz) * inv;
  return ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f;
}

// the ray whose origin and direction start at o and d
__device__ __forceinline__ Ray load_ray_at(const float* o, const float* d) {
  Ray r;
  r.ox = __ldg(o); r.oy = __ldg(o + 1); r.oz = __ldg(o + 2);
  r.dx = __ldg(d); r.dy = __ldg(d + 1); r.dz = __ldg(d + 2);
  r.rx = rcp_nudged(r.dx); r.ry = rcp_nudged(r.dy); r.rz = rcp_nudged(r.dz);
  return r;
}

__device__ __forceinline__ Ray load_ray(const float* o, const float* d, int i) {
  return load_ray_at(o + 3 * i, d + 3 * i);
}

// The lane's slot of a node row: its child's x, y, z box words and its
// child word
struct Slot {
  uint32_t x, y, z;
  int w;
};

__device__ __forceinline__ Slot load_slot(const float* row, int lane) {
  return Slot{__float_as_uint(__ldg(row + lane)), __float_as_uint(__ldg(row + K + lane)),
              __float_as_uint(__ldg(row + 2 * K + lane)),
              __float_as_int(__ldg(row + 3 * K + lane))};
}

// The walk of one ray by its group, shared by the three kernels, from the
// root row's slots s. ANY: stop at the first block with a triangle hit at
// t < tmax. STEPS: count node arrivals and block tests into steps.
// Returns the closest hit's tri_local (best_t its t), or -1; for ANY,
// >= 0 if a hit was found. Every branch is uniform across the group.
// nbase / bbase: float offsets of the mesh's first node row and leaf block.
template <bool ANY, bool STEPS>
__device__ __forceinline__ int walk(const float* __restrict__ node_rows,
                                    const float* __restrict__ block_rows, unsigned nbase,
                                    unsigned bbase, const Ray& r, int slots, int* stack,
                                    const Group& g, Slot s, float& best_t, int& steps) {
  int best_tri = -1;
  int sp = 0, cur = 0, ic = 0;
  bool leaves = true;  // false after a pop: the node's leaves were tested
  while (true) {
    if (STEPS) ++steps;
    const float* row = node_rows + (nbase + (unsigned)cur * ROW);
    float tn;
    const bool box = slab(s.x, s.y, s.z, r, tn);
    const bool near = box && tn < best_t;
    // leaf candidates in bits 0-15, internal ones (slot >= ic) in 16-31
    const unsigned both = __reduce_or_sync(
        g.mask(), (near && s.w < 0 && leaves ? 1u : 0u) << g.lane |
                    (near && s.w >= 0 && g.lane >= ic ? 1u : 0u) << (GROUP + g.lane));
    unsigned im = both >> GROUP;
    // leaf children in slot order, each under the best t of the blocks
    // tested before it; a chosen slot's word is read again from the row
    // (in L1 by now) by every lane rather than shuffled
    for (unsigned m = both & 0xFFFFu; m != 0;) {
      const int c = __ffs(m) - 1;
      m &= m - 1;
      const int blk = ~__float_as_int(__ldg(row + 3 * K + c));
      if (STEPS) ++steps;
      float t;
      const bool hit =
          tri_hit(block_rows + (bbase + (unsigned)blk * BROW + g.lane), r, t) && t < best_t;
      const unsigned hits = g.ballot(hit);
      if (hits == 0) continue;
      int slot = __ffs(hits) - 1;
      if (ANY) return blk * BS + slot;
      float tmin;
      if ((hits & (hits - 1)) == 0) {
        tmin = g.shfl(t, slot);
      } else {
        tmin = hit ? t : __int_as_float(0x7f800000);
#pragma unroll
        for (int off = GROUP / 2; off > 0; off >>= 1)
          tmin = fminf(tmin, __shfl_xor_sync(g.mask(), tmin, off, GROUP));
        slot = __ffs(g.ballot(hit && t == tmin)) - 1;
      }
      best_t = tmin;
      best_tri = blk * BS + slot;
      // the tightened best t: the leaf slots after c and the internal
      // slots that still pass
      const unsigned again = __reduce_or_sync(
          g.mask(), (box && tn < best_t && s.w < 0 && g.lane > c ? 1u : 0u) << g.lane |
                      (box && tn < best_t && s.w >= 0 && g.lane >= ic ? 1u : 0u)
                          << (GROUP + g.lane));
      m = again & 0xFFFFu;
      im = again >> GROUP;
    }
    // internal children: descend into the first hit slot >= ic, keep the
    // next one in one stack entry
    if (im != 0) {
      const unsigned rest = im & (im - 1);
      if (rest != 0) {
        if (g.lane == 0 && sp < slots) stack[sp] = (cur << SLOT_BITS) | (__ffs(rest) - 1);
        ++sp;
      }
      cur = __float_as_int(__ldg(row + 3 * K + __ffs(im) - 1));
      ic = 0;
      leaves = true;
    } else if (sp > 0) {
      --sp;
      const int e = g.shfl((g.lane == 0 && sp < slots) ? stack[sp] : -1, 0);
      if (e < 0) break;
      cur = e >> SLOT_BITS;
      ic = e & (K - 1);
      leaves = false;  // this node's leaves were tested before the push
    } else {
      break;
    }
    s = load_slot(node_rows + (nbase + (unsigned)cur * ROW), g.lane);
  }
  return best_tri;
}

// One group per ray; returns the ray's tri (or -1) and leaves its t in
// best_t. A ray whose tmax is <= 0 or NaN loads nothing else. With a
// scalar node offset the root row is loaded together with the ray.
template <bool ANY, bool STEPS>
__device__ __forceinline__ int trace(const float* __restrict__ node_rows,
                                     const float* __restrict__ block_rows,
                                     const float* __restrict__ origins,
                                     const float* __restrict__ dirs, const int* __restrict__ noffs,
                                     const int* __restrict__ toffs, int noff0, int toff0, int i,
                                     int slots, int* stacks, const Group& g, float& best_t,
                                     int& steps) {
  if (!(best_t > 0.0f)) return -1;
  const int noff = noffs ? __ldg(noffs + i) : noff0;
  const int toff = toffs ? __ldg(toffs + i) : toff0;
  const unsigned nbase = (unsigned)noff * ROW;
  const Slot root = load_slot(node_rows + nbase, g.lane);
  const Ray r = load_ray(origins, dirs, i);
  int* stack = stacks + (threadIdx.x / GROUP) * slots;
  return walk<ANY, STEPS>(node_rows, block_rows, nbase, (unsigned)(toff / BS) * BROW, r, slots,
                          stack, g, root, best_t, steps);
}

__global__ void __launch_bounds__(THREADS)
bvh_closest_kernel(const float* __restrict__ node_rows, const float* __restrict__ block_rows,
                   const float* __restrict__ origins, const float* __restrict__ dirs,
                   const float* __restrict__ tmax, const int* __restrict__ noffs,
                   const int* __restrict__ toffs, int noff0, int toff0, int n, int slots,
                   float* __restrict__ t_out, int* __restrict__ tri_out) {
  extern __shared__ int stacks[];
  const int i = blockIdx.x * RAYS + threadIdx.x / GROUP;
  if (i >= n) return;
  const Group g(threadIdx.x);
  float best_t = __ldg(tmax + i);
  int steps = 0;
  const int tri = trace<false, false>(node_rows, block_rows, origins, dirs, noffs, toffs, noff0,
                                      toff0, i, slots, stacks, g, best_t, steps);
  if (g.lane == 0) {
    t_out[i] = tri >= 0 ? best_t : __int_as_float(0x7f800000);
    tri_out[i] = tri;
  }
}

__global__ void __launch_bounds__(THREADS)
bvh_any_kernel(const float* __restrict__ node_rows, const float* __restrict__ block_rows,
               const float* __restrict__ origins, const float* __restrict__ dirs,
               const float* __restrict__ tmax, const int* __restrict__ noffs,
               const int* __restrict__ toffs, int noff0, int toff0, int n, int slots,
               uint8_t* __restrict__ occ_out) {
  extern __shared__ int stacks[];
  const int i = blockIdx.x * RAYS + threadIdx.x / GROUP;
  if (i >= n) return;
  const Group g(threadIdx.x);
  float best_t = __ldg(tmax + i);
  int steps = 0;
  const int tri = trace<true, false>(node_rows, block_rows, origins, dirs, noffs, toffs, noff0,
                                     toff0, i, slots, stacks, g, best_t, steps);
  if (g.lane == 0) occ_out[i] = tri >= 0 ? 1 : 0;
}

__global__ void __launch_bounds__(THREADS)
bvh_steps_kernel(const float* __restrict__ node_rows, const float* __restrict__ block_rows,
                 const float* __restrict__ origins, const float* __restrict__ dirs,
                 const int* __restrict__ noffs, const int* __restrict__ toffs, int noff0,
                 int toff0, int n, int slots, float* __restrict__ steps_out) {
  extern __shared__ int stacks[];
  const int i = blockIdx.x * RAYS + threadIdx.x / GROUP;
  if (i >= n) return;
  const Group g(threadIdx.x);
  float best_t = __int_as_float(0x7f800000);
  int steps = 0;
  trace<false, true>(node_rows, block_rows, origins, dirs, noffs, toffs, noff0, toff0, i, slots,
                     stacks, g, best_t, steps);
  if (g.lane == 0) steps_out[i] = (float)steps;
}

// The geometry ops/bvh.py::launch_geometry computes, and nothing else.
bool geometry_ok(int n, int slots, int threads, int rays_per_block, int smem, int grid) {
  return threads == THREADS && rays_per_block == RAYS && slots >= 1 && slots <= MAX_STACK &&
         smem == RAYS * slots * (int)sizeof(int) && n >= 1 && grid == (n + RAYS - 1) / RAYS;
}

// ---------------------------------------------------------------- K6
//
// K6c / K6a: every round of one call of the instance shortlist rounds in
// one launch, from the world rays (plain version:
// tinsel_tpu_torch/accel/instances.py::rounds_closest_world /
// rounds_any_world; the JAX package's tinsel_tpu/render/trace.py:267
// _instance_rounds and :330 _instance_rounds_any, with :251
// _shortlist_candidates, :216 _instance_box_entry and the local rays of
// :434-436). A round takes, per ray, the k nearest unvisited root-box
// entries of the big instances (argmin's tie rule: the lower instance
// id), walks each pick whose entry is below the best t at the round's
// start under that t, and only then takes the closest of the k results
// (strict <, the lowest pick on a tie); rounds repeat while an unvisited
// entry is below the best t. The occlusion form ORs the walks' bits
// under a fixed tmax.
//
// What bounds it on this card: per ray the function needs its world ray
// in and its result out, the instance table once, each instance's local
// ray and root-box test (some 115 f32 operations, 150 where the batch
// moves: I of them a ray), then the walks, which as K3's are chains of
// dependent row loads bounded by their latency. At many_mesh's 32
// instances and 1M rays the box tests alone are some 3.7e9 operations,
// more time at the card's f32 rate than the rays' bytes take.
//
// The design: one 16-lane group per ray, with K3's launch geometry,
// shared-memory stacks and walk().
//   * The entries in the kernel. Lane j owns instances j, j + 16, ...: it
//     takes the world ray into each one's frame and tests its root box
//     with frame.cuh's functions, the entry +inf where the box is missed
//     or entered at or beyond the ray's best t (K6a: its tmax). Nothing
//     per (instance, ray) pair goes to device memory.
//   * The entries stay on the chip: KEPT of them a lane in registers,
//     the least of 1, 2, 4, 8 that covers I (a template argument, so the
//     array stays in registers; ops/instances.py::kept_entries picks
//     it). Above 128 instances (KEPT = 0) a lane computes its entries
//     again from the records at each scan: the same bits, no cap on I.
//   * The records (96 B an instance, ops/instances.py::pack_instances)
//     are read through L1 (__ldg), not staged in shared memory: the table
//     is the same for every block and small (3 KB for many_mesh's 32
//     instances, 7.6 KB for the 81 grid), so after the first blocks it is
//     in L1 and L2; a lane reads its own records once a ray, and a walk's
//     record is one address for the 16 lanes. Staged in shared memory
//     once a block instead (a barrier before the first box test, I * 96 B
//     in every block), both kernels ran 3.9-5.4 % slower on the bounce-0
//     calls of many_mesh, instances16 and the 81 grid (H100 80GB HBM3,
//     700 W, in turns; PERF.md).
//   * The next pick: each lane takes the least (entry, id) after the last
//     pick among its own entries, then a butterfly of 4 shuffles the
//     least over the group. The plain rounds visit the entries in (entry,
//     id) order, so the visited ones are those at or before the last
//     pick: no visited table. After the box tests the picks read nothing
//     from device memory.
//   * A pick at +inf is never walked (inf < t is false), so the plain
//     version's re-picks of +inf entries once a column is used up change
//     nothing; a round ends at its first pick that is not below its
//     round-start best t (no later pick is).
//   * The walk: every lane takes the world ray into the pick's frame from
//     its record again (the group runs one instruction stream, so this
//     costs what the owner alone would, and needs no shuffle) and walks
//     it with walk().
//   * Per-ray exit: a group leaves when its next entry is not below its
//     best t (K6a: when it is occluded, or its next entry is not below
//     tmax). The plain version loops while any ray passes that test, but
//     a ray that fails it only gets picks walked under tmax 0 (no walk),
//     and it keeps failing: entries only grow and best t only shrinks.
//   * Every pick of a round is walked under the round-start best t, never
//     a t tightened by an earlier pick of the same round: the plain
//     version gives every pick the same tmax, and a triangle's t can lie a
//     rounding below the slab entry of a node that holds it, so a tighter
//     bound can cull the winner's node.
//   * K6a stops at the first pick that occludes (the OR is then set).
//   * A ray whose best t (K6c) or tmax (K6a) is <= 0 or NaN has no entry
//     below it, and an occluded ray no walk: neither loads its world ray.

constexpr int REC = 6;       // float4s of an instance record
constexpr int MAX_KEPT = 8;  // entries a lane keeps in registers at most

// (a, i) comes before (b, j) in the shortlist's order: the entry first,
// then the lower instance id
__device__ __forceinline__ bool before(float a, int i, float b, int j) {
  return a < b || (a == b && i < j);
}

// A world ray and its time (0 where the batch does not move: times NULL)
struct World {
  V3 o, d;
  float time;
};

__device__ __forceinline__ World load_world(const float* __restrict__ origins,
                                            const float* __restrict__ dirs,
                                            const float* __restrict__ times, int r) {
  const float* o = origins + 3 * (size_t)r;
  const float* d = dirs + 3 * (size_t)r;
  return {{__ldg(o), __ldg(o + 1), __ldg(o + 2)},
          {__ldg(d), __ldg(d + 1), __ldg(d + 2)},
          times ? __ldg(times + r) : 0.0f};
}

// An instance's record (ops/instances.py::pack_instances): a = (start p,
// start s), q = start q, b = (end p, end s) - a, dq = end q - q (both
// differences taken on the host in f32), (root lower, node offset),
// (root upper, triangle offset), the offsets as int bits
__device__ __forceinline__ const float4* record(const float4* __restrict__ tab, int id) {
  return tab + (size_t)id * REC;
}

// The world ray in the record's frame (accel/sweep.py::local_ray): the
// transform at the ray's time where the batch moves, else the start one
__device__ __forceinline__ void to_local(const float4* rec, bool motion, const World& w, V3& o,
                                         V3& d) {
  const float4 a = __ldg(rec), q = __ldg(rec + 1);
  if (motion) {
    const Frame f = moving_frame(a, q, __ldg(rec + 2), __ldg(rec + 3), w.time);
    o = inverse_rotate(f.u, f.qw, sub(w.o, f.p), f.s, true);
    d = inverse_rotate(f.u, f.qw, w.d, f.s, true);
  } else {
    const V3 u = {-q.x, -q.y, -q.z};
    o = inverse_rotate(u, q.w, sub(w.o, xyz(a)), a.w, true);
    d = inverse_rotate(u, q.w, w.d, a.w, true);
  }
}

// Instance id's root-box entry for the world ray: +inf where the box is
// missed or entered at or beyond tmax
__device__ __forceinline__ float entry_of(const float4* __restrict__ tab, int id, bool motion,
                                          const World& w, float tmax) {
  const float4* rec = record(tab, id);
  V3 o, d;
  to_local(rec, motion, w, o, d);
  float tn;
  return box_entry(__ldg(rec + 4), __ldg(rec + 5), o, d, tmax, tn) ? tn : inf();
}

// The entries of one lane's instances, e[k] for instance lane + 16 k
// (+inf past the last); KEPT == 0 keeps none
template <int KEPT>
struct Entries {
  float e[KEPT > 0 ? KEPT : 1];
  const float4* tab;
  int n;
  bool motion;
  float tmax;

  __device__ __forceinline__ Entries(const float4* t, int n_inst, bool m, const World& w,
                                     float tm, int lane)
      : tab(t), n(n_inst), motion(m), tmax(tm) {
#pragma unroll
    for (int k = 0; k < KEPT; ++k) {
      const int i = lane + GROUP * k;
      e[k] = i < n ? entry_of(tab, i, motion, w, tmax) : inf();
    }
  }

  // The ray's first entry after (p_tn, p_id) in (entry, id) order, or
  // (+inf, n) if none is left, into (p_tn, p_id)
  __device__ __forceinline__ void next(const World& w, const Group& g, float& p_tn,
                                       int& p_id) const {
    float bt = inf();
    int bi = n;
    if (p_tn != bt) {  // after a +inf pick every entry left is +inf
      if constexpr (KEPT > 0) {
#pragma unroll
        for (int k = 0; k < KEPT; ++k) {
          const int i = g.lane + GROUP * k;
          if (before(p_tn, p_id, e[k], i) && before(e[k], i, bt, bi)) {
            bt = e[k];
            bi = i;
          }
        }
      } else {
        for (int i = g.lane; i < n; i += GROUP) {
          const float v = entry_of(tab, i, motion, w, tmax);
          if (before(p_tn, p_id, v, i) && before(v, i, bt, bi)) {
            bt = v;
            bi = i;
          }
        }
      }
#pragma unroll
      for (int off = GROUP / 2; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(g.mask(), bt, off, GROUP);
        const int oi = __shfl_xor_sync(g.mask(), bi, off, GROUP);
        if (before(ov, oi, bt, bi)) {
          bt = ov;
          bi = oi;
        }
      }
    }
    p_tn = bt;
    p_id = bi;
  }
};

// The walk of instance id's sub-BVH by the ray's group under best_t > 0
// (trace() with the instance's offsets and the world ray in its frame);
// returns the tri_local or -1 (ANY: >= 0 on a hit) and leaves the hit's t
// in best_t
template <bool ANY>
__device__ __forceinline__ int walk_instance(const float* __restrict__ node_rows,
                                             const float* __restrict__ block_rows,
                                             const float4* __restrict__ tab, int id, bool motion,
                                             const World& w, int slots, int* stack,
                                             const Group& g, float& best_t) {
  const float4* rec = record(tab, id);
  const unsigned nbase = (unsigned)__float_as_int(__ldg(&rec[4].w)) * ROW;
  const int toff = __float_as_int(__ldg(&rec[5].w));
  const Slot root = load_slot(node_rows + nbase, g.lane);
  V3 o, d;
  to_local(rec, motion, w, o, d);
  const Ray r = {o.x, o.y, o.z, d.x, d.y, d.z, rcp_nudged(d.x), rcp_nudged(d.y), rcp_nudged(d.z)};
  int steps = 0;
  return walk<ANY, false>(node_rows, block_rows, nbase, (unsigned)(toff / BS) * BROW, r, slots,
                          stack, g, root, best_t, steps);
}

template <int KEPT>
__global__ void __launch_bounds__(THREADS)
bvh_rounds_closest_kernel(const float* __restrict__ node_rows,
                          const float* __restrict__ block_rows, const float4* __restrict__ tab,
                          const float* __restrict__ origins, const float* __restrict__ dirs,
                          const float* __restrict__ times, const float* __restrict__ best_t0,
                          int n_inst, int n, int topk, int slots, float* __restrict__ t_out,
                          int* __restrict__ tri_out, long long* __restrict__ inst_out) {
  extern __shared__ int stacks[];
  const int r = blockIdx.x * RAYS + threadIdx.x / GROUP;
  if (r >= n) return;
  const Group g(threadIdx.x);
  float t_b = __ldg(best_t0 + r);
  int tri_b = -1, inst_b = 0;
  if (t_b > 0.0f) {  // else no entry is below it; t_b stays > 0 from here
    int* stack = stacks + (threadIdx.x / GROUP) * slots;
    const bool motion = times != nullptr;
    const World w = load_world(origins, dirs, times, r);
    const Entries<KEPT> en(tab, n_inst, motion, w, t_b, g.lane);
    float p_tn = -inf();
    int p_id = -1;
    en.next(w, g, p_tn, p_id);
    while (p_tn < t_b) {
      // one round: the next topk picks, each under the round-start t_b
      float t_r = inf();
      int tri_r = -1, inst_r = 0;
      for (int k = 0; k < topk; ++k) {
        if (k > 0) en.next(w, g, p_tn, p_id);
        if (!(p_tn < t_b)) break;
        float bt = t_b;
        const int tri = walk_instance<false>(node_rows, block_rows, tab, p_id, motion, w, slots,
                                             stack, g, bt);
        if (tri >= 0 && bt < t_r) {
          t_r = bt;
          tri_r = tri;
          inst_r = p_id;
        }
      }
      if (t_r < t_b) {
        t_b = t_r;
        tri_b = tri_r;
        inst_b = inst_r;
      }
      en.next(w, g, p_tn, p_id);
    }
  }
  if (g.lane == 0) {
    t_out[r] = t_b;
    tri_out[r] = tri_b;
    inst_out[r] = inst_b;
  }
}

template <int KEPT>
__global__ void __launch_bounds__(THREADS)
bvh_rounds_any_kernel(const float* __restrict__ node_rows, const float* __restrict__ block_rows,
                      const float4* __restrict__ tab, const float* __restrict__ origins,
                      const float* __restrict__ dirs, const float* __restrict__ times,
                      const float* __restrict__ tmax, const uint8_t* __restrict__ occ0,
                      int n_inst, int n, int slots, uint8_t* __restrict__ occ_out) {
  extern __shared__ int stacks[];
  const int r = blockIdx.x * RAYS + threadIdx.x / GROUP;
  if (r >= n) return;
  const Group g(threadIdx.x);
  const float tm = __ldg(tmax + r);
  bool occ = __ldg(occ0 + r) != 0;
  // without an occluder so far, the entries below tmax in (entry, id)
  // order until one occludes; with tmax <= 0 or NaN no walk can hit
  if (!occ && tm > 0.0f) {
    int* stack = stacks + (threadIdx.x / GROUP) * slots;
    const bool motion = times != nullptr;
    const World w = load_world(origins, dirs, times, r);
    const Entries<KEPT> en(tab, n_inst, motion, w, tm, g.lane);
    float p_tn = -inf();
    int p_id = -1;
    while (true) {
      en.next(w, g, p_tn, p_id);
      if (!(p_tn < tm)) break;
      float bt = tm;
      if (walk_instance<true>(node_rows, block_rows, tab, p_id, motion, w, slots, stack, g,
                              bt) >= 0) {
        occ = true;
        break;
      }
    }
  }
  if (g.lane == 0) occ_out[r] = occ ? 1 : 0;
}

// kept: the entries a lane keeps in registers (ops/instances.py::
// kept_entries): 1, 2, 4 or 8 covering the instances, or 0
bool rounds_ok(int n_inst, int kept, int topk, int n, int slots, int threads, int rays_per_block,
               int smem, int grid) {
  const bool regs = kept == 1 || kept == 2 || kept == 4 || kept == MAX_KEPT;
  return n_inst >= 1 && (kept == 0 || (regs && n_inst <= GROUP * kept)) && topk >= 1 &&
         geometry_ok(n, slots, threads, rays_per_block, smem, grid);
}

// the kernel that keeps `kept` entries a lane
template <class Kernel>
Kernel by_kept(int kept, Kernel k0, Kernel k1, Kernel k2, Kernel k4, Kernel k8) {
  switch (kept) {
    case 1: return k1;
    case 2: return k2;
    case 4: return k4;
    case MAX_KEPT: return k8;
    default: return k0;
  }
}

}  // namespace

extern "C" int tinsel_bvh_closest(const float* node_rows, const float* block_rows,
                                  const float* origins, const float* dirs, const float* tmax,
                                  const int* noffs, const int* toffs, int noff0, int toff0,
                                  int n, int slots, int threads, int rays_per_block, int smem,
                                  int grid, float* t_out, int* tri_out, cudaStream_t stream) {
  if (!geometry_ok(n, slots, threads, rays_per_block, smem, grid)) return 9001;
  bvh_closest_kernel<<<grid, threads, smem, stream>>>(node_rows, block_rows, origins, dirs,
                                                      tmax, noffs, toffs, noff0, toff0, n,
                                                      slots, t_out, tri_out);
  return (int)cudaGetLastError();
}

extern "C" int tinsel_bvh_any(const float* node_rows, const float* block_rows,
                              const float* origins, const float* dirs, const float* tmax,
                              const int* noffs, const int* toffs, int noff0, int toff0, int n,
                              int slots, int threads, int rays_per_block, int smem, int grid,
                              uint8_t* occ_out, cudaStream_t stream) {
  if (!geometry_ok(n, slots, threads, rays_per_block, smem, grid)) return 9001;
  bvh_any_kernel<<<grid, threads, smem, stream>>>(node_rows, block_rows, origins, dirs, tmax,
                                                  noffs, toffs, noff0, toff0, n, slots,
                                                  occ_out);
  return (int)cudaGetLastError();
}

extern "C" int tinsel_bvh_steps(const float* node_rows, const float* block_rows,
                                const float* origins, const float* dirs, const int* noffs,
                                const int* toffs, int noff0, int toff0, int n, int slots,
                                int threads, int rays_per_block, int smem, int grid,
                                float* steps_out, cudaStream_t stream) {
  if (!geometry_ok(n, slots, threads, rays_per_block, smem, grid)) return 9001;
  bvh_steps_kernel<<<grid, threads, smem, stream>>>(node_rows, block_rows, origins, dirs, noffs,
                                                    toffs, noff0, toff0, n, slots, steps_out);
  return (int)cudaGetLastError();
}

extern "C" int tinsel_bvh_rounds_closest(const float* node_rows, const float* block_rows,
                                         const float* tab, const float* origins,
                                         const float* dirs, const float* times,
                                         const float* best_t0, int n_inst, int kept, int n,
                                         int topk, int slots, int threads, int rays_per_block,
                                         int smem, int grid, float* t_out, int* tri_out,
                                         long long* inst_out, cudaStream_t stream) {
  if (!rounds_ok(n_inst, kept, topk, n, slots, threads, rays_per_block, smem, grid)) return 9001;
  const auto kernel = by_kept(kept, &bvh_rounds_closest_kernel<0>, &bvh_rounds_closest_kernel<1>,
                              &bvh_rounds_closest_kernel<2>, &bvh_rounds_closest_kernel<4>,
                              &bvh_rounds_closest_kernel<MAX_KEPT>);
  kernel<<<grid, threads, smem, stream>>>(node_rows, block_rows,
                                          reinterpret_cast<const float4*>(tab), origins, dirs,
                                          times, best_t0, n_inst, n, topk, slots, t_out, tri_out,
                                          inst_out);
  return (int)cudaGetLastError();
}

extern "C" int tinsel_bvh_rounds_any(const float* node_rows, const float* block_rows,
                                     const float* tab, const float* origins, const float* dirs,
                                     const float* times, const float* tmax, const uint8_t* occ0,
                                     int n_inst, int kept, int n, int slots, int threads,
                                     int rays_per_block, int smem, int grid, uint8_t* occ_out,
                                     cudaStream_t stream) {
  if (!rounds_ok(n_inst, kept, 1, n, slots, threads, rays_per_block, smem, grid)) return 9001;
  const auto kernel = by_kept(kept, &bvh_rounds_any_kernel<0>, &bvh_rounds_any_kernel<1>,
                              &bvh_rounds_any_kernel<2>, &bvh_rounds_any_kernel<4>,
                              &bvh_rounds_any_kernel<MAX_KEPT>);
  kernel<<<grid, threads, smem, stream>>>(node_rows, block_rows,
                                          reinterpret_cast<const float4*>(tab), origins, dirs,
                                          times, tmax, occ0, n_inst, n, slots, occ_out);
  return (int)cudaGetLastError();
}
