// The per-ray brick walk shared by the brick kernels: the slim trace
// (csrc/brick_trace.cu, B2), the full-record trace (the same file, B3), the
// persistent brick render (csrc/brick_render.cu, B6) and, with every leaf
// deferred by one, the pipelined slim trace (csrc/brick_trace_slim2.cu, B4).
// It is the counterpart of the JAX package's
// ops/brickkernel.py::make_brick_intersect (and make_brick_intersect_pipelined)
// and is held to ops/brickkernel.py's plain walk.  The pair-list trace
// (csrc/pair_trace.cu, B5) takes its slab tests, its walk-table reads and
// one round of its warp's chunk test (warp_chunk_round).
//
// What a ray does (the contract; the plain walk does the same):
//   * it keeps its own stack of top-tree nodes, as in the reference CUDA
//     design (scene.h:246-301), where the TPU walks one packet of 2048 rays
//     with one scalar cursor and pays the union of their paths.  A popped
//     node whose own box the ray misses, or meets beyond its current best t,
//     is dropped; at an internal node the child whose box centre projects
//     lower on the ray's own direction is visited first (the TPU projects on
//     the packet's mean direction);
//   * a leaf is a brick of 512 triangle slots behind 16 chunk gates of 32;
//     chunks are taken in order, a chunk is tested only while its gate passes
//     against the current best t, and inside it the first triangle with the
//     smallest t wins (strict t < best);
//   * min/max in the slab test propagate NaN like torch.minimum and
//     jnp.minimum: an axis-parallel ray whose origin lies on a box plane
//     computes 0 * inf = NaN there, and such a box is a miss.  CUDA's
//     fminf/fmaxf would drop the NaN and admit the box.
//
// What bounds the walk on the card is the latency of dependent reads and
// the divergence of a warp's 32 walks, not bytes or FP32 work (the computed
// bound is about 1% of its time).  The design, for Hopper:
//   * It reads the set's walk table (models/bricks.py::WalkTable), not the
//     set's own tensors.  A node is one 64-byte record: its box, its brick
//     and, for an internal node, both children with the centre sums the
//     ordering needs, so a pop is one round of four 16-byte loads (from the
//     set's own tensors it is three to four dependent rounds: box, link, the
//     right child's link, both children's boxes).  A triangle's nine test
//     floats lie apart from its 128-byte record, per chunk as nine runs of
//     32 floats: 1,152 bytes a chunk instead of 4,096, so a large scene's
//     triangles stay in the 50 MB L2 (17 MB for 925 bricks, against 64 MB of
//     records).  The gates are read as two 16-byte loads from the set's
//     compact sub_boxes.
//   * One loop holds three phases, and a warp's lanes meet again before each
//     (the "while-while" traversal of Aila and Laine, HPG 2009, with the
//     leaf split once more): a lane with no gates left pops nodes until it
//     enters a leaf or its stack is empty; a lane in a leaf scans gates
//     until one passes; then the lanes that hold a chunk test triangles
//     together, so a lane's triangle tests do not run while the lanes still
//     in the tree wait, nor the other way round.
//   * The warp tests a held chunk together: it takes each holder's ray in
//     turn by shuffles, lane k tests triangle k of that chunk (one coalesced
//     128-byte line per run), and a warp min-reduction of t's bit pattern
//     (t > 0, so the bits order as t does) with the lowest lane on a tie
//     picks the winner.  That is the sequential rule: a triangle wins in
//     sequence only with t below the best on entry to the chunk, every lane
//     tests against that entry value, and "smallest t, first k" is what a
//     strict t < best in slot order selects.  Letting each holder scan its
//     own chunk instead (32 tests in a row), in rounds where more than 0, 8,
//     16 or 24 lanes hold one, measured slower on every bounce wave and in
//     B6, and costs 24 registers (PERF.md).
//   * The node records are read from global memory through L1 (__ldg).
//     Staging all of them per block in shared memory (118 KB for 925 bricks,
//     so one persistent 1,024-thread block per SM) measured 1.35 to 1.74
//     times slower for B2 (PERF.md): the top of the tree is in L1
//     anyway, and fewer resident warps hide less of the other reads.
// Every lane of a warp must call the walk together (the shuffles name the
// full warp); a lane without a ray passes active = false.
//
// The stack is a local array of the brick builder's bound,
// models/bricks.py::STACK_DEPTH slots (the wrappers check the tree's depth
// against it); a walk touches only its first depth + 1 slots.  Arithmetic
// repeats the plain version op for op (--fmad=false, IEEE division).
#pragma once

#include "pt_common.cuh"

namespace pt {

constexpr int kBrickPrims = 512;           // prims per brick
constexpr int kSubPrims = 32;              // prims per chunk
constexpr int kNumSubs = 16;               // chunks per brick
constexpr int kBrickFloats = 136 * 128;    // one [BRICK_ROWS, 128] block
constexpr int kStack = 192;                // models/bricks.py::STACK_DEPTH
constexpr int kNodeVecs = 4;               // float4 per WalkTable node record
constexpr int kChunkFloats = 9 * kSubPrims;     // WalkTable floats per chunk

// min / max that return NaN when either input is NaN (torch.minimum semantics)
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// ops/geometry.py::slab_interval: the ray's entry and exit times (tn, tf) of
// box lo x hi; NaN propagates.
__device__ __forceinline__ void slab_interval(V3 lo, V3 hi, V3 o, V3 inv, float& tn, float& tf) {
  const float tx0 = (lo.x - o.x) * inv.x;
  const float tx1 = (hi.x - o.x) * inv.x;
  const float ty0 = (lo.y - o.y) * inv.y;
  const float ty1 = (hi.y - o.y) * inv.y;
  const float tz0 = (lo.z - o.z) * inv.z;
  const float tz1 = (hi.z - o.z) * inv.z;
  tn = nan_max(nan_max(nan_min(tx0, tx1), nan_min(ty0, ty1)), nan_min(tz0, tz1));
  tf = nan_min(nan_min(nan_max(tx0, tx1), nan_max(ty0, ty1)), nan_max(tz0, tz1));
}

// ops/geometry.py::slab_hit: the ray meets box lo x hi at or after 0 and no
// later than t_max; a NaN (0 * inf on a box plane) is a miss.
__device__ __forceinline__ bool slab_hit(V3 lo, V3 hi, V3 o, V3 inv, float t_max) {
  float tn, tf;
  slab_interval(lo, hi, o, inv, tn, tf);
  return (tf >= nan_max(tn, 0.0f)) && (tn <= t_max);
}

// The same test with a NaN counted as a hit.  For a box that contains other
// boxes it says yes wherever slab_hit says yes for one of them: a containing
// box has tn no larger and tf no smaller (rounding is monotone), and the NaN
// of a contained box lies on another plane.
__device__ __forceinline__ bool slab_maybe(V3 lo, V3 hi, V3 o, V3 inv, float t_max) {
  float tn, tf;
  slab_interval(lo, hi, o, inv, tn, tf);
  return !(tf < nan_max(tn, 0.0f)) && !(tn > t_max);
}

// What the walk reads: the set's WalkTable (nodes, tris), its sub_boxes
// (gates) and, for the winner's record, its brick_data.
struct WalkTable {
  const float4* __restrict__ nodes;
  const float* __restrict__ tris;
  const float4* __restrict__ gates;
  const float* __restrict__ brick_data;
};

// The record of triangle slot = brick * 512 + k.
__device__ __forceinline__ const float* slot_row(const float* brick_data, int slot) {
  return brick_data + (size_t)(slot / kBrickPrims) * kBrickFloats + (slot % kBrickPrims) * kRow;
}

// Per-ray traversal counters: nodes popped, bricks (leaves) entered and
// chunk gates passed.
struct WalkCounts {
  int nodes, bricks, chunks;
};

// Triangle k of a chunk: its test floats from the walk table's nine runs
// (a warp reading k = lane reads each run as one 128-byte line).
struct ChunkTri {
  V3 p0, e1, e2;
};
__device__ __forceinline__ ChunkTri chunk_tri(const WalkTable& w, int chunk, int k) {
  const float* tri = w.tris + (size_t)chunk * kChunkFloats + k;
  return {{__ldg(tri), __ldg(tri + 32), __ldg(tri + 64)},
          {__ldg(tri + 96), __ldg(tri + 128), __ldg(tri + 160)},
          {__ldg(tri + 192), __ldg(tri + 224), __ldg(tri + 256)}};
}

// One round of the warp's test of a held chunk: the ray of lane `src` (its
// o, d, tnear and best t, taken by shuffles) against the 32 triangles of
// `chunk`, lane k testing triangle k.  The first triangle with the smallest t
// strictly below that ray's best t wins (a min-reduction of t's bits, the
// lowest lane on a tie), and lane src takes it: kFull also takes its (u, v).
// All 32 lanes call it together.  The shuffles come before the triangle's
// loads: loads first measured 1-3% slower for B2 (PERF.md).
template <bool kFull>
__device__ __forceinline__ void warp_chunk_round(const WalkTable& w, int chunk, int src, V3 o,
                                                 V3 d, float tnear, float& best_t, int& best_slot,
                                                 float& best_u, float& best_v) {
  const int lane = threadIdx.x % 32;
  const V3 ro = shfl3(o, src), rd = shfl3(d, src);
  const float rnear = __shfl_sync(kFullWarp, tnear, src);
  const float rbest = __shfl_sync(kFullWarp, best_t, src);
  const ChunkTri tri = chunk_tri(w, chunk, lane);
  float t, u, v;
  const bool hit = tri_test(tri.p0, tri.e1, tri.e2, ro, rd, rnear, rbest, t, u, v) && t < rbest;
  // a hit's t is above tnear >= 0 and finite: its bits order as it does
  const unsigned key = hit ? __float_as_uint(t) : kInfBits;
  const unsigned nearest = __reduce_min_sync(kFullWarp, key);
  if (nearest == kInfBits) return;
  const int k = __ffs(__ballot_sync(kFullWarp, key == nearest)) - 1;
  float wu = 0.0f, wv = 0.0f;
  if constexpr (kFull) {
    wu = __shfl_sync(kFullWarp, u, k);
    wv = __shfl_sync(kFullWarp, v, k);
  }
  if (lane == src) {
    best_t = __uint_as_float(nearest);
    best_slot = chunk * kSubPrims + k;
    if constexpr (kFull) {
      best_u = wu;
      best_v = wv;
    }
  }
}

// Closest triangle hit over the bricks, below the given best_t.  Updates
// best_t and best_slot where a triangle is strictly nearer; kFull also
// carries that triangle's (u, v), kStats counts into `counts`.  All 32 lanes
// of a warp call it together; a lane with active = false walks nothing.
//
// kDefer is the walk of kernel B4 (the plain _walk(pipelined=True)): a leaf
// that is found becomes pending, and the pending leaf is entered only when
// the next leaf is found or the stack is about to run out, so the nodes
// between two leaves are classified against a best t that is one leaf
// stale.  Leaves are entered in the walk's own order and every gate and
// triangle test is against the current best t, so (t, slot) are those of
// the walk without it, bit for bit.
template <bool kFull, bool kStats, bool kDefer = false>
__device__ __forceinline__ void brick_walk(const WalkTable& w, bool active, V3 o, V3 d,
                                           float tnear, float& best_t, int& best_slot,
                                           float& best_u, float& best_v, WalkCounts& counts) {
  static_assert(!(kStats && kDefer), "the deferred walk keeps no counters");
  const V3 inv = {1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  int stack[kStack];
  int sp = 0;
  if (active) stack[sp++] = 0;
  int next = 0, end = 0;   // the chunks of the entered leaf still behind their gates
  int pend = -1;           // kDefer: the pending leaf's brick
  while (true) {
    // a lane with no gates left pops nodes until it enters a leaf
    while (next == end && (sp > 0 || (kDefer && pend >= 0))) {
      if constexpr (kDefer) {
        // the stack is about to run out: the pending leaf is entered
        if (sp <= 1 && pend >= 0) {
          next = pend * kNumSubs;
          end = next + kNumSubs;
          pend = -1;
        }
        if (sp == 0) continue;
      }
      const int node = stack[--sp];
      if constexpr (kStats) ++counts.nodes;
      const float4* rec = w.nodes + (size_t)node * kNodeVecs;
      const float4 a = __ldg(rec), b = __ldg(rec + 1), l = __ldg(rec + 2), r = __ldg(rec + 3);
      if (!slab_hit({a.x, a.y, a.z}, {a.w, b.x, b.y}, o, inv, best_t)) continue;
      const int brick = __float_as_int(b.w);
      if (brick >= 0) {
        if constexpr (kDefer) {
          // the next leaf is found: the pending one is entered and the
          // found one takes its place
          if (pend >= 0) {
            next = pend * kNumSubs;
            end = next + kNumSubs;
          }
          pend = brick;
        } else {
          if constexpr (kStats) ++counts.bricks;
          next = brick * kNumSubs;
          end = next + kNumSubs;
        }
      } else {
        const bool left_first =
            l.x * d.x + l.y * d.y + l.z * d.z <= r.x * d.x + r.y * d.y + r.z * d.z;
        const int left = __float_as_int(l.w), right = __float_as_int(r.w);
        stack[sp++] = left_first ? right : left;   // far
        stack[sp++] = left_first ? left : right;   // near, popped first
      }
    }
    // a lane in a leaf scans its gates until one passes
    int held = -1;
    while (next < end) {
      const int chunk = next++;
      const float4 g0 = __ldg(w.gates + (size_t)chunk * 2);
      const float4 g1 = __ldg(w.gates + (size_t)chunk * 2 + 1);
      if (g1.z > 0.0f && slab_hit({g0.x, g0.y, g0.z}, {g0.w, g1.x, g1.y}, o, inv, best_t)) {
        if constexpr (kStats) ++counts.chunks;
        held = chunk;
        break;
      }
    }
    // the warp tests the held chunks, one holder's ray at a time
    const unsigned holders = __ballot_sync(kFullWarp, held >= 0);
    if (holders == 0) {
      // no lane is in a leaf: every lane's gates are scanned
      if (__all_sync(kFullWarp, sp == 0 && (!kDefer || pend < 0))) break;
      continue;
    }
    for (unsigned rest = holders; rest != 0; rest &= rest - 1) {
      const int src = __ffs(rest) - 1;
      const int chunk = __shfl_sync(kFullWarp, held, src);
      warp_chunk_round<kFull>(w, chunk, src, o, d, tnear, best_t, best_slot, best_u, best_v);
    }
  }
}

// The full closest hit of the JAX package's non-slim intersector: the
// resident spheres first, then the bricks, each with a strict t < best, so
// a sphere wins an equal-t tie.  Returns false on a miss (and for a lane
// that is not active); on a hit, `rec` is rebuilt once from the winner (the
// triangle's own (u, v)).  All 32 lanes of a warp call it together.
template <bool kStats>
__device__ __forceinline__ bool brick_closest(const float* sph_rows, int S, const WalkTable& w,
                                              bool active, V3 o, V3 d, float tnear,
                                              HitRecord& rec, WalkCounts& counts) {
  float best_t = INFINITY;
  int best_k = -1;
  if (active) {
    for (int k = 0; k < S; ++k) {
      const float* r = sph_rows + k * kRow;
      float t;
      if (sphere_test(load3(r + 1), r[4], o, d, tnear, best_t, t) && t < best_t) {
        best_t = t;
        best_k = k;
      }
    }
  }
  int slot = -1;
  float u = 0.0f, v = 0.0f;
  brick_walk<true, kStats>(w, active, o, d, tnear, best_t, slot, u, v, counts);
  if (slot >= 0) {
    rec = triangle_record(slot_row(w.brick_data, slot), best_t, u, v);
    return true;
  }
  if (best_k >= 0) {
    rec = sphere_record(sph_rows + best_k * kRow, o, d, best_t);
    return true;
  }
  rec = miss_record();
  return false;
}

}  // namespace pt
