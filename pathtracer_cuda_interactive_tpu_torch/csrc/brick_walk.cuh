// The per-ray brick walk shared by the brick kernels: the slim trace
// (csrc/brick_trace.cu, B2), the full-record trace (the same file, B3) and
// the persistent brick render (csrc/brick_render.cu, B6).  It is the
// counterpart of the JAX package's ops/brickkernel.py::make_brick_intersect
// and is held to ops/brickkernel.py's plain walk.
//
// One thread walks one ray with its own stack, as in the reference CUDA
// design (scene.h:246-301), where the TPU walks one packet of 2048 rays with
// one scalar cursor and pays the union of their paths:
//   * the top tree (models/bricks.py: node n's box at n * 8, its links at
//     n * 2 = (skip, brick)) is walked nearer child first, nearer along the
//     ray's own direction by the projection of the child boxes' centres
//     (the TPU projects on the packet's mean direction);
//   * a leaf is a brick of 512 triangle records behind 16 chunk gates of 32
//     triangles; a chunk is tested only while its gate passes against the
//     best t, and inside it the first triangle with the smallest t wins
//     (strict t < best);
//   * min/max in the slab test propagate NaN like torch.minimum and
//     jnp.minimum: an axis-parallel ray whose origin lies on a box plane
//     computes 0 * inf = NaN there, and such a box is a miss.  CUDA's
//     fminf/fmaxf would drop the NaN and admit the box.
// The stack is a local array of the brick builder's bound,
// models/bricks.py::STACK_DEPTH slots (the wrappers check the tree's depth
// against it); a walk touches only its first depth + 1 slots.  Brick
// records are read from global memory through L1 and L2.
#pragma once

#include "pt_common.cuh"

namespace pt {

constexpr int kBrickPrims = 512;           // prims per brick
constexpr int kSubPrims = 32;              // prims per chunk
constexpr int kNumSubs = 16;               // chunks per brick
constexpr int kBrickFloats = 136 * 128;    // one [BRICK_ROWS, 128] block
constexpr int kSubRow = 128 * 128;         // offset of the chunk-gate row
constexpr int kStack = 192;                // models/bricks.py::STACK_DEPTH

// min / max that return NaN when either input is NaN (torch.minimum semantics)
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// ops/geometry.py::slab_interval + slab_hit: the ray meets box [b0..b2] x
// [b3..b5] at or after 0 and no later than t_max.
__device__ __forceinline__ bool slab_hit(const float* b, V3 o, V3 inv, float t_max) {
  const float tx0 = (b[0] - o.x) * inv.x;
  const float tx1 = (b[3] - o.x) * inv.x;
  const float ty0 = (b[1] - o.y) * inv.y;
  const float ty1 = (b[4] - o.y) * inv.y;
  const float tz0 = (b[2] - o.z) * inv.z;
  const float tz1 = (b[5] - o.z) * inv.z;
  const float tn = nan_max(nan_max(nan_min(tx0, tx1), nan_min(ty0, ty1)), nan_min(tz0, tz1));
  const float tf = nan_min(nan_min(nan_max(tx0, tx1), nan_max(ty0, ty1)), nan_max(tz0, tz1));
  return (tf >= nan_max(tn, 0.0f)) && (tn <= t_max);
}

// projection of a node box's (doubled) centre on the ray direction
__device__ __forceinline__ float center_key(const float* b, V3 d) {
  return (b[0] + b[3]) * d.x + (b[1] + b[4]) * d.y + (b[2] + b[5]) * d.z;
}

// The brick set as the kernels read it.
struct Bricks {
  const float* __restrict__ top_boxes;
  const int* __restrict__ top_links;
  const float* __restrict__ brick_data;
};

// The record of triangle slot = brick * 512 + k.
__device__ __forceinline__ const float* slot_row(const Bricks& b, int slot) {
  return b.brick_data + (size_t)(slot / kBrickPrims) * kBrickFloats + (slot % kBrickPrims) * kRow;
}

// Per-ray traversal counters: nodes popped, bricks (leaves) entered and
// chunk gates passed.
struct WalkCounts {
  int nodes, bricks, chunks;
};

// Closest triangle hit over the bricks, below the given best_t.  Updates
// best_t and best_slot where a triangle is strictly nearer; kFull also
// carries that triangle's (u, v), kStats counts into `counts`.
template <bool kFull, bool kStats>
__device__ __forceinline__ void brick_walk(const Bricks& b, V3 o, V3 d, float tnear,
                                           float& best_t, int& best_slot, float& best_u,
                                           float& best_v, WalkCounts& counts) {
  const V3 inv = {1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  int stack[kStack];
  int sp = 0;
  stack[sp++] = 0;
  while (sp > 0) {
    const int node = stack[--sp];
    if constexpr (kStats) ++counts.nodes;
    if (!slab_hit(b.top_boxes + node * 8, o, inv, best_t)) continue;
    const int brick = b.top_links[node * 2 + 1];
    if (brick >= 0) {
      if constexpr (kStats) ++counts.bricks;
      const float* blk = b.brick_data + (size_t)brick * kBrickFloats;
      for (int s = 0; s < kNumSubs; ++s) {
        const float* gate = blk + kSubRow + s * 8;
        if (!(gate[6] > 0.0f) || !slab_hit(gate, o, inv, best_t)) continue;
        if constexpr (kStats) ++counts.chunks;
        for (int k = s * kSubPrims; k < (s + 1) * kSubPrims; ++k) {
          const float* r = blk + k * kRow;
          float t, u, v;
          if (tri_test(load3(r + 1), load3(r + 4), load3(r + 7), o, d, tnear, best_t, t, u, v) &&
              t < best_t) {
            best_t = t;
            best_slot = brick * kBrickPrims + k;
            if constexpr (kFull) {
              best_u = u;
              best_v = v;
            }
          }
        }
      }
    } else {
      const int left = node + 1;
      const int right = b.top_links[left * 2];   // skip(left)
      const bool left_first =
          center_key(b.top_boxes + left * 8, d) <= center_key(b.top_boxes + right * 8, d);
      stack[sp++] = left_first ? right : left;   // far
      stack[sp++] = left_first ? left : right;   // near, popped first
    }
  }
}

// The full closest hit of the JAX package's non-slim intersector: the
// resident spheres first, then the bricks, each with a strict t < best, so
// a sphere wins an equal-t tie.  Returns false on a miss; on a hit, `rec`
// is rebuilt once from the winner (the triangle's own (u, v)).
template <bool kStats>
__device__ __forceinline__ bool brick_closest(const float* sph_rows, int S, const Bricks& b,
                                              V3 o, V3 d, float tnear, HitRecord& rec,
                                              WalkCounts& counts) {
  float best_t = INFINITY;
  int best_k = -1;
  for (int k = 0; k < S; ++k) {
    const float* r = sph_rows + k * kRow;
    float t;
    if (sphere_test(load3(r + 1), r[4], o, d, tnear, best_t, t) && t < best_t) {
      best_t = t;
      best_k = k;
    }
  }
  int slot = -1;
  float u = 0.0f, v = 0.0f;
  brick_walk<true, kStats>(b, o, d, tnear, best_t, slot, u, v, counts);
  if (slot >= 0) {
    rec = triangle_record(slot_row(b, slot), best_t, u, v);
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
