// Brick trace (kernel B2) for Hopper (sm_90a): the closest triangle hit of
// every ray of one wavefront wave over a brick set.
//
// Replaces the JAX package's Pallas TPU kernel
// pathtracer_cuda_interactive_tpu/ops/wavefront.py::_make_trace_kernel_slim,
// built on ops/brickkernel.py::make_brick_intersect(slim=True).  It computes
// what that kernel computes: per ray, (t, slot) of the closest triangle over
// the bricks (models/bricks.py layout), slot = brick * 512 + k, with t = inf
// and slot = -1 on a miss.  Spheres are left to the caller.  The plain
// version it is held to is ops/brickkernel.py::trace_bricks_plain.
//
// What bounds it on the card: dependent memory reads and divergence, not
// FP32 work.  Each ray walks the top tree node by node (a 32-byte box and an
// 8-byte link per node), reads the 512-byte chunk-gate row of every brick it
// reaches and 36 bytes of each of the 32 triangles behind every chunk gate it
// passes; neighbouring rays of a warp take different paths through the tree.
// A 328k-triangle scene's bricks are about 90 MB, more than the 50 MB L2.
//
// What the design does about that (a simple design that is right first):
//   * One thread per ray and a stack per thread, as in the reference CUDA
//     design (scene.h:246-301), where the TPU walks one packet of 2048 rays
//     with one scalar cursor and pays the union of their paths.  The stack
//     is a local array of the brick builder's bound, models/bricks.py::
//     STACK_DEPTH slots (the wrapper checks the tree's depth against it);
//     a walk touches only its first depth + 1 slots.
//   * The nearer child is pushed last, so it is visited first: nearer along
//     the ray's own direction, by the projection of the child boxes'
//     centres (the TPU projects on the packet's mean direction).  A far
//     subtree is then often culled by its box test against the best t.
//   * The wavefront sorts rays by a coherence key between waves
//     (ops/wavefront.py), so neighbouring threads tend to walk the same
//     nodes and bricks; their reads then coalesce in L1.
//   * Brick records are read from global memory through L1 and L2 with
//     read-only loads.  Shared-memory staging, cp.async or TMA and
//     warp-cooperative walks are for later work.
//   * Arithmetic repeats the plain version op for op (--fmad=false, no fast
//     math, IEEE division), and min/max in the slab test propagate NaN like
//     torch.minimum and jnp.minimum: an axis-parallel ray whose origin lies
//     on a box plane computes 0 * inf = NaN there, and such a box is a miss.
//     CUDA's fminf/fmaxf would drop the NaN and admit the box.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBrickPrims = 512;           // prims per brick
constexpr int kSubPrims = 32;              // prims per chunk
constexpr int kNumSubs = 16;               // chunks per brick
constexpr int kRec = 32;                   // floats per prim record
constexpr int kBrickFloats = 136 * 128;    // one [BRICK_ROWS, 128] block
constexpr int kSubRow = 128 * 128;         // offset of the chunk-gate row
constexpr int kBlock = 128;                // threads per block
constexpr int kStack = 192;                // models/bricks.py::STACK_DEPTH

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 load3(const float* p) { return {p[0], p[1], p[2]}; }

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

// ops/geometry.py::intersect_triangle (Moller-Trumbore on p0, e1, e2)
__device__ __forceinline__ bool tri_test(V3 p0, V3 e1, V3 e2, V3 org, V3 dir, float tnear,
                                         float tfar, float& t) {
  const V3 s1 = cross(dir, e2);
  const float divisor = dot(s1, e1);
  const bool ok = divisor != 0.0f;
  const float inv_div = 1.0f / (ok ? divisor : 1.0f);
  const V3 s = sub(org, p0);
  const float u = dot(s, s1) * inv_div;
  const V3 s2 = cross(s, e1);
  const float v = dot(dir, s2) * inv_div;
  t = dot(e2, s2) * inv_div;
  return ok && (t > tnear) && (t < tfar) && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f);
}

// projection of a node box's (doubled) centre on the ray direction
__device__ __forceinline__ float center_key(const float* b, V3 d) {
  return (b[0] + b[3]) * d.x + (b[1] + b[4]) * d.y + (b[2] + b[5]) * d.z;
}

__global__ void __launch_bounds__(kBlock)
brick_trace(const float* __restrict__ ox, const float* __restrict__ oy,
            const float* __restrict__ oz, const float* __restrict__ dx,
            const float* __restrict__ dy, const float* __restrict__ dz, int n, float tnear,
            const float* __restrict__ top_boxes, const int* __restrict__ top_links,
            const float* __restrict__ brick_data, float* __restrict__ out_t,
            int* __restrict__ out_slot) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const V3 o = {ox[i], oy[i], oz[i]};
  const V3 d = {dx[i], dy[i], dz[i]};
  const V3 inv = {1.0f / d.x, 1.0f / d.y, 1.0f / d.z};

  float best_t = INFINITY;
  int best_slot = -1;
  int stack[kStack];
  int sp = 0;
  stack[sp++] = 0;
  while (sp > 0) {
    const int node = stack[--sp];
    // node n: box at n * 8 (min xyz, max xyz), links at n * 2 (skip, brick)
    if (!slab_hit(top_boxes + node * 8, o, inv, best_t)) continue;
    const int brick = top_links[node * 2 + 1];
    if (brick >= 0) {
      const float* blk = brick_data + (size_t)brick * kBrickFloats;
      for (int s = 0; s < kNumSubs; ++s) {
        const float* gate = blk + kSubRow + s * 8;
        if (!(gate[6] > 0.0f) || !slab_hit(gate, o, inv, best_t)) continue;
        for (int k = s * kSubPrims; k < (s + 1) * kSubPrims; ++k) {
          const float* r = blk + k * kRec;
          float t;
          if (tri_test(load3(r + 1), load3(r + 4), load3(r + 7), o, d, tnear, best_t, t) &&
              t < best_t) {
            best_t = t;
            best_slot = brick * kBrickPrims + k;
          }
        }
      }
    } else {
      const int left = node + 1;
      const int right = top_links[left * 2];   // skip(left)
      const bool left_first =
          center_key(top_boxes + left * 8, d) <= center_key(top_boxes + right * 8, d);
      stack[sp++] = left_first ? right : left;   // far
      stack[sp++] = left_first ? left : right;   // near, popped first
    }
  }
  out_t[i] = best_t;
  out_slot[i] = best_slot;
}

}  // namespace

// Launch on `stream`.  The caller checks that the top tree's depth + 2 is at
// most kStack.  Returns cudaGetLastError() (0 on success).
extern "C" int pt_brick_trace_launch(const float* ox, const float* oy, const float* oz,
                                     const float* dx, const float* dy, const float* dz, int n,
                                     float tnear, const float* top_boxes, const int* top_links,
                                     const float* brick_data, float* out_t, int* out_slot,
                                     void* stream) {
  if (n <= 0) return 0;
  const dim3 grid((unsigned)((n + kBlock - 1) / kBlock));
  brick_trace<<<grid, kBlock, 0, (cudaStream_t)stream>>>(ox, oy, oz, dx, dy, dz, n, tnear,
                                                         top_boxes, top_links, brick_data, out_t,
                                                         out_slot);
  return (int)cudaGetLastError();
}
