// Brick traces for Hopper (sm_90a): the closest hit of every ray of one
// wavefront wave over a brick set, one thread per ray.  Two kernels:
//
// * brick_trace (B2) replaces the JAX package's Pallas TPU kernel
//   pathtracer_cuda_interactive_tpu/ops/wavefront.py::_make_trace_kernel_slim,
//   built on ops/brickkernel.py::make_brick_intersect(slim=True): per ray,
//   (t, slot) of the closest triangle, slot = brick * 512 + k, with t = inf
//   and slot = -1 on a miss.  Spheres are left to the caller.  Its plain
//   version is ops/brickkernel.py::trace_bricks_plain.
// * brick_trace_full (B3) replaces ops/wavefront.py::_make_trace_kernel,
//   built on make_brick_intersect(slim=False, collect_stats): the resident
//   spheres first, then the same walk carrying (t, slot, u, v), and the
//   16-channel hit record rebuilt once after the walk; with a counter
//   buffer, also the per-ray counts of nodes popped, bricks entered and
//   chunk gates passed, kept in registers and written at the end.  The TPU
//   counts per packet of 2048 rays; a per-ray walk has no packet union to
//   count, so these are per ray.  Its plain version is
//   ops/brickkernel.py::trace_bricks_full_plain.
//
// What bounds them on the card: dependent memory reads and divergence, not
// FP32 work.  Each ray walks the top tree node by node (a 32-byte box and an
// 8-byte link per node), reads the 512-byte chunk-gate row of every brick it
// reaches and 36 bytes of each of the 32 triangles behind every chunk gate it
// passes; neighbouring rays of a warp take different paths through the tree.
// A 328k-triangle scene's bricks are about 64 MB, more than the 50 MB L2.
//
// What the design does about that (a simple design that is right first):
// the walk of csrc/brick_walk.cuh, one thread and one stack per ray; the
// wavefront sorts rays by a coherence key between waves (ops/wavefront.py),
// so neighbouring threads tend to walk the same nodes and bricks and their
// reads coalesce in L1.  Shared-memory staging, cp.async or TMA and
// warp-cooperative walks are for later work.  Arithmetic repeats the plain
// version op for op (--fmad=false, no fast math, IEEE division).

#include "brick_walk.cuh"

namespace {

using namespace pt;

constexpr int kBlock = 128;   // threads per block

__global__ void __launch_bounds__(kBlock)
brick_trace(const float* __restrict__ ox, const float* __restrict__ oy,
            const float* __restrict__ oz, const float* __restrict__ dx,
            const float* __restrict__ dy, const float* __restrict__ dz, int n, float tnear,
            const float* __restrict__ top_boxes, const int* __restrict__ top_links,
            const float* __restrict__ brick_data, float* __restrict__ out_t,
            int* __restrict__ out_slot) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Bricks b = {top_boxes, top_links, brick_data};
  float best_t = INFINITY, u, v;
  int best_slot = -1;
  WalkCounts unused;
  brick_walk<false, false>(b, {ox[i], oy[i], oz[i]}, {dx[i], dy[i], dz[i]}, tnear, best_t,
                           best_slot, u, v, unused);
  out_t[i] = best_t;
  out_slot[i] = best_slot;
}

// out: [16, n] channel-major (coalesced stores); stats: [3, n] when kStats.
template <bool kStats>
__global__ void __launch_bounds__(kBlock)
brick_trace_full(const float* __restrict__ ox, const float* __restrict__ oy,
                 const float* __restrict__ oz, const float* __restrict__ dx,
                 const float* __restrict__ dy, const float* __restrict__ dz, int n,
                 float tnear, const unsigned char* __restrict__ active,
                 const float* __restrict__ sph_rows, int S,
                 const float* __restrict__ top_boxes, const int* __restrict__ top_links,
                 const float* __restrict__ brick_data, float* __restrict__ out,
                 int* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Bricks b = {top_boxes, top_links, brick_data};
  WalkCounts counts = {0, 0, 0};
  HitRecord rec = miss_record();
  if (active == nullptr || active[i]) {
    brick_closest<kStats>(sph_rows, S, b, {ox[i], oy[i], oz[i]}, {dx[i], dy[i], dz[i]}, tnear,
                          rec, counts);
  }
  const float ch[16] = {rec.t,        rec.ns.x,     rec.ns.y,     rec.ns.z,
                        rec.pos.x,    rec.pos.y,    rec.pos.z,    rec.mtype,
                        rec.albedo.x, rec.albedo.y, rec.albedo.z, rec.mparam,
                        rec.emission.x, rec.emission.y, rec.emission.z, rec.emit};
#pragma unroll
  for (int c = 0; c < 16; ++c) out[(size_t)c * n + i] = ch[c];
  if constexpr (kStats) {
    stats[i] = counts.nodes;
    stats[(size_t)n + i] = counts.bricks;
    stats[2 * (size_t)n + i] = counts.chunks;
  }
}

}  // namespace

// Launch B2 on `stream`.  The caller checks that the top tree's depth + 2 is
// at most kStack.  Returns cudaGetLastError() (0 on success).
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

// Launch B3 on `stream`: `active` may be null (every ray traced), `stats`
// null (no counters).  Returns cudaGetLastError() (0 on success).
extern "C" int pt_brick_trace_full_launch(const float* ox, const float* oy, const float* oz,
                                          const float* dx, const float* dy, const float* dz,
                                          int n, float tnear, const unsigned char* active,
                                          const float* sph_rows, int num_spheres,
                                          const float* top_boxes, const int* top_links,
                                          const float* brick_data, float* out, int* stats,
                                          void* stream) {
  if (n <= 0) return 0;
  const dim3 grid((unsigned)((n + kBlock - 1) / kBlock));
  if (stats != nullptr) {
    brick_trace_full<true><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        ox, oy, oz, dx, dy, dz, n, tnear, active, sph_rows, num_spheres, top_boxes, top_links,
        brick_data, out, stats);
  } else {
    brick_trace_full<false><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        ox, oy, oz, dx, dy, dz, n, tnear, active, sph_rows, num_spheres, top_boxes, top_links,
        brick_data, out, stats);
  }
  return (int)cudaGetLastError();
}
