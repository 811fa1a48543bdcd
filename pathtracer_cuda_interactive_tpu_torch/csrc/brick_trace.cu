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
// What bounds them on the card: the latency of dependent reads and the
// divergence of a warp's 32 walks, not bytes or FP32 work.  Per ray a wave
// pops 13-16 nodes, enters 1.4-1.7 bricks and passes 1.7-2.3 chunk gates
// (54-73 triangle tests against 35-43 box tests); the bytes a wave must move
// and its operations would take about 1% of its time.
//
// What the design does about that is the walk's (csrc/brick_walk.cuh): a
// compact walk table, one 64-byte record a node and 1,152 bytes a chunk of
// triangles, that stays in L2; one loop whose lanes meet again before the
// node, gate and triangle phases; and a held chunk's 32 triangles tested by
// the whole warp at once.  These kernels are thin shells around it: one thread
// per ray, 128-thread blocks, whole warps in the walk (a thread past the
// wave's end, or a ray masked out, takes part without a ray).  The wavefront
// sorts rays by a coherence key between waves (ops/wavefront.py), so
// neighbouring threads tend to walk the same nodes and bricks.  Arithmetic
// repeats the plain version op for op (--fmad=false, no fast math, IEEE
// division).

#include "brick_walk.cuh"

namespace {

using namespace pt;

constexpr int kBlock = 128;   // threads per block
// the live count's slot in the fixed-capacity loop's control block
// (ops/wave_step.py::COUNT; csrc/wave_step.cu)
constexpr int kCount = 0;

// `ctl` null: n rays; else the first min(n, ctl[kCount]) of the n columns,
// and a block wholly past them returns at once
__global__ void __launch_bounds__(kBlock)
brick_trace(const float* __restrict__ ox, const float* __restrict__ oy,
            const float* __restrict__ oz, const float* __restrict__ dx,
            const float* __restrict__ dy, const float* __restrict__ dz, int n, float tnear,
            WalkTable table, float* __restrict__ out_t, int* __restrict__ out_slot,
            const long long* __restrict__ ctl) {
  const int limit = ctl == nullptr ? n : (int)min((long long)n, ctl[kCount]);
  if ((long long)blockIdx.x * blockDim.x >= limit) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < limit;
  V3 o = {0.0f, 0.0f, 0.0f}, d = o;
  if (active) {
    o = {ox[i], oy[i], oz[i]};
    d = {dx[i], dy[i], dz[i]};
  }
  float best_t = INFINITY, u, v;
  int best_slot = -1;
  WalkCounts unused;
  brick_walk<false, false>(table, active, o, d, tnear, best_t, best_slot, u, v, unused);
  if (active) {
    out_t[i] = best_t;
    out_slot[i] = best_slot;
  }
}

// out: [16, n] channel-major (coalesced stores); stats: [3, n] when kStats.
template <bool kStats>
__global__ void __launch_bounds__(kBlock)
brick_trace_full(const float* __restrict__ ox, const float* __restrict__ oy,
                 const float* __restrict__ oz, const float* __restrict__ dx,
                 const float* __restrict__ dy, const float* __restrict__ dz, int n,
                 float tnear, const unsigned char* __restrict__ mask,
                 const float* __restrict__ sph_rows, int S, WalkTable table,
                 float* __restrict__ out, int* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n && (mask == nullptr || mask[i]);
  V3 o = {0.0f, 0.0f, 0.0f}, d = o;
  if (active) {
    o = {ox[i], oy[i], oz[i]};
    d = {dx[i], dy[i], dz[i]};
  }
  WalkCounts counts = {0, 0, 0};
  HitRecord rec;
  brick_closest<kStats>(sph_rows, S, table, active, o, d, tnear, rec, counts);
  if (i >= n) return;
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

// Launch B2 on `stream`: `nodes` and `tris` are the set's walk table (16-byte
// aligned), `gates` its sub_boxes.  `ctl`, the fixed-capacity loop's int64
// control block on the card, may be null: with it only the first ctl[kCount]
// of the n columns are traced, and t and slot past them are left as they
// were.  The caller checks that the top tree's depth + 2 is at most kStack.
// Returns cudaGetLastError() (0 on success).
extern "C" int pt_brick_trace_launch(const float* ox, const float* oy, const float* oz,
                                     const float* dx, const float* dy, const float* dz, int n,
                                     float tnear, const void* nodes, const void* tris,
                                     const void* gates, float* out_t, int* out_slot,
                                     const long long* ctl, void* stream) {
  if (n <= 0) return 0;
  const WalkTable table = {(const float4*)nodes, (const float*)tris, (const float4*)gates,
                           nullptr};
  const dim3 grid((unsigned)((n + kBlock - 1) / kBlock));
  brick_trace<<<grid, kBlock, 0, (cudaStream_t)stream>>>(ox, oy, oz, dx, dy, dz, n, tnear,
                                                         table, out_t, out_slot, ctl);
  return (int)cudaGetLastError();
}

// Launch B3 on `stream`: the walk table as for B2, and `brick_data` for the
// winner's record; `active` may be null (every ray traced), `stats` null (no
// counters).  Returns cudaGetLastError() (0 on success).
extern "C" int pt_brick_trace_full_launch(const float* ox, const float* oy, const float* oz,
                                          const float* dx, const float* dy, const float* dz,
                                          int n, float tnear, const unsigned char* active,
                                          const float* sph_rows, int num_spheres,
                                          const void* nodes, const void* tris,
                                          const void* gates, const float* brick_data,
                                          float* out, int* stats, void* stream) {
  if (n <= 0) return 0;
  const WalkTable table = {(const float4*)nodes, (const float*)tris, (const float4*)gates,
                           brick_data};
  const dim3 grid((unsigned)((n + kBlock - 1) / kBlock));
  if (stats != nullptr) {
    brick_trace_full<true><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        ox, oy, oz, dx, dy, dz, n, tnear, active, sph_rows, num_spheres, table, out, stats);
  } else {
    brick_trace_full<false><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        ox, oy, oz, dx, dy, dz, n, tnear, active, sph_rows, num_spheres, table, out, stats);
  }
  return (int)cudaGetLastError();
}
