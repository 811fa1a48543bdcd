// The pipelined slim brick trace for Hopper (sm_90a), kernel B4: the closest
// triangle (t, slot) of every ray of one wavefront wave, one thread per ray,
// with every leaf deferred by one (on the TPU, so that the next leaf's data
// is copied in while this leaf's triangles are tested).
//
// It replaces the JAX package's Pallas TPU kernel
// pathtracer_cuda_interactive_tpu/ops/wavefront.py::_make_trace_kernel_slim2,
// built on ops/brickkernel.py::make_brick_intersect_pipelined.  Its plain
// version is ops/brickkernel.py::trace_bricks_pipelined_plain.
//
// What it computes: exactly brick_trace's (B2's) output.  The walk is B2's
// (csrc/brick_walk.cuh: per-ray stack, nearer child first, NaN-propagating
// slab tests, 16 chunk gates per brick, strict t < best), except that a leaf
// that is found becomes PENDING and is entered (its gates and triangles
// tested) only when the next leaf is found or the stack is about to run
// out.  Nodes between two leaves are therefore classified against a best t
// that is one leaf stale.  That only admits more nodes and leaves; the chunk
// gates use the current best t, leaves are entered in the walk's own order
// and the test is a strict t < best, so the winner is B2's, bit for bit.
//
// What bounds it on the card: as B2, the latency of dependent reads along
// each ray's own path and the divergence of a warp's walks, not bytes or
// FP32 work.  The design is B2's walk with the deferral on top
// (brick_walk<..., kDefer = true>): it reads the set's WalkTable (one
// 64-byte record a node; triangles as nine runs of 32 floats, 17 MB for 925
// bricks, which stay in the 50 MB L2), its lanes meet before the node, gate
// and triangle phases, and the warp tests each held chunk together.  Nothing
// is fetched ahead: with the table in L2, putting the found leaf's gate run
// on its way before the pending leaf is entered (prefetch.global.L1 of its
// four lines, or its first gate loaded into registers) measured 1-3% and
// 22-34% slower than the deferral alone, and a per-thread cp.async copy of
// the gate row into shared memory (64 KiB a block of 64 threads) cost
// occupancy (PERF.md).  Arithmetic repeats the plain version op for op
// (--fmad=false, no fast math, IEEE division).

#include "brick_walk.cuh"

namespace {

using namespace pt;

constexpr int kBlock = 128;   // threads per block

__global__ void __launch_bounds__(kBlock)
brick_trace_slim2(const float* __restrict__ ox, const float* __restrict__ oy,
                  const float* __restrict__ oz, const float* __restrict__ dx,
                  const float* __restrict__ dy, const float* __restrict__ dz, int n, float tnear,
                  WalkTable table, float* __restrict__ out_t, int* __restrict__ out_slot) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n;
  V3 o = {0.0f, 0.0f, 0.0f}, d = o;
  if (active) {
    o = {ox[i], oy[i], oz[i]};
    d = {dx[i], dy[i], dz[i]};
  }
  float best_t = INFINITY, u, v;
  int best_slot = -1;
  WalkCounts unused;
  brick_walk<false, false, true>(table, active, o, d, tnear, best_t, best_slot, u, v, unused);
  if (active) {
    out_t[i] = best_t;
    out_slot[i] = best_slot;
  }
}

}  // namespace

// Launch B4 on `stream`: `nodes` and `tris` are the set's walk table (16-byte
// aligned), `gates` its sub_boxes.  The caller checks that the top tree's
// depth + 2 is at most kStack.  Returns cudaGetLastError() (0 on success).
extern "C" int pt_brick_trace_slim2_launch(const float* ox, const float* oy, const float* oz,
                                           const float* dx, const float* dy, const float* dz,
                                           int n, float tnear, const void* nodes,
                                           const void* tris, const void* gates, float* out_t,
                                           int* out_slot, void* stream) {
  if (n <= 0) return 0;
  const WalkTable table = {(const float4*)nodes, (const float*)tris, (const float4*)gates,
                           nullptr};
  const dim3 grid((unsigned)((n + kBlock - 1) / kBlock));
  brick_trace_slim2<<<grid, kBlock, 0, (cudaStream_t)stream>>>(ox, oy, oz, dx, dy, dz, n, tnear,
                                                               table, out_t, out_slot);
  return (int)cudaGetLastError();
}
