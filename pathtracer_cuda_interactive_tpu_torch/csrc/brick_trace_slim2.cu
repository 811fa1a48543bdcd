// The pipelined slim brick trace for Hopper (sm_90a), kernel B4: the closest
// triangle (t, slot) of every ray of one wavefront wave, one thread per ray,
// with every leaf deferred by one so that the next leaf's data is in flight
// while this leaf's triangles are tested.
//
// It replaces the JAX package's Pallas TPU kernel
// pathtracer_cuda_interactive_tpu/ops/wavefront.py::_make_trace_kernel_slim2,
// built on ops/brickkernel.py::make_brick_intersect_pipelined.  Its plain
// version is ops/brickkernel.py::trace_bricks_pipelined_plain.
//
// What it computes: exactly brick_trace's (B2's) output.  The walk is B2's
// (csrc/brick_walk.cuh: per-ray stack, nearer child first, NaN-propagating
// slab tests, 16 chunk gates per brick, strict t < best), except that a leaf
// that is found becomes PENDING and is drained (its gates and triangles
// tested) only when the next leaf is found or the stack runs out.  Nodes
// between two leaves are therefore classified against a best t that is one
// leaf stale.  That only admits more nodes and leaves; the chunk gates in the
// drain use the current best t, leaves are drained in the walk's own order
// and the test is a strict t < best, so the winner is B2's, bit for bit.
//
// What bounds it on the card: as B2, dependent global reads along each ray's
// own path, not FP32 work.  What the design does about that: when the walk
// reaches leaf N+1 it starts an asynchronous copy of what the drain reads
// first and depends on, that brick's chunk-gate row (16 gates x 8 floats =
// 512 bytes), and only then drains leaf N, so the copy flies under leaf N's
// triangle tests.  Two variants of the copy, chosen at launch:
//   * staged (the default): cp.async in 16-byte pieces into one of the
//     thread's two 512-byte slots of dynamic shared memory, waited for with
//     cp.async.wait_group just before the drain.  The design is per ray, not
//     per warp (a warp's rays reach different leaves at different steps, so a
//     shared slot would serialize them): each thread owns its slots and reads
//     only what it copied itself, so no block barrier is needed.  Piece q of
//     thread i lies at float4 index q * blockDim.x + i, so a warp's accesses
//     to one piece are consecutive and free of bank conflicts.  2 slots x
//     512 B per thread is 64 KiB for a block of 64 threads, so at most three
//     blocks (192 threads) fit an SM's 227 KB: the staging is paid for in
//     occupancy.
//   * prefetch: prefetch.global.L2 of the gate row's four 128-byte lines, no
//     shared memory, blocks of 128 threads as B2.  It keeps B2's occupancy
//     and shows what the deferred leaf costs or gains without the staging.
// A whole brick (69,632 bytes) cannot be staged per ray.  TMA, mbarriers and
// warp-cooperative chunk staging are for later work.  Arithmetic repeats the
// plain version op for op (--fmad=false, no fast math, IEEE division).

#include "brick_walk.cuh"

namespace {

using namespace pt;

constexpr int kStageBlock = 64;                 // threads per block, staged
constexpr int kPrefetchBlock = 128;             // threads per block, prefetch
constexpr int kGatePieces = kNumSubs * 8 / 4;   // 16-byte pieces per gate row
constexpr int kStageBytes = 2 * kGatePieces * 16 * kStageBlock;   // 64 KiB

__device__ __forceinline__ void cp_async16(float4* dst, const float* src) {
  const unsigned smem = (unsigned)__cvta_generic_to_shared(dst);
  const size_t gmem = __cvta_generic_to_global(src);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(smem), "l"(gmem));
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The deferred-leaf walk.  `stage` is this thread's piece 0 of slot 0 (null
// in the prefetch variant); its piece q lies at stage[q * stride].
template <bool kStage>
__device__ __forceinline__ void brick_walk_pipelined(const Bricks& b, V3 o, V3 d, float tnear,
                                                     float& best_t, int& best_slot,
                                                     float4* stage, int stride) {
  const V3 inv = {1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  int stack[kStack];
  int sp = 0;
  stack[sp++] = 0;
  int pend = -1;    // the pending leaf's brick
  int pslot = 0;    // the slot that holds its gate row
  while (sp > 0 || pend >= 0) {
    const int sp_in = sp;
    int found = -1;
    if (sp > 0) {
      const int node = stack[--sp];
      // best_t does not yet hold the pending leaf's hits: one leaf stale
      if (slab_hit(b.top_boxes + node * 8, o, inv, best_t)) {
        const int brick = b.top_links[node * 2 + 1];
        if (brick >= 0) {
          found = brick;
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
    // start leaf N+1's copy into the free slot BEFORE draining leaf N
    if (found >= 0) {
      const float* row = b.brick_data + (size_t)found * kBrickFloats + kSubRow;
      if constexpr (kStage) {
        float4* dst = stage + (1 - pslot) * kGatePieces * stride;
#pragma unroll
        for (int q = 0; q < kGatePieces; ++q) cp_async16(dst + q * stride, row + q * 4);
        asm volatile("cp.async.commit_group;\n" ::);
      } else {
#pragma unroll
        for (int line = 0; line < kNumSubs * 8; line += 32) {
          asm volatile("prefetch.global.L2 [%0];\n" ::"l"(__cvta_generic_to_global(row + line)));
        }
      }
    }
    if (pend >= 0 && (found >= 0 || sp_in <= 1)) {
      // drain the pending leaf: its own copy must have landed; the one just
      // started may still fly
      if constexpr (kStage) {
        if (found >= 0) {
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
      }
      const float* blk = b.brick_data + (size_t)pend * kBrickFloats;
      for (int s = 0; s < kNumSubs; ++s) {
        float gate[8];
        if constexpr (kStage) {
          const float4* src = stage + (pslot * kGatePieces + 2 * s) * stride;
          const float4 lo = src[0], hi = src[stride];
          gate[0] = lo.x; gate[1] = lo.y; gate[2] = lo.z; gate[3] = lo.w;
          gate[4] = hi.x; gate[5] = hi.y; gate[6] = hi.z; gate[7] = hi.w;
        } else {
          const float4* src = reinterpret_cast<const float4*>(blk + kSubRow + s * 8);
          const float4 lo = src[0], hi = src[1];
          gate[0] = lo.x; gate[1] = lo.y; gate[2] = lo.z; gate[3] = lo.w;
          gate[4] = hi.x; gate[5] = hi.y; gate[6] = hi.z; gate[7] = hi.w;
        }
        if (!(gate[6] > 0.0f) || !slab_hit(gate, o, inv, best_t)) continue;
        for (int k = s * kSubPrims; k < (s + 1) * kSubPrims; ++k) {
          const float* r = blk + k * kRow;
          float t, u, v;
          if (tri_test(load3(r + 1), load3(r + 4), load3(r + 7), o, d, tnear, best_t, t, u, v) &&
              t < best_t) {
            best_t = t;
            best_slot = pend * kBrickPrims + k;
          }
        }
      }
      pend = -1;
    }
    if (found >= 0) {
      pend = found;
      pslot = 1 - pslot;
    }
  }
}

template <bool kStage>
__global__ void __launch_bounds__(kStage ? kStageBlock : kPrefetchBlock)
brick_trace_slim2(const float* __restrict__ ox, const float* __restrict__ oy,
                  const float* __restrict__ oz, const float* __restrict__ dx,
                  const float* __restrict__ dy, const float* __restrict__ dz, int n, float tnear,
                  const float* __restrict__ top_boxes, const int* __restrict__ top_links,
                  const float* __restrict__ brick_data, float* __restrict__ out_t,
                  int* __restrict__ out_slot) {
  extern __shared__ float4 stage_mem[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Bricks b = {top_boxes, top_links, brick_data};
  float best_t = INFINITY;
  int best_slot = -1;
  brick_walk_pipelined<kStage>(b, {ox[i], oy[i], oz[i]}, {dx[i], dy[i], dz[i]}, tnear, best_t,
                               best_slot, kStage ? stage_mem + threadIdx.x : nullptr,
                               blockDim.x);
  out_t[i] = best_t;
  out_slot[i] = best_slot;
}

}  // namespace

// Launch B4 on `stream`; `staged` != 0 takes the cp.async variant, 0 the
// prefetch variant.  The caller checks that the top tree's depth + 2 is at
// most kStack.  Returns the first CUDA error (0 on success).
extern "C" int pt_brick_trace_slim2_launch(const float* ox, const float* oy, const float* oz,
                                           const float* dx, const float* dy, const float* dz,
                                           int n, float tnear, const float* top_boxes,
                                           const int* top_links, const float* brick_data,
                                           float* out_t, int* out_slot, int staged,
                                           void* stream) {
  if (n <= 0) return 0;
  if (staged) {
    const cudaError_t err = cudaFuncSetAttribute(
        brick_trace_slim2<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, kStageBytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((n + kStageBlock - 1) / kStageBlock));
    brick_trace_slim2<true><<<grid, kStageBlock, kStageBytes, (cudaStream_t)stream>>>(
        ox, oy, oz, dx, dy, dz, n, tnear, top_boxes, top_links, brick_data, out_t, out_slot);
  } else {
    const dim3 grid((unsigned)((n + kPrefetchBlock - 1) / kPrefetchBlock));
    brick_trace_slim2<false><<<grid, kPrefetchBlock, 0, (cudaStream_t)stream>>>(
        ox, oy, oz, dx, dy, dz, n, tnear, top_boxes, top_links, brick_data, out_t, out_slot);
  }
  return (int)cudaGetLastError();
}
