// The superbrick packet trace for Hopper (sm_90a), kernel B7: the closest
// triangle (t, slot) of every ray of one wavefront wave over the superbricks
// of an MX2Set (experiments/mx2set.py), with the ray/triangle test written as
// a product of Plucker coefficients with ray features.  Torch ops
// (ops/pairtrace.py::visit_lists) cull every packet of 128 rays against every
// superbrick box and sort each packet's surviving superbricks near first; the
// kernel runs each packet's list in order.
//
// It replaces the JAX package's Pallas TPU kernel
// pathtracer_cuda_interactive_tpu/experiments/mx2.py::_make_mx2_kernel
// (launched by _trace_kernel_mx2).  Its plain version is
// experiments/mx2.py::trace_mx2_plain.
//
// What it computes, per packet: starting from (inf, -1) on every ray, over the
// superbricks of the list in list order, for each of the superbrick's 16
// sub-bricks in order: the packet votes the sub in when its valid flag is set
// and some ray's slab test against the sub's box passes at the ray's own best
// t (NaN-propagating min/max, as csrc/brick_walk.cuh); for a sub voted in,
// every ray takes out[row] = sum over k = 0..9 of coeff[k][row] * feature[k],
// rows = det | u*det | v*det | t*det of the sub's 32 triangles, features =
// [o - shift, d, (o - shift) x d, 1]; a triangle is a hit when det != 0, u*det
// and v*det have det's sign or are 0, |u*det| + |v*det| <= |det| and t =
// t*det / det lies in (tnear, best); the lowest triangle among equal minima
// wins inside a sub, and a strict t < best decides across subs and
// superbricks, so the first visited wins a tie.  The walk ends when no ray's
// best t lies beyond the next superbrick's entry bound (bounds ascend).
//
// Not carried over from the TPU: eight packets per grid step and lists
// double-buffered across grid steps (its sublane tiling and its sequential
// grid), lists padded to a multiple of 128 bricks (its scalar memory; here a
// count per packet), two whole-slab buffers of 128 KiB each (they do not fit a
// block's 227 KB of shared memory), and the decision to fetch visit r + 1
// from the best t before visit r, which keeps no copy in flight there: here
// the block votes with the best t after visit r, visits no more superbricks
// and gets the same (t, slot), a superfluous visit being a no-op.
//
// The design: a block per packet, a thread per ray, (t, slot) and the ten
// features in registers.  Shared memory holds the superbrick's 512-byte row of
// sub boxes and, for a sub voted in, only its ten coefficient rows that carry
// numbers (5 KiB; rows 10..15 of a sub's 16 are padding).  They are staged by
// plain 16-byte loads, not cp.async: a copy is followed at once by the barrier
// that waits for it, so there is nothing to overlap within a block, and with
// 5.6 KiB and 128 threads a block many blocks share an SM and hide each
// other's loads.  The product is computed here in float32 on the CUDA cores,
// four triangles at a time (one 16-byte shared-memory read per feature and
// quantity, every thread the same address: a broadcast, no bank conflict),
// each sum in the fixed order k = 0..9.  Hopper's tensor cores have no float32
// product, and TF32's 10-bit mantissa would flip edge hits.
//
// What bounds it on the card: for a coherent packet the staged coefficients
// and four sums of ten products per ray and triangle; for an incoherent
// packet, whose list holds nearly every superbrick at entry bound 0, a slab
// test per ray and valid sub of every listed superbrick.  Arithmetic repeats the plain version op for op
// (--fmad=false, no fast math, IEEE division).

#include "brick_walk.cuh"

namespace {

using namespace pt;

constexpr int kPacket = 128;                // rays (threads) per block
constexpr int kSlabRow = 128;               // floats per coefficient row
constexpr int kSubRows = 16;                // rows per sub in the slab
constexpr int kFeatures = 10;               // the rows that carry numbers
constexpr int kSlabFloats = kNumSubs * kSubRows * kSlabRow;   // 256 x 128
constexpr int kBoxFloats = kNumSubs * 8;    // 128 floats = 512 bytes
static_assert(kBoxFloats == kPacket, "one sub-box float per thread");

// brk, ent: [P, B] each packet's superbricks near first and their entry
// bounds; cnt: [P] how many of a row are listed.  stats (may be null):
// superbricks listed, visited, subs voted in, and subs slab-tested (the valid
// subs of the superbricks visited), summed over packets.
__global__ void __launch_bounds__(kPacket)
mx2_trace(const float* __restrict__ ox, const float* __restrict__ oy,
          const float* __restrict__ oz, const float* __restrict__ dx,
          const float* __restrict__ dy, const float* __restrict__ dz, int n, float tnear,
          const float* __restrict__ shift, const int* __restrict__ brk,
          const float* __restrict__ ent, const int* __restrict__ cnt, int num_bricks,
          const float* __restrict__ subbox, const float* __restrict__ coeff,
          float* __restrict__ out_t, int* __restrict__ out_slot,
          unsigned long long* __restrict__ stats) {
  __shared__ __align__(16) float boxes[kBoxFloats];
  __shared__ __align__(16) float C[kFeatures][kSlabRow];

  const int tid = threadIdx.x;
  const int packet = blockIdx.x;
  const long long ray = (long long)packet * kPacket + tid;
  const bool live = ray < n;

  V3 o = {0.0f, 0.0f, 0.0f}, d = {1.0f, 1.0f, 1.0f};
  if (live) {
    o = {ox[ray], oy[ray], oz[ray]};
    d = {dx[ray], dy[ray], dz[ray]};
  }
  const V3 inv = {1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  const V3 os = {o.x - shift[0], o.y - shift[1], o.z - shift[2]};
  const float f[kFeatures] = {os.x, os.y, os.z, d.x, d.y, d.z,
                              os.y * d.z - os.z * d.y, os.z * d.x - os.x * d.z,
                              os.x * d.y - os.y * d.x, 1.0f};
  float best_t = INFINITY;
  int best_slot = -1;

  const int listed = cnt[packet];
  const int* my_brk = brk + (size_t)packet * num_bricks;
  const float* my_ent = ent + (size_t)packet * num_bricks;
  unsigned long long visited = 0, voted = 0, tested = 0;

  for (int r = 0; r < listed; ++r) {
    // The barrier also ends the previous visit's reads of `boxes` and `C`.
    if (!__syncthreads_or(live && best_t > my_ent[r])) break;
    ++visited;
    const int brick = my_brk[r];
    boxes[tid] = subbox[(size_t)brick * kBoxFloats + tid];
    __syncthreads();
    const float* slab = coeff + (size_t)brick * kSlabFloats;
    for (int s = 0; s < kNumSubs; ++s) {
      const float* box = boxes + s * 8;
      if (!(box[6] > 0.0f)) continue;   // the same for every thread
      ++tested;
      // The vote's barrier also ends the previous sub's reads of `C`.
      if (!__syncthreads_or(live && slab_hit(box, o, inv, best_t))) continue;
      ++voted;
      const float4* rows = reinterpret_cast<const float4*>(slab + s * kSubRows * kSlabRow);
      float4* staged = reinterpret_cast<float4*>(&C[0][0]);
      for (int i = tid; i < kFeatures * kSlabRow / 4; i += kPacket) staged[i] = __ldg(rows + i);
      __syncthreads();
      if (!live) continue;
      for (int j0 = 0; j0 < kSubPrims; j0 += 4) {
        // acc[q][i]: quantity q (det, u*det, v*det, t*det) of triangle j0 + i
        float acc[4][4];
#pragma unroll
        for (int k = 0; k < kFeatures; ++k) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 c = *reinterpret_cast<const float4*>(&C[k][q * kSubPrims + j0]);
            if (k == 0) {
              acc[q][0] = c.x * f[0];
              acc[q][1] = c.y * f[0];
              acc[q][2] = c.z * f[0];
              acc[q][3] = c.w * f[0];
            } else {
              acc[q][0] = acc[q][0] + c.x * f[k];
              acc[q][1] = acc[q][1] + c.y * f[k];
              acc[q][2] = acc[q][2] + c.z * f[k];
              acc[q][3] = acc[q][3] + c.w * f[k];
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float det = acc[0][i];
          const float sg = (float)(det > 0.0f) - (float)(det < 0.0f);
          const float su = acc[1][i] * sg, sv = acc[2][i] * sg, sd = det * sg;
          const float tt = acc[3][i] / (det == 0.0f ? 1.0f : det);
          if (det != 0.0f && su >= 0.0f && sv >= 0.0f && su + sv <= sd && tt > tnear &&
              tt < best_t) {
            best_t = tt;
            best_slot = brick * kBrickPrims + s * kSubPrims + j0 + i;
          }
        }
      }
    }
  }

  if (live) {
    out_t[ray] = best_t;
    out_slot[ray] = best_slot;
  }
  if (stats != nullptr && tid == 0) {
    atomicAdd(stats + 0, (unsigned long long)listed);
    atomicAdd(stats + 1, visited);
    atomicAdd(stats + 2, voted);
    atomicAdd(stats + 3, tested);
  }
}

}  // namespace

// Launch B7 on `stream`: n rays in num_packets packets of 128 consecutive rays
// (the last one may be partial), num_packets rows of brk / ent / cnt; `shift`
// points at the set's three floats on the device.  `stats` may be null.
// Returns cudaGetLastError() (0 on success).
extern "C" int pt_mx2_trace_launch(const float* ox, const float* oy, const float* oz,
                                   const float* dx, const float* dy, const float* dz, int n,
                                   float tnear, const float* shift, int num_packets,
                                   const int* brk, const float* ent, const int* cnt,
                                   int num_bricks, const float* subbox, const float* coeff,
                                   float* out_t, int* out_slot, unsigned long long* stats,
                                   void* stream) {
  if (n <= 0 || num_packets <= 0) return 0;
  mx2_trace<<<dim3((unsigned)num_packets), kPacket, 0, (cudaStream_t)stream>>>(
      ox, oy, oz, dx, dy, dz, n, tnear, shift, brk, ent, cnt, num_bricks, subbox, coeff, out_t,
      out_slot, stats);
  return (int)cudaGetLastError();
}
