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
// What bounds it on the card: for a coherent packet (a primary wave) the
// staged coefficients and four sums of ten products per ray and triangle; for
// an incoherent packet (a bounce wave), whose list holds nearly every
// superbrick at entry bound 0, first the visits themselves: 880 a packet, of
// which 0.97 meet no ray at all.  Run as 16 slab tests and 16 block-wide votes
// each, those visits were three quarters of a bounce wave's time (PERF.md).
//
// What the design does about that: a block per packet, a thread per ray,
// (t, slot) and the ten features in registers, and in front of the exact votes
// three cheaper ones that can only say no, so the exact votes, and with them
// t, slot and the counters, stay what they were:
//   * The list is staged 128 entries at a time, one a thread: the superbrick
//     id, the entry bound, and the superbrick's own box with the number of
//     its valid subs (MX2Set.visit_boxes, 32 bytes).  A visit starts from
//     shared memory, not from three dependent global loads.
//   * The walk's end needs no vote: the packet's largest best t is kept in
//     every thread (a block-wide max after each visit that passed the
//     superbrick's vote), and bounds ascend.
//   * One vote on the superbrick's box: every ray tests it at its own best t
//     with a NaN counted as a hit (a containing box has tn no larger and tf
//     no smaller than each sub's, rounding being monotone, and a sub's NaN
//     lies on another plane).  If no ray passes, the visit ends after one slab
//     test and one barrier; it still counts as visited and its valid subs as
//     tested.
//   * One pre-vote for the 16 subs: a ray that passed the superbrick's box
//     tests the 16 sub boxes at its best t on entry (read from global memory
//     through L1: every thread the same address), and the block ORs the
//     16-bit masks.  Best t only falls within a visit, so the exact vote runs
//     only for the subs in the packet's mask, in order, at the current best
//     t, and in it only the rays whose own mask holds the sub test again.
//   * For a sub voted in, only its ten coefficient rows that carry numbers
//     are staged in shared memory (5 KiB; rows 10..15 of a sub's 16 are
//     padding), by plain 16-byte loads: the copy is followed at once by the
//     barrier that waits for it.  The product is computed in float32 on the
//     CUDA cores, four triangles at a time (one 16-byte shared-memory read per
//     feature and quantity, every thread the same address: a broadcast, no
//     bank conflict), each sum in the fixed order k = 0..9.  Hopper's tensor
//     cores have no float32 product, and TF32's 10-bit mantissa would flip
//     edge hits.  After the votes above the product is most of a bounce wave.
//   * The slab tests use the hardware's NaN-propagating min and max
//     (min.NaN.f32), one instruction each, which decide as pt::nan_min and
//     pt::nan_max do.
// Arithmetic repeats the plain version op for op (--fmad=false, no fast math,
// IEEE division).

#include "brick_walk.cuh"

namespace {

using namespace pt;

constexpr int kPacket = 128;                // rays (threads) per block
constexpr int kWarps = kPacket / 32;
constexpr int kStretch = kPacket;           // list entries staged at once: one a thread
constexpr int kSlabRow = 128;               // floats per coefficient row
constexpr int kSubRows = 16;                // rows per sub in the slab
constexpr int kFeatures = 10;               // the rows that carry numbers
constexpr int kSlabFloats = kNumSubs * kSubRows * kSlabRow;   // 256 x 128
constexpr int kBoxVecs = 2;                 // float4 per box record

// min / max that return NaN when either input is NaN, as pt::nan_min and
// pt::nan_max, in one instruction each
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The slab interval (tn, tf) of pt::slab_hit on a box record
// (lo.x lo.y lo.z hi.x | hi.y hi.z - -).
__device__ __forceinline__ void slab_interval(float4 b0, float4 b1, V3 o, V3 inv, float& tn,
                                              float& tf) {
  const float tx0 = (b0.x - o.x) * inv.x;
  const float tx1 = (b0.w - o.x) * inv.x;
  const float ty0 = (b0.y - o.y) * inv.y;
  const float ty1 = (b1.x - o.y) * inv.y;
  const float tz0 = (b0.z - o.z) * inv.z;
  const float tz1 = (b1.y - o.z) * inv.z;
  tn = max_nan(max_nan(min_nan(tx0, tx1), min_nan(ty0, ty1)), min_nan(tz0, tz1));
  tf = min_nan(min_nan(max_nan(tx0, tx1), max_nan(ty0, ty1)), max_nan(tz0, tz1));
}

// pt::slab_hit: the ray meets the box at or after 0 and no later than t_max;
// a NaN (0 * inf on a box plane) is a miss.
__device__ __forceinline__ bool box_hit(float4 b0, float4 b1, V3 o, V3 inv, float t_max) {
  float tn, tf;
  slab_interval(b0, b1, o, inv, tn, tf);
  return (tf >= max_nan(tn, 0.0f)) && (tn <= t_max);
}

// The same test with a NaN counted as a hit: for a box that contains other
// boxes it says yes wherever box_hit says yes for one of them (a containing
// box has tn no larger and tf no smaller, rounding being monotone; the NaN of
// a contained box lies on another plane).
__device__ __forceinline__ bool box_maybe(float4 b0, float4 b1, V3 o, V3 inv, float t_max) {
  float tn, tf;
  slab_interval(b0, b1, o, inv, tn, tf);
  return !(tf < max_nan(tn, 0.0f)) && !(tn > t_max);
}

// brk, ent: [P, B] each packet's superbricks near first and their entry
// bounds; cnt: [P] how many of a row are listed.  sbbox: [B] box records of the
// superbricks, whose float 6 is the number of valid subs; subbox: [B, 16] box
// records of the subs, whose float 6 is the valid flag.  stats (may be null):
// superbricks listed, visited, subs voted in, subs slab-tested (the valid
// subs of the superbricks visited) and visits that ended at the superbrick's
// own box, summed over packets.
__global__ void __launch_bounds__(kPacket)
mx2_trace(const float* __restrict__ ox, const float* __restrict__ oy,
          const float* __restrict__ oz, const float* __restrict__ dx,
          const float* __restrict__ dy, const float* __restrict__ dz, int n, float tnear,
          const float* __restrict__ shift, const int* __restrict__ brk,
          const float* __restrict__ ent, const int* __restrict__ cnt, int num_bricks,
          const float4* __restrict__ sbbox, const float4* __restrict__ subbox,
          const float* __restrict__ coeff, float* __restrict__ out_t,
          int* __restrict__ out_slot, unsigned long long* __restrict__ stats) {
  __shared__ __align__(16) float C[kFeatures][kSlabRow];
  __shared__ float4 s_box[kStretch][kBoxVecs];
  __shared__ float s_ent[kStretch];
  __shared__ int s_brk[kStretch];
  __shared__ unsigned s_word[2][kWarps];   // a warp's word of a block-wide OR or max

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
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
  // the largest best t of the packet's rays: the same in every thread
  float far_t = INFINITY;

  const int listed = cnt[packet];
  const int* my_brk = brk + (size_t)packet * num_bricks;
  const float* my_ent = ent + (size_t)packet * num_bricks;
  unsigned long long visited = 0, voted = 0, tested = 0, boxed_out = 0;
  int flip = 0;

  for (int r = 0; r < listed; ++r) {
    const int e = r % kStretch;
    if (e == 0) {
      // the next stretch of the list with its superbricks' boxes: one entry a
      // thread, the list read as coalesced lines
      __syncthreads();
      if (r + tid < listed) {
        const int b = my_brk[r + tid];
        s_brk[tid] = b;
        s_ent[tid] = my_ent[r + tid];
        s_box[tid][0] = __ldg(sbbox + (size_t)b * kBoxVecs);
        s_box[tid][1] = __ldg(sbbox + (size_t)b * kBoxVecs + 1);
      }
      __syncthreads();
    }
    // bounds ascend and best t only falls: the walk ends here for good
    if (!(far_t > s_ent[e])) break;
    ++visited;
    const float4 sb0 = s_box[e][0], sb1 = s_box[e][1];
    tested += (unsigned long long)sb1.z;
    // One vote on the superbrick's own box before its 16 subs.  The barrier
    // also ends the previous visit's reads of `C`.
    const bool maybe = live && box_maybe(sb0, sb1, o, inv, best_t);
    if (!__syncthreads_or(maybe)) {
      ++boxed_out;
      continue;
    }
    const int brick = s_brk[e];
    const float4* boxes = subbox + (size_t)brick * kNumSubs * kBoxVecs;
    // One pre-vote for the 16 subs at the best t on entry: best t only falls
    // within the visit, so a sub outside a ray's mask cannot pass that ray's
    // exact test later, and a sub outside the packet's mask gets no vote.
    unsigned mine = 0;
    if (maybe) {
#pragma unroll
      for (int s = 0; s < kNumSubs; ++s) {
        const float4 q0 = __ldg(boxes + s * kBoxVecs), q1 = __ldg(boxes + s * kBoxVecs + 1);
        if (q1.z > 0.0f && box_hit(q0, q1, o, inv, best_t)) mine |= 1u << s;
      }
    }
    const unsigned of_warp = __reduce_or_sync(kFullWarp, mine);
    if (lane == 0) s_word[flip][warp] = of_warp;
    __syncthreads();
    unsigned todo = s_word[flip][0] | s_word[flip][1] | s_word[flip][2] | s_word[flip][3];
    flip ^= 1;
    const float* slab = coeff + (size_t)brick * kSlabFloats;
    for (; todo != 0; todo &= todo - 1) {
      const int s = __ffs(todo) - 1;
      bool pass = false;
      if ((mine >> s) & 1u) {
        pass = box_hit(__ldg(boxes + s * kBoxVecs), __ldg(boxes + s * kBoxVecs + 1), o, inv,
                       best_t);
      }
      // The exact vote, at the current best t.  Its barrier also ends the
      // previous sub's reads of `C`.
      if (!__syncthreads_or(pass)) continue;
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
    // the packet's largest best t after this visit (a hit's t is positive,
    // so its bits order as it does)
    const unsigned far_of_warp =
        __reduce_max_sync(kFullWarp, live ? __float_as_uint(best_t) : 0u);
    if (lane == 0) s_word[flip][warp] = far_of_warp;
    __syncthreads();
    far_t = __uint_as_float(max(max(s_word[flip][0], s_word[flip][1]),
                                max(s_word[flip][2], s_word[flip][3])));
    flip ^= 1;
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
    atomicAdd(stats + 4, boxed_out);
  }
}

}  // namespace

// Launch B7 on `stream`: n rays in num_packets packets of 128 consecutive rays
// (the last one may be partial), num_packets rows of brk / ent / cnt; `shift`
// points at the set's three floats on the device; `sbbox` and `subbox` are
// 16-byte aligned.  `stats` (five counters) may be null.
// Returns cudaGetLastError() (0 on success).
extern "C" int pt_mx2_trace_launch(const float* ox, const float* oy, const float* oz,
                                   const float* dx, const float* dy, const float* dz, int n,
                                   float tnear, const float* shift, int num_packets,
                                   const int* brk, const float* ent, const int* cnt,
                                   int num_bricks, const void* sbbox, const void* subbox,
                                   const float* coeff, float* out_t, int* out_slot,
                                   unsigned long long* stats, void* stream) {
  if (n <= 0 || num_packets <= 0) return 0;
  mx2_trace<<<dim3((unsigned)num_packets), kPacket, 0, (cudaStream_t)stream>>>(
      ox, oy, oz, dx, dy, dz, n, tnear, shift, brk, ent, cnt, num_bricks,
      (const float4*)sbbox, (const float4*)subbox, coeff, out_t, out_slot, stats);
  return (int)cudaGetLastError();
}
