// The pair-list brick trace for Hopper (sm_90a), kernel B5: the closest
// triangle (t, slot) of every ray of one wavefront wave, with no tree walk in
// the kernel.  Torch ops (ops/pairtrace.py) cull every packet of rays against
// every brick box and sort each packet's surviving bricks near first; the
// kernel runs each packet's list in order.
//
// It replaces the JAX package's Pallas TPU kernel
// pathtracer_cuda_interactive_tpu/ops/pairtrace.py::_make_pair_kernel (with
// _pair_chunk and the loop of trace_wave_pairs around it).  Its plain version
// is ops/pairtrace.py::trace_pairs_plain.
//
// What it computes, per ray: starting from (inf, -1), over the bricks of its
// packet's list in list order, for each brick whose entry bound lies below
// the ray's best t: the brick's 16 chunk gates in order against the ray's
// current best t (NaN-propagating slab test, as csrc/brick_walk.cuh), and
// behind each passing gate the chunk's 32 triangles, the first with the
// smallest t winning under a strict t < best.  Every decision is the ray's
// own, so (t, slot) do not depend on which rays walk a list together.
//
// Not carried over from the TPU: its grid runs one step per pair in sequence,
// so a packet's (t, slot) rows carry from pair to pair, in launches of 4096
// pairs inside a while loop.  CUDA blocks run at once, so here the sequential
// dimension is a loop inside the kernel: one launch per wave, in which each
// warp of a packet's rays walks the packet's whole list with (t, slot) in
// registers.  No two warps write the same ray: no race, no atomics.
//
// What bounds it on the card: the visits.  An incoherent (bounce) packet's
// list holds nearly every brick at entry bound 0, and most visits meet no
// ray of the group that walks them; paid as 16 gate tests and three block
// barriers each, they took nearly all of a bounce wave's time.  The
// design:
//   * A group is one warp of 32 consecutive rays, which walks the list on its
//     own: no block barrier anywhere.  It reads 32 list entries at a time,
//     coalesced, with each brick's visit box (BrickSet.visit_boxes: the
//     brick's box, 32 bytes), into the warp's own stretch of shared memory,
//     from which every lane reads each entry at once (a broadcast).
//   * The walk ends at the entry bound: bounds ascend and best t only falls,
//     so once no ray of the group has best t beyond the next bound, no later
//     brick can give a nearer hit, and the group stops.
//   * One vote on the brick's own box before its 16 gates: each ray takes one
//     slab test at its best t with a NaN counted as a hit, which says yes
//     wherever some gate of the brick says yes.  If no ray passes, the visit
//     ends there.  A ray that passes computes its 16 gates at its best t on
//     entry; the group ORs the masks, and only the chunks in the OR get the
//     exact gate at the current best t, only from the rays whose own mask
//     holds the chunk.
//   * Gates and triangles come from the set's walk table (the chunk gates as
//     two 16-byte loads, the triangles as nine runs of 32 floats, 17 MB for
//     925 bricks, which stay in the 50 MB L2), not from the 4,096-byte chunk
//     records through shared memory.  The winning slot is still
//     brick * 512 + s * 32 + k.
//   * A chunk that at most 24 rays hold is tested by the warp together,
//     B2's rule (csrc/brick_walk.cuh::warp_chunk_round: lane k tests
//     triangle k, read once for all holders; "smallest t, lowest k" by a
//     min-reduction), one holder's ray at a time; with more holders each tests the 32 triangles itself, all
//     reading the same floats.  Measured on the card against a block of 256
//     rays walking together (block barriers for its votes; 1.6 times
//     slower), the warp always together and each holder always alone (1.8
//     to 2.4 times slower on the bounce wave): PERF.md.
// Arithmetic repeats the plain version op for op (--fmad=false, no fast
// math, IEEE division).

#include "brick_walk.cuh"

namespace {

using namespace pt;

constexpr int kBlock = 128;     // threads per block: four warps that walk alone
constexpr int kEachAbove = 24;  // holders above which each tests a chunk alone

// The triangles of `chunk` against the rays of the warp's lanes where `pass`
// holds: the first triangle with the smallest t strictly below the ray's
// best t wins.  Every lane of the warp calls it.  With at most kEachAbove
// holders the warp tests together (lane k tests triangle k, read once, for
// each holder's ray in turn: B2's rule); with more, each holder tests the 32
// triangles in order itself, every holder reading the same floats (a
// broadcast).
__device__ __forceinline__ void test_chunk(const WalkTable& w, int chunk, bool pass, V3 o, V3 d,
                                           float tnear, float& best_t, int& best_slot) {
  const unsigned holders = __ballot_sync(kFullWarp, pass);
  if (holders == 0) return;
  if (__popc(holders) > kEachAbove) {
    if (pass) {
      for (int k = 0; k < kSubPrims; ++k) {
        const ChunkTri tri = chunk_tri(w, chunk, k);
        float t, u, v;
        if (tri_test(tri.p0, tri.e1, tri.e2, o, d, tnear, best_t, t, u, v) && t < best_t) {
          best_t = t;
          best_slot = chunk * kSubPrims + k;
        }
      }
    }
    return;
  }
  float u, v;   // not kept
  for (unsigned rest = holders; rest != 0; rest &= rest - 1) {
    warp_chunk_round<false>(w, chunk, __ffs(rest) - 1, o, d, tnear, best_t, best_slot, u, v);
  }
}

// brk, ent: [P, B] each packet's bricks near first and their entry bounds;
// cnt: [P] how many of a row are listed; vbox: [B] visit boxes (lo xyz,
// hi xyz, valid chunks, 0).  stats (may be null): pairs listed, pairs
// skipped by the entry bound, chunks tested and visits that ended at the
// brick's own box, summed over warps.
__global__ void __launch_bounds__(kBlock)
pair_trace(const float* __restrict__ ox, const float* __restrict__ oy,
           const float* __restrict__ oz, const float* __restrict__ dx,
           const float* __restrict__ dy, const float* __restrict__ dz, int n, float tnear,
           int packet_rays, int blocks_per_packet, const int* __restrict__ brk,
           const float* __restrict__ ent, const int* __restrict__ cnt, int num_bricks,
           const float4* __restrict__ vbox, WalkTable w, float* __restrict__ out_t,
           int* __restrict__ out_slot, unsigned long long* __restrict__ stats) {
  // one list entry a lane: the brick's box, then (hi.y, hi.z, bound, brick)
  __shared__ float4 s_list[kBlock][2];

  const int lane = threadIdx.x % 32;
  const int packet = blockIdx.x / blocks_per_packet;
  const int in_packet = (blockIdx.x % blocks_per_packet) * kBlock + threadIdx.x;
  const long long ray = (long long)packet * packet_rays + in_packet;
  // a warp wholly beyond its packet or the wave leaves
  const int warp_first = in_packet - lane;
  if (warp_first >= packet_rays || (long long)packet * packet_rays + warp_first >= n) return;
  const bool live = in_packet < packet_rays && ray < n;

  V3 o = {0.0f, 0.0f, 0.0f}, d = {1.0f, 1.0f, 1.0f};
  if (live) {
    o = {ox[ray], oy[ray], oz[ray]};
    d = {dx[ray], dy[ray], dz[ray]};
  }
  const V3 inv = {1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  float best_t = INFINITY;
  int best_slot = -1;

  const int listed = cnt[packet];
  const int* my_brk = brk + (size_t)packet * num_bricks;
  const float* my_ent = ent + (size_t)packet * num_bricks;
  float4(*stretch)[2] = s_list + (threadIdx.x - lane);   // the warp's own 32 entries
  unsigned long long visited = 0, tested = 0, boxed_out = 0;
  bool ended = false;

  for (int base = 0; base < listed && !ended; base += 32) {
    // the next 32 entries of the list with their bricks' boxes: one a lane,
    // the list read as coalesced lines
    __syncwarp();
    if (base + lane < listed) {
      const int b = my_brk[base + lane];
      const float4 q0 = __ldg(vbox + (size_t)b * 2), q1 = __ldg(vbox + (size_t)b * 2 + 1);
      stretch[lane][0] = q0;
      stretch[lane][1] = make_float4(q1.x, q1.y, my_ent[base + lane], __int_as_float(b));
    }
    __syncwarp();
    const int stretch_len = min(32, listed - base);
    for (int e = 0; e < stretch_len; ++e) {
      const float4 e0 = stretch[e][0], e1 = stretch[e][1];
      // bounds ascend and best t only falls: the walk ends here for good
      const bool want = live && best_t > e1.z;
      if (!__any_sync(kFullWarp, want)) {
        ended = true;
        break;
      }
      ++visited;
      // one vote on the brick's own box before its 16 gates
      const bool maybe = want && slab_maybe({e0.x, e0.y, e0.z}, {e0.w, e1.x, e1.y}, o, inv, best_t);
      if (!__any_sync(kFullWarp, maybe)) {
        ++boxed_out;
        continue;
      }
      const int brick = __float_as_int(e1.w);
      const float4* gates = w.gates + (size_t)brick * kNumSubs * 2;
      // the gates at the best t on entry: best t only falls within the
      // visit, so a chunk outside a ray's mask cannot pass its exact gate
      unsigned mine = 0;
      if (maybe) {
#pragma unroll
        for (int s = 0; s < kNumSubs; ++s) {
          const float4 g0 = __ldg(gates + 2 * s), g1 = __ldg(gates + 2 * s + 1);
          if (g1.z > 0.0f && slab_hit({g0.x, g0.y, g0.z}, {g0.w, g1.x, g1.y}, o, inv, best_t)) {
            mine |= 1u << s;
          }
        }
      }
      for (unsigned todo = __reduce_or_sync(kFullWarp, mine); todo != 0; todo &= todo - 1) {
        const int s = __ffs(todo) - 1;
        bool pass = false;
        if ((mine >> s) & 1u) {
          const float4 g0 = __ldg(gates + 2 * s), g1 = __ldg(gates + 2 * s + 1);
          pass = slab_hit({g0.x, g0.y, g0.z}, {g0.w, g1.x, g1.y}, o, inv, best_t);
        }
        if (!__any_sync(kFullWarp, pass)) continue;
        ++tested;
        test_chunk(w, brick * kNumSubs + s, pass, o, d, tnear, best_t, best_slot);
      }
    }
  }

  if (live) {
    out_t[ray] = best_t;
    out_slot[ray] = best_slot;
  }
  if (stats != nullptr && lane == 0) {
    atomicAdd(stats + 0, (unsigned long long)listed);
    atomicAdd(stats + 1, (unsigned long long)listed - visited);
    atomicAdd(stats + 2, tested);
    atomicAdd(stats + 3, boxed_out);
  }
}

}  // namespace

// Launch B5 on `stream`: n rays in packets of `packet_rays` consecutive rays
// (a multiple of 32; the last packet may be partial), num_packets rows of
// brk / ent / cnt; `vbox` the set's visit boxes, `tris` its walk table's
// triangles and `gates` its sub_boxes (each 16-byte aligned).  `stats` (four
// counters) may be null.  Returns cudaGetLastError() (0 on success).
extern "C" int pt_pair_trace_launch(const float* ox, const float* oy, const float* oz,
                                    const float* dx, const float* dy, const float* dz, int n,
                                    float tnear, int packet_rays, int num_packets,
                                    const int* brk, const float* ent, const int* cnt,
                                    int num_bricks, const void* vbox, const void* tris,
                                    const void* gates, float* out_t, int* out_slot,
                                    unsigned long long* stats, void* stream) {
  if (n <= 0 || num_packets <= 0) return 0;
  const WalkTable w = {nullptr, (const float*)tris, (const float4*)gates, nullptr};
  const int blocks_per_packet = (packet_rays + kBlock - 1) / kBlock;
  const dim3 grid((unsigned)(num_packets * blocks_per_packet));
  pair_trace<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      ox, oy, oz, dx, dy, dz, n, tnear, packet_rays, blocks_per_packet, brk, ent, cnt, num_bricks,
      (const float4*)vbox, w, out_t, out_slot, stats);
  return (int)cudaGetLastError();
}
