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
// packet's list in list order, the 16 chunk gates of each brick against the
// ray's own best t (NaN-propagating slab test, as csrc/brick_walk.cuh), and
// behind each passing gate 32 triangle tests with a strict t < best.  A pair
// is skipped when no ray of the block has a best t beyond the pair's entry
// bound, a lower bound of every ray's entry into the brick.
//
// Not carried over from the TPU: its grid runs one step per pair in sequence,
// so a packet's (t, slot) rows carry from pair to pair, in launches of 4096
// pairs inside a while loop.  CUDA blocks run at once, so here the sequential
// dimension is a loop inside the block: one launch per wave, grid = packets x
// slices of 256 rays; a block walks its packet's whole list, each thread
// owning one ray's (t, slot) in registers.  No two blocks write the same ray:
// no race, no atomics, and the near-first order and the tie rule (the first
// triangle in list order wins an equal t) are kept.
//
// What bounds it on the card: the bricks' bytes through shared memory and the
// triangle tests of the passing chunks; an incoherent packet's list holds
// most of the scene's bricks.  What the design does about that: cp.async in
// 16-byte pieces with two slots each for the gate row (512 bytes, the next
// pair's is started before this pair is tested) and for the 32-triangle chunk
// (4,096 bytes = one piece per thread; the next needed chunk of the pair is
// started before this chunk is tested).  Only chunks whose gate some ray of
// the block passes are staged.  All threads read the same triangle from shared
// memory at once (a broadcast, no bank conflicts).  TMA, mbarriers and a
// deeper pipeline across pairs are for later work.  Arithmetic repeats the
// plain version op for op (--fmad=false, no fast math, IEEE division).

#include "brick_walk.cuh"

namespace {

using namespace pt;

constexpr int kBlock = 256;                      // rays (threads) per block
constexpr int kChunkFloats = kSubPrims * kRow;   // 1024 floats = 4096 bytes
constexpr int kGateFloats = kNumSubs * 8;        // 128 floats = 512 bytes
static_assert(kChunkFloats * 4 == kBlock * 16, "one 16-byte piece per thread");

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned smem = (unsigned)__cvta_generic_to_shared(dst);
  const size_t gmem = __cvta_generic_to_global(src);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(smem), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// brk, ent: [P, B] each packet's bricks near first and their entry bounds;
// cnt: [P] how many of a row are pairs.  stats (may be null): pairs seen,
// pairs skipped by the entry bound and chunks staged, summed over blocks.
__global__ void __launch_bounds__(kBlock)
pair_trace(const float* __restrict__ ox, const float* __restrict__ oy,
           const float* __restrict__ oz, const float* __restrict__ dx,
           const float* __restrict__ dy, const float* __restrict__ dz, int n, float tnear,
           int packet_rays, int blocks_per_packet, const int* __restrict__ brk,
           const float* __restrict__ ent, const int* __restrict__ cnt, int num_bricks,
           const float* __restrict__ brick_data, float* __restrict__ out_t,
           int* __restrict__ out_slot, unsigned long long* __restrict__ stats) {
  __shared__ __align__(16) float gates[2][kGateFloats];
  __shared__ __align__(16) float chunk[2][kChunkFloats];
  __shared__ unsigned need;   // the chunks some ray of the block passes

  const int tid = threadIdx.x;
  const int packet = blockIdx.x / blocks_per_packet;
  const int in_packet = (blockIdx.x % blocks_per_packet) * kBlock + tid;
  const long long ray = (long long)packet * packet_rays + in_packet;
  if (ray - tid >= n) return;   // the whole block lies beyond the wave
  const bool live = in_packet < packet_rays && ray < n;

  V3 o = {0.0f, 0.0f, 0.0f}, d = {1.0f, 1.0f, 1.0f};
  if (live) {
    o = {ox[ray], oy[ray], oz[ray]};
    d = {dx[ray], dy[ray], dz[ray]};
  }
  const V3 inv = {1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  float best_t = INFINITY;
  int best_slot = -1;

  const int pairs = cnt[packet];
  const int* my_brk = brk + (size_t)packet * num_bricks;
  const float* my_ent = ent + (size_t)packet * num_bricks;
  unsigned long long skipped = 0, staged = 0;

  auto gate_row = [&](int r) {
    return brick_data + (size_t)my_brk[r] * kBrickFloats + kSubRow;
  };
  // every thread commits a group wherever copies are started, so that the
  // group counts of cp.async.wait_group are the same for all threads
  if (pairs > 0 && tid < kGateFloats / 4) cp_async16(&gates[0][tid * 4], gate_row(0) + tid * 4);
  cp_async_commit();

  for (int r = 0; r < pairs; ++r) {
    // The barrier also ends the previous pair's reads of its gate slot (the
    // next copy's target), of the chunk slots and of `need`.
    const bool proceed = __syncthreads_or(live && best_t > my_ent[r]);
    if (tid == 0) need = 0u;
    // the next pair's gate row flies while this pair is tested
    if (r + 1 < pairs) {
      if (tid < kGateFloats / 4) {
        cp_async16(&gates[(r + 1) & 1][tid * 4], gate_row(r + 1) + tid * 4);
      }
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (!proceed) {
      ++skipped;
      continue;
    }
    __syncthreads();   // this pair's gate row is there, `need` is 0
    const float* g = gates[r & 1];
    unsigned mine = 0u;
    if (live) {
      for (int s = 0; s < kNumSubs; ++s) {
        if (g[s * 8 + 6] > 0.0f && slab_hit(g + s * 8, o, inv, best_t)) mine |= 1u << s;
      }
    }
    mine = __reduce_or_sync(0xffffffffu, mine);
    if ((tid & 31) == 0 && mine) atomicOr(&need, mine);
    __syncthreads();
    unsigned todo = need;
    if (todo == 0u) continue;

    const int brick = my_brk[r];
    const float* blk = brick_data + (size_t)brick * kBrickFloats;
    int slot = 0;
    cp_async16(&chunk[0][tid * 4], blk + (__ffs(todo) - 1) * kChunkFloats + tid * 4);
    cp_async_commit();
    while (todo) {
      const int s = __ffs(todo) - 1;
      todo &= todo - 1u;
      // the pair's next chunk flies while this one is tested
      if (todo) {
        cp_async16(&chunk[slot ^ 1][tid * 4], blk + (__ffs(todo) - 1) * kChunkFloats + tid * 4);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();   // every thread's piece of chunk s is there
      ++staged;
      // the gate against the ray's best t as it is now
      if (live && slab_hit(g + s * 8, o, inv, best_t)) {
        const float* tri = chunk[slot];
        for (int k = 0; k < kSubPrims; ++k) {
          const float* rec = tri + k * kRow;
          float t, u, v;
          if (tri_test(load3(rec + 1), load3(rec + 4), load3(rec + 7), o, d, tnear, best_t, t, u,
                       v) &&
              t < best_t) {
            best_t = t;
            best_slot = brick * kBrickPrims + s * kSubPrims + k;
          }
        }
      }
      __syncthreads();   // done with this slot before it is copied into again
      slot ^= 1;
    }
  }

  if (live) {
    out_t[ray] = best_t;
    out_slot[ray] = best_slot;
  }
  if (stats != nullptr && tid == 0) {
    atomicAdd(stats + 0, (unsigned long long)pairs);
    atomicAdd(stats + 1, skipped);
    atomicAdd(stats + 2, staged);
  }
}

}  // namespace

// Launch B5 on `stream`: n rays in packets of `packet_rays` consecutive rays
// (the last one may be partial), num_packets rows of brk / ent / cnt.  `stats`
// may be null.  Returns cudaGetLastError() (0 on success).
extern "C" int pt_pair_trace_launch(const float* ox, const float* oy, const float* oz,
                                    const float* dx, const float* dy, const float* dz, int n,
                                    float tnear, int packet_rays, int num_packets,
                                    const int* brk, const float* ent, const int* cnt,
                                    int num_bricks, const float* brick_data, float* out_t,
                                    int* out_slot, unsigned long long* stats, void* stream) {
  if (n <= 0 || num_packets <= 0) return 0;
  const int blocks_per_packet = (packet_rays + kBlock - 1) / kBlock;
  const dim3 grid((unsigned)(num_packets * blocks_per_packet));
  pair_trace<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      ox, oy, oz, dx, dy, dz, n, tnear, packet_rays, blocks_per_packet, brk, ent, cnt, num_bricks,
      brick_data, out_t, out_slot, stats);
  return (int)cudaGetLastError();
}
