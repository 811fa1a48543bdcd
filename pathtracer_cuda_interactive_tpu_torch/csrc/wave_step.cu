// The wavefront's bounce step for Hopper (sm_90a): the device code around
// each wave's trace, one thread per ray.
//
// The JAX package runs its wave loop as one jit program
// (pathtracer_cuda_interactive_tpu/ops/wavefront.py::_render_wavefront), and
// XLA fuses what surrounds the Pallas trace into a few device kernels.  These
// kernels are that code, written by hand; their plain versions are the torch
// functions of ops/wave_step.py:
//
// * wave_record (W1) replaces _record_from_slots (:249): per ray the winning
//   triangle's 32-float record by slot (slot 0's on a miss), the
//   Moller-Trumbore re-solve of (u, v), the triangle's record, then the S
//   resident spheres folded in by a strict ts < t, as the 16-channel record
//   [16, n].  Plain version: ops/wave_step.py::record_plain.
// * wave_shadow_rays (W2's first half, with point lights only) replaces the
//   light directions of _nee_term (:434): per ray and light the unit
//   direction from the hit to the light, [L, 3, n], the shadow rays the trace
//   engine takes.  Plain version: shadow_rays_plain.
// * wave_shade (W2) replaces _nee_term's sum and _shade (:469) and the
//   segment_sum's input: with lights, the shadow waves' t with the spheres
//   folded in and the point-light term; the background on a miss, front-face
//   emission, three BSDF draws, sample and evaluate, the throughput, one
//   roulette draw and roulette past rr_start_depth, the depth cap; then the
//   radiance of every ray whose path ended written to its own place
//   out[samp, pix] (one address per ray: no atomics, and the image's sum over
//   samples stays deterministic).  It writes the shaded rays to a new ray
//   table, so the wave's own rows stay as the trace saw them.  Plain version:
//   shade_plain.
// * wave_sort_key (W3) replaces _sort_key (:354) and _sig_key (:375): the
//   int32 "mort_oct" or "sig_mort" key, or 0 for "none", and INT32_MAX for a
//   ray that is no longer live, so that one stable sort orders the next wave
//   and sinks the ended rays to the tail.  Plain version: sort_key_plain.
// * wave_drain (the fixed-capacity loop's sparse tail; the JAX package has
//   none) carries every live path of the carried table to its end in one
//   launch: each level B2's walk (csrc/brick_walk.cuh) and the same per-ray
//   code as W1 and W2 (record_hit, shade_hit, write_radiance), so a path
//   does the arithmetic of the waves it replaces in the same order and the
//   frame is theirs bit for bit.  Plain version: drain_plain.
//
// The ray table (ops/wave_step.py) is float32 [16, n], one contiguous row a
// column: origin (3), direction (3), throughput (3), radiance (3), the PCG
// state, pixel and sample as int32 bits, and the live flag (1 or 0).
//
// The fixed-capacity wave loop (ops/wavefront.py::WaveCache) launches W1-W3
// over a table of n columns, of which only a prefix holds the wave's rays,
// and keeps its counts on the card, in an int64 control block `ctl`: the
// wave's live count and depth are read there (a thread at or past the count
// returns at once, or keys to INT32_MAX), W3 adds the next wave's live count
// to it, and wave_tally moves the counts on from one wave to the next.  So
// no wave needs a host read, and groups of waves replay as CUDA graphs.  A
// null `ctl` is the live-prefix loop: every column a ray, `depth` as given.
// Once the live count fits in a group's worth of rounds of the lanes the
// card holds at once, or the next group would run past the roulette's start
// (ops/wavefront.py::_drains), the loop replays the drain instead of the
// next group: the drain's lanes walk a level a round, as a wave does,
// without the group's sorts, gathers and class-wide launches.
//
// What bounds them on the card: bytes.  Each reads and writes a few rows of
// 4 bytes per ray and does a few hundred operations at most (W3's "sig_mort"
// tests 16 boxes); at the 614,400 rays of a 640x480, 2-sample wave W1 and W2
// move about 100 and 130 bytes a ray.  What the design does about it: one
// thread a ray, coalesced row reads and writes (ray i at offset i of every
// row), the sphere table and lights read through the cache as broadcasts, and
// each kernel in one launch for the whole wave.  W1's gather of the winner's
// 128-byte record is the one scattered read.  The drain is bound as B2 is,
// by its walks' dependent reads; its lanes stay resident and take the next
// path when theirs ends, so a warp waits for no other warp's longest path.
// Arithmetic repeats the plain version op for op (--fmad=false, no fast
// math, IEEE sqrtf and division).

#include <cstdint>

#include "bounce.cuh"
#include "brick_walk.cuh"

namespace {

using namespace pt;

constexpr int kBlock = 256;   // threads per block
constexpr int kRecord = 16;   // channels of the hit record

// rows of the ray table (ops/wave_step.py)
constexpr int kOrg = 0, kDir = 3, kThroughput = 6, kRadiance = 9, kState = 12, kPix = 13,
              kSamp = 14, kLive = 15;

// what _nee_term multiplies the light's distance by before it compares it
// with the shadow ray's t: the float32 nearest 1 - 1e-3
constexpr float kShadowScale = (float)(1.0 - 1e-3);

// sort keys (ops/wave_step.py::SORT_MODES)
constexpr int kSigMort = 0, kMortOct = 1, kNone = 2;

// the control block's slots (ops/wave_step.py::COUNT .. RAYS): the live
// rays at the head of the wave's table, the next wave's live count being
// summed, the columns the last wave wrote, the depth, and the waves and rays
// traced so far
constexpr int kCount = 0, kNext = 1, kValid = 2, kDepth = 3, kWaves = 4, kRays = 5;
// the drain's slots: the next column of the carried table no lane has taken,
// and the most levels a drained path ran
constexpr int kCursor = 6, kLevels = 7;

constexpr int kDrainBlock = 128;   // threads per block of the drain, as B2's

// the columns of an n-column table that hold the wave's rays
__device__ __forceinline__ int live_limit(const long long* ctl, int n) {
  return ctl == nullptr ? n : (int)min((long long)n, ctl[kCount]);
}

__device__ __forceinline__ V3 row3(const float* rows, size_t n, int r, int i) {
  return {rows[r * n + i], rows[(r + 1) * n + i], rows[(r + 2) * n + i]};
}

__device__ __forceinline__ void put3(float* rows, size_t n, int r, int i, V3 v) {
  rows[r * n + i] = v.x;
  rows[(r + 1) * n + i] = v.y;
  rows[(r + 2) * n + i] = v.z;
}

__device__ __forceinline__ HitRecord load_record(const float* rec, size_t n, int i) {
  HitRecord h;
  h.t = rec[i];
  h.ns = row3(rec, n, 1, i);
  h.pos = row3(rec, n, 4, i);
  h.mtype = rec[7 * n + i];
  h.albedo = row3(rec, n, 8, i);
  h.mparam = rec[11 * n + i];
  h.emission = row3(rec, n, 12, i);
  h.emit = rec[15 * n + i];
  return h;
}

// _nee_term's light direction: the unit vector from pos to the light, with
// the squared distance and the distance
__device__ __forceinline__ V3 light_dir(const float* light, V3 pos, float& dist2, float& dist) {
  const V3 d = {light[0] - pos.x, light[1] - pos.y, light[2] - pos.z};
  dist2 = dot(d, d);
  dist = sqrtf(dist2);
  return scale(d, 1.0f / fmaxf(dist, 1e-20f));
}

// W1's per ray: the 16-channel record of the ray (org, dir) whose trace gave
// (t, slot), slot -1 on a miss.  The winner's 32-float record by slot (slot
// 0's on a miss), the Moller-Trumbore re-solve of (u, v), then the S resident
// spheres folded in by a strict ts < t, so a triangle wins an equal-t tie.
__device__ __forceinline__ HitRecord record_hit(V3 org, V3 dir, float t, int slot, float tnear,
                                                const float* brick_data, const float* sph_rows,
                                                int S) {
  const float* r = slot_row(brick_data, slot > 0 ? slot : 0);
  // _solve_uv: one Moller-Trumbore solve, 0 / 1 where the ray is parallel
  const V3 p0 = load3(r + 1);
  const V3 e1 = load3(r + 4);
  const V3 e2 = load3(r + 7);
  const V3 pv = cross(dir, e2);
  const float det = dot(e1, pv);
  const float det_s = det == 0.0f ? 1.0f : det;
  const V3 tvec = sub(org, p0);
  const float u = dot(tvec, pv) / det_s;
  const V3 qv = cross(tvec, e1);
  const float v = dot(dir, qv) / det_s;
  HitRecord h = triangle_record(r, slot >= 0 ? t : INFINITY, u, v);
  for (int j = 0; j < S; ++j) {
    const float* sr = sph_rows + (size_t)j * kRow;
    float ts;
    if (sphere_test(load3(sr + 1), sr[4], org, dir, tnear, h.t, ts) && ts < h.t) {
      h = sphere_record(sr, org, dir, ts);
    }
  }
  return h;
}

// W2's per ray after the light term: the background on a miss (with the four
// draws _shade makes for every ray), else the bounce of csrc/bounce.cuh and
// the depth cap.  Returns whether the path goes on.
__device__ __forceinline__ bool shade_hit(const HitRecord& h, const float* bg, uint32_t& state,
                                          V3& org, V3& dir, V3& T, V3& L, int depth,
                                          int rr_start_depth, int max_depth) {
  if (h.t == INFINITY) {
    L = add(L, mul(T, load3(bg)));
    for (int k = 0; k < 4; ++k) next_uniform(state);
    return false;
  }
  return bounce(h, state, org, dir, T, L, depth, rr_start_depth) && depth + 1 < max_depth;
}

// W2's write of a path that ended: its radiance to its own place out[samp,
// pix], one address a path (no atomics)
__device__ __forceinline__ void write_radiance(float* out, int num_pixels, int samp, int pix,
                                               V3 L) {
  float* o = out + ((size_t)samp * num_pixels + pix) * 3;
  o[0] = L.x;
  o[1] = L.y;
  o[2] = L.z;
}

__global__ void __launch_bounds__(kBlock)
wave_record(const float* __restrict__ ox, const float* __restrict__ oy,
            const float* __restrict__ oz, const float* __restrict__ dx,
            const float* __restrict__ dy, const float* __restrict__ dz,
            const float* __restrict__ t_in, const int* __restrict__ slot_in, int n, float tnear,
            const float* __restrict__ brick_data, const float* __restrict__ sph_rows, int S,
            float* __restrict__ out, const long long* __restrict__ ctl) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= live_limit(ctl, n)) return;
  const HitRecord h = record_hit({ox[i], oy[i], oz[i]}, {dx[i], dy[i], dz[i]}, t_in[i],
                                 slot_in[i], tnear, brick_data, sph_rows, S);
  const float ch[kRecord] = {h.t,        h.ns.x,     h.ns.y,     h.ns.z,
                             h.pos.x,    h.pos.y,    h.pos.z,    h.mtype,
                             h.albedo.x, h.albedo.y, h.albedo.z, h.mparam,
                             h.emission.x, h.emission.y, h.emission.z, h.emit};
#pragma unroll
  for (int c = 0; c < kRecord; ++c) out[(size_t)c * n + i] = ch[c];
}

__global__ void __launch_bounds__(kBlock)
wave_shadow_rays(const float* __restrict__ rec, int n, const float* __restrict__ lights,
                 int num_lights, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const V3 pos = row3(rec, n, 4, i);
  for (int l = 0; l < num_lights; ++l) {
    float dist2, dist;
    put3(out, n, 3 * l, i, light_dir(lights + 6 * l, pos, dist2, dist));
  }
}

__global__ void __launch_bounds__(kBlock)
wave_shade(const float* __restrict__ table, float* __restrict__ next, size_t next_stride,
           const float* __restrict__ rec, int n,
           const float* __restrict__ shadow_t, const float* __restrict__ lights, int num_lights,
           const float* __restrict__ sph_rows, int S, const float* __restrict__ bg, int depth,
           int rr_start_depth, int max_depth, float* __restrict__ out, int num_pixels,
           const long long* __restrict__ ctl) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= live_limit(ctl, n)) return;
  if (ctl != nullptr) depth = (int)ctl[kDepth];
  V3 org = row3(table, n, kOrg, i);
  V3 dir = row3(table, n, kDir, i);
  V3 T = row3(table, n, kThroughput, i);
  V3 L = row3(table, n, kRadiance, i);
  uint32_t state = __float_as_uint(table[kState * (size_t)n + i]);
  const HitRecord h = load_record(rec, n, i);

  if (num_lights > 0) {
    // _nee_term: the lights' sum, added to L before the bounce
    V3 direct = {0.0f, 0.0f, 0.0f};
    if (h.t < INFINITY) {
      const Material mat = record_to_material(h);
      const V3 ns = normalize(h.ns);
      const V3 wi = neg(dir);
      const V3 nf = dot(wi, ns) < 0.0f ? neg(ns) : ns;
      for (int l = 0; l < num_lights; ++l) {
        const float* light = lights + 6 * l;
        float dist2, dist;
        const V3 wo = light_dir(light, h.pos, dist2, dist);
        float pdf;
        const V3 value = eval_brdf(mat, nf, wi, wo, pdf);
        // _sphere_tmin: the resident spheres folded into the shadow wave's t
        float ts = shadow_t[(size_t)l * n + i];
        for (int j = 0; j < S; ++j) {
          const float* sr = sph_rows + (size_t)j * kRow;
          float tj;
          if (sphere_test(load3(sr + 1), sr[4], h.pos, wo, kSecondaryTnear, ts, tj) && tj < ts) {
            ts = tj;
          }
        }
        if (!(ts < dist * kShadowScale)) {
          direct = add(direct, scale(mul(mul(T, value), load3(light + 3)),
                                     1.0f / fmaxf(dist2, 1e-20f)));
        }
      }
    }
    L = add(L, direct);
  }

  const bool live = shade_hit(h, bg, state, org, dir, T, L, depth, rr_start_depth, max_depth);

  const float pix_bits = table[kPix * (size_t)n + i];
  const float samp_bits = table[kSamp * (size_t)n + i];
  put3(next, next_stride, kOrg, i, org);
  put3(next, next_stride, kDir, i, dir);
  put3(next, next_stride, kThroughput, i, T);
  put3(next, next_stride, kRadiance, i, L);
  next[kState * next_stride + i] = __uint_as_float(state);
  next[kPix * next_stride + i] = pix_bits;
  next[kSamp * next_stride + i] = samp_bits;
  next[kLive * next_stride + i] = live ? 1.0f : 0.0f;
  if (!live) write_radiance(out, num_pixels, __float_as_int(samp_bits), __float_as_int(pix_bits), L);
}

// ops/wave_step.py::_spread3: the low 10 bits of x, two zero bits after each
__device__ __forceinline__ int spread3(int x) {
  x &= 0x3FF;
  x = (x | (x << 16)) & 0x030000FF;
  x = (x | (x << 8)) & 0x0300F00F;
  x = (x | (x << 4)) & 0x030C30C3;
  x = (x | (x << 2)) & 0x09249249;
  return x;
}

// ops/wave_step.py::_morton: the origin's Morton code at `top` + 1 cells an
// axis of the scene box
__device__ __forceinline__ int morton(V3 o, const float* lo, const float* inv, float top) {
  const float q[3] = {(o.x - lo[0]) * inv[0] * top, (o.y - lo[1]) * inv[1] * top,
                      (o.z - lo[2]) * inv[2] * top};
  int m[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) m[a] = spread3((int)nan_min(nan_max(q[a], 0.0f), top));
  return (m[0] << 2) | (m[1] << 1) | m[2];
}

__global__ void __launch_bounds__(kBlock)
wave_sort_key(const float* __restrict__ ox, const float* __restrict__ oy,
              const float* __restrict__ oz, const float* __restrict__ dx,
              const float* __restrict__ dy, const float* __restrict__ dz,
              const float* __restrict__ live, int n, int mode, const float* __restrict__ lo,
              const float* __restrict__ inv_extent, const float* __restrict__ coarse, int K,
              int* __restrict__ out, long long* __restrict__ ctl) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // a column at or past the wave's rays keys to INT32_MAX, whatever it holds
  const bool is_live = i < live_limit(ctl, n) && live[i] > 0.0f;
  int key;
  if (!is_live) {
    key = INT32_MAX;
  } else if (mode == kNone) {
    key = 0;
  } else if (mode == kMortOct) {
    const int octant = (dx[i] > 0.0f) * 4 + (dy[i] > 0.0f) * 2 + (dz[i] > 0.0f);
    key = (morton({ox[i], oy[i], oz[i]}, lo, inv_extent, 127.0f) << 3) | octant;
  } else {  // kSigMort
    const V3 o = {ox[i], oy[i], oz[i]};
    const V3 inv = {1.0f / dx[i], 1.0f / dy[i], 1.0f / dz[i]};
    int sig = 0;
    for (int k = 0; k < K; ++k) {
      const float* c = coarse + 8 * k;
      float tn, tf;
      slab_interval(load3(c), load3(c + 3), o, inv, tn, tf);
      if (tf >= nan_max(tn, 0.0f) && c[6] > 0.0f) sig |= 1 << k;
    }
    const int mb = min(7, (30 - K) / 3);
    key = (sig << (3 * mb)) | morton(o, lo, inv_extent, (float)((1 << mb) - 1));
  }
  if (i < n) out[i] = key;
  if (ctl != nullptr) {
    // the next wave's live count: one atomic a block
    const int block_live = __syncthreads_count(is_live);
    if (threadIdx.x == 0 && block_live > 0) {
      atomicAdd((unsigned long long*)(ctl + kNext), (unsigned long long)block_live);
    }
  }
}

// one thread: the wave just traced (kCount rays) adds to the tallies, its
// columns become kValid, the live count W3 summed becomes kCount, the depth
// goes up by one
__global__ void wave_tally(long long* __restrict__ ctl) {
  const long long n = ctl[kCount];
  ctl[kWaves] += n > 0 ? 1 : 0;
  ctl[kRays] += n;
  ctl[kValid] = n;
  ctl[kCount] = ctl[kNext];
  ctl[kNext] = 0;
  ctl[kDepth] += 1;
}

// The drain: every live path of the carried table (the first ctl[kValid]
// columns, rows `stride` floats apart, those with the live flag) carried to
// its end in one launch, each level B2's walk, W1's record and W2's shading
// (record_hit, shade_hit), at the depth ctl[kDepth] on, and its radiance
// written once, as W2 writes it.  A lane whose path ended takes the next
// untaken column from ctl[kCursor] (a warp takes its lanes' columns with one
// atomic), so any live count is drained, in any grid.  All 32 lanes of a
// warp enter each walk together; a lane without a path walks nothing.  The
// rays traced are added to ctl[kRays] and the most levels a path ran to
// ctl[kLevels], one atomic each a warp.
__global__ void __launch_bounds__(kDrainBlock)
wave_drain(const float* __restrict__ table, size_t stride, WalkTable walk,
           const float* __restrict__ sph_rows, int S, const float* __restrict__ bg,
           int rr_start_depth, int max_depth, float* __restrict__ out, int num_pixels,
           long long* __restrict__ ctl) {
  const int lane = threadIdx.x % 32;
  const unsigned long long valid = (unsigned long long)ctl[kValid];
  const int depth0 = (int)ctl[kDepth];
  V3 org = {0.0f, 0.0f, 0.0f}, dir = org, T = org, L = org;
  uint32_t state = 0;
  int pix = 0, samp = 0, depth = 0, levels = 0;
  unsigned rays = 0, deepest = 0;
  bool in_path = false, taken = false;
  while (true) {
    // the lanes without a path take the next columns until each holds a
    // live one or every column is taken
    unsigned need = __ballot_sync(kFullWarp, !in_path);
    while (need != 0 && !taken) {
      const int leader = __ffs(need) - 1;
      const unsigned count = __popc(need);
      unsigned long long base = 0;
      if (lane == leader) {
        base = atomicAdd((unsigned long long*)(ctl + kCursor), (unsigned long long)count);
      }
      base = __shfl_sync(kFullWarp, base, leader);
      taken = base + count >= valid;
      if (need >> lane & 1u) {
        const unsigned long long col = base + __popc(need & ((1u << lane) - 1u));
        if (col < valid && table[kLive * stride + col] > 0.0f) {
          org = row3(table, stride, kOrg, (int)col);
          dir = row3(table, stride, kDir, (int)col);
          T = row3(table, stride, kThroughput, (int)col);
          L = row3(table, stride, kRadiance, (int)col);
          state = __float_as_uint(table[kState * stride + col]);
          pix = __float_as_int(table[kPix * stride + col]);
          samp = __float_as_int(table[kSamp * stride + col]);
          depth = depth0;
          levels = 0;
          in_path = true;
        }
      }
      need = __ballot_sync(kFullWarp, !in_path);
    }
    if (!__any_sync(kFullWarp, in_path)) break;
    float t = INFINITY, u, v;
    int slot = -1;
    WalkCounts unused;
    brick_walk<false, false>(walk, in_path, org, dir, kSecondaryTnear, t, slot, u, v, unused);
    if (!in_path) continue;
    ++levels;
    const HitRecord h = record_hit(org, dir, t, slot, kSecondaryTnear, walk.brick_data, sph_rows,
                                   S);
    if (!shade_hit(h, bg, state, org, dir, T, L, depth, rr_start_depth, max_depth)) {
      write_radiance(out, num_pixels, samp, pix, L);
      rays += levels;
      deepest = max(deepest, (unsigned)levels);
      in_path = false;
    }
    ++depth;
  }
  const unsigned warp_rays = __reduce_add_sync(kFullWarp, rays);
  const unsigned warp_deepest = __reduce_max_sync(kFullWarp, deepest);
  if (lane == 0 && warp_rays > 0) {
    atomicAdd((unsigned long long*)(ctl + kRays), (unsigned long long)warp_rays);
    atomicMax((unsigned long long*)(ctl + kLevels), (unsigned long long)warp_deepest);
  }
}

// one thread after the drain: its levels count as waves and depths, as the
// live-prefix loop's waves would have; no ray is left and no column holds
// one; the drain's slots are cleared for the next frame
__global__ void wave_drain_tally(long long* __restrict__ ctl) {
  ctl[kWaves] += ctl[kLevels];
  ctl[kDepth] += ctl[kLevels];
  ctl[kCount] = 0;
  ctl[kNext] = 0;
  ctl[kValid] = 0;
  ctl[kCursor] = 0;
  ctl[kLevels] = 0;
}

int blocks(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace

// Each launch function runs its kernel on `stream` and returns
// cudaGetLastError() (0 on success); an empty wave launches nothing.  The
// caller checks shapes, types and devices (ops/wave_step.py).  `ctl`, the
// fixed-capacity loop's int64 control block, may be null (see the top).

// W1: `brick_data` the set's [B, 136, 128] bricks, `sph_rows` its [S, 32]
// resident spheres; out [16, n].
extern "C" int pt_wave_record_launch(const float* ox, const float* oy, const float* oz,
                                     const float* dx, const float* dy, const float* dz,
                                     const float* t, const int* slot, int n, float tnear,
                                     const float* brick_data, const float* sph_rows,
                                     int num_spheres, float* out, const long long* ctl,
                                     void* stream) {
  if (n <= 0) return 0;
  wave_record<<<blocks(n), kBlock, 0, (cudaStream_t)stream>>>(
      ox, oy, oz, dx, dy, dz, t, slot, n, tnear, brick_data, sph_rows, num_spheres, out, ctl);
  return (int)cudaGetLastError();
}

// W2's first half: `rec` [16, n], `lights` [L, 6] (position, intensity);
// out [L, 3, n].
extern "C" int pt_wave_shadow_rays_launch(const float* rec, int n, const float* lights,
                                          int num_lights, float* out, void* stream) {
  if (n <= 0) return 0;
  wave_shadow_rays<<<blocks(n), kBlock, 0, (cudaStream_t)stream>>>(rec, n, lights, num_lights,
                                                                   out);
  return (int)cudaGetLastError();
}

// W2: `table` [16, n] in, `next` [16, >= n] out with rows `next_stride`
// floats apart, `rec` [16, n], `shadow_t` [L, n] (null without lights),
// `bg` [3], out [num_samples, num_pixels, 3].
extern "C" int pt_wave_shade_launch(const float* table, float* next, long long next_stride,
                                    const float* rec, int n, const float* shadow_t,
                                    const float* lights, int num_lights, const float* sph_rows,
                                    int num_spheres, const float* bg, int depth,
                                    int rr_start_depth, int max_depth, float* out,
                                    int num_pixels, const long long* ctl, void* stream) {
  if (n <= 0) return 0;
  wave_shade<<<blocks(n), kBlock, 0, (cudaStream_t)stream>>>(
      table, next, (size_t)next_stride, rec, n, shadow_t, lights, num_lights, sph_rows,
      num_spheres, bg, depth, rr_start_depth, max_depth, out, num_pixels, ctl);
  return (int)cudaGetLastError();
}

// W3: `live` [n] (1 or 0), `lo` and `inv_extent` [3], `coarse` [K, 8] (read
// for "sig_mort" only); out [n].  With `ctl`, adds the live count to its
// kNext.
extern "C" int pt_wave_sort_key_launch(const float* ox, const float* oy, const float* oz,
                                       const float* dx, const float* dy, const float* dz,
                                       const float* live, int n, int mode, const float* lo,
                                       const float* inv_extent, const float* coarse, int K,
                                       int* out, long long* ctl, void* stream) {
  if (n <= 0) return 0;
  wave_sort_key<<<blocks(n), kBlock, 0, (cudaStream_t)stream>>>(
      ox, oy, oz, dx, dy, dz, live, n, mode, lo, inv_extent, coarse, K, out, ctl);
  return (int)cudaGetLastError();
}

// The control block's step from one wave to the next (wave_tally).
extern "C" int pt_wave_tally_launch(long long* ctl, void* stream) {
  wave_tally<<<1, 1, 0, (cudaStream_t)stream>>>(ctl);
  return (int)cudaGetLastError();
}

// The drain and its tally on `stream`: `table` the carried table [16, >=
// ctl[kValid]] with rows `stride` floats apart, `nodes`, `tris`, `gates` and
// `brick_data` the set's walk table, sub_boxes and bricks as B2 and W1 read
// them, `sph_rows` its [S, 32] resident spheres, `bg` [3], out
// [num_samples, num_pixels, 3]; `lanes` threads (a multiple of 128, the
// card's resident lanes: pt_wave_drain_lanes).  The caller checks that the
// top tree's depth + 2 is at most kStack.
extern "C" int pt_wave_drain_launch(const float* table, long long stride, const void* nodes,
                                    const void* tris, const void* gates,
                                    const float* brick_data, const float* sph_rows,
                                    int num_spheres, const float* bg, int rr_start_depth,
                                    int max_depth, float* out, int num_pixels, long long* ctl,
                                    int lanes, void* stream) {
  if (lanes <= 0 || lanes % kDrainBlock != 0) return (int)cudaErrorInvalidValue;
  const WalkTable walk = {(const float4*)nodes, (const float*)tris, (const float4*)gates,
                          brick_data};
  wave_drain<<<lanes / kDrainBlock, kDrainBlock, 0, (cudaStream_t)stream>>>(
      table, (size_t)stride, walk, sph_rows, num_spheres, bg, rr_start_depth, max_depth, out,
      num_pixels, ctl);
  wave_drain_tally<<<1, 1, 0, (cudaStream_t)stream>>>(ctl);
  return (int)cudaGetLastError();
}

// The drain's resident lanes on card `device`: its SMs times the drain's
// blocks a multiprocessor holds at once times the block's threads, into
// `lanes`.  Returns a CUDA error (0 on success).
extern "C" int pt_wave_drain_lanes(int device, int* lanes) {
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wave_drain, kDrainBlock, 0);
  if (err != cudaSuccess) return (int)err;
  *lanes = sms * per_sm * kDrainBlock;
  return 0;
}
