// Small-scene path-tracing megakernel for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// pathtracer_cuda_interactive_tpu/ops/megakernel.py::_make_kernel (with its
// shell make_persistent_kernel, intersector _intersect_all and NEE any-hit
// _occluded_all).  It computes what that kernel computes: for pixels
// [pix0, pix0 + count) the radiance SUM of passes sample_start ..
// sample_start + n_pass - 1, each a full path with camera jitter, the
// radiance.cuh bounce logic, Russian roulette after rr_start_depth, a depth
// cap, brute-force closest hit over the primitive table (spheres first, then
// triangles) and optional point-light NEE with a brute-force any-hit.  The
// plain version it is held to is ops/integrator.py::render_pixel_sums.  The
// shell and the shading are csrc/path_shell.cuh and csrc/pt_common.cuh; this
// file adds the primitive table.
//
// What bounds it on the card: FP32 work started at a low rate, not bytes (per
// pixel it writes 12 bytes).  Every ray is tested against all P <= 512
// primitives; a warp's 32 paths end at different depths, so lanes idle, and
// each test is a chain of dependent operations, so a warp alone fills few
// scheduler slots and the kernel lives on how many warps an SM holds.
//
// What the design does about that:
//   * The closest hit reads a compact test table in shared memory, built by
//     each block from the 32-float records: a sphere is one float4 (centre,
//     radius), a triangle three (p0, e1, e2), so a triangle test makes three
//     16-byte loads, where reading the records in place took nine 4-byte ones
//     at unaligned offsets.  The camera and the background are staged there
//     too and read once a sample instead of living in registers.
//   * Two ways through the table.  Lane by lane: every lane scans the whole
//     table for its own ray, each read a broadcast; a round costs the warp the
//     whole table however few of its lanes hold a ray.  Together: the warp
//     takes the rays of its lanes that are in a path two at a time by
//     shuffles, lane l tests spheres l, l + 32, ... and triangles l, l + 32,
//     ... against both (one read of an entry for two independent tests), and
//     two warp min-reductions pick "smallest t, lowest id", which is what the
//     sequential strict t < best selects.  Together a warp runs (lanes in a
//     path) x ceil(P / 32) tests a round, not P, but each ray pays some 25
//     instructions of hand-over in one dependent chain.  Measured (PERF.md),
//     always together is slower than lane by lane up to 170 primitives (a
//     frame of the main path's 32 triangles 0.83 against 0.58 ms) and faster
//     from 224 on (5.86 against 7.08 ms at 512).  So the launcher picks by the
//     table's size alone: below 32 primitives lane by lane; from 32 to 255 a
//     mix, in which a warp goes lane by lane while more than 16 of its lanes
//     hold a ray and takes the rays together once 16 or fewer do (the main
//     path, 0.51 ms); from 256 on always together, with the records read
//     from global memory instead of staged.  The NEE shadow test goes the
//     same ways.
//   * The shell is one flat loop over samples and bounces, so all 32 lanes
//     reach every closest hit and shadow test together, as the shuffles need.
//   * The intersection carries only (t, k, u, v) of the best hit; the hit's
//     record is rebuilt once after it (pt_common.cuh).
//   * Arithmetic repeats the plain version op for op: the build uses
//     --fmad=false and no fast math, IEEE sqrtf and division (no rsqrtf),
//     and the same association order, so the two agree to transcendental
//     ulps.  The RNG is the same PCG in native uint32 and is bit-exact.

#include "path_shell.cuh"

namespace {

using namespace pt;

constexpr int kLightRow = 8;          // floats per point-light record
constexpr int kBlock = 128;           // threads per block
constexpr int kTriVecs = 3;           // float4 per triangle of the test table
constexpr int kViewFloats = 16;       // the camera's 12 floats, the background's 3, one pad
// How a warp goes through the table, by the table's size alone (the rule is
// in the launcher; kFew is the number of rays at or below which a warp takes
// them together).  Measured on 4, 5, 32, 128, 170 (42 of them spheres), 224,
// 320, 416 and 512 primitives (PERF.md): with fewer primitives than lanes a
// round together leaves lanes idle and lane by lane wins; from 32 on the mix
// wins, up to 224; at 320 and beyond always together does.
constexpr int kLaneOnly = 0;          // below kMixFrom primitives
constexpr int kMix = 16;              // lane by lane above 16 rays, else together
constexpr int kAlways = 32;           // from kTogetherFrom primitives on
constexpr int kMixFrom = 32;
constexpr int kTogetherFrom = 256;
// Below kTogetherFrom the kernel is held to 5 blocks an SM (at most 102
// registers), which measured best even where it spills; always together it
// takes what it needs (122).
constexpr int kLaneBlocks = 5;

// A ray of a scan, and the nearest hit the scan has found for it.
struct Ray {
  V3 org, dir;
  float tnear;
};

struct Hit {
  float t, u, v;
  int k;
};

__device__ __forceinline__ void try_sphere(float4 c, int id, const Ray& r, Hit& best) {
  float t;
  if (sphere_test({c.x, c.y, c.z}, c.w, r.org, r.dir, r.tnear, best.t, t) && t < best.t) {
    best.t = t;
    best.k = id;
  }
}

__device__ __forceinline__ void try_triangle(float4 a, float4 b, float4 c, int id, const Ray& r,
                                             Hit& best) {
  float t, u, v;
  if (tri_test({a.x, a.y, a.z}, {a.w, b.x, b.y}, {b.z, b.w, c.x}, r.org, r.dir, r.tnear, best.t,
               t, u, v) &&
      t < best.t) {
    best = {t, u, v, id};
  }
}

__device__ __forceinline__ bool any_sphere(float4 c, const Ray& r, float tfar) {
  float t;
  return sphere_test({c.x, c.y, c.z}, c.w, r.org, r.dir, r.tnear, tfar, t);
}

__device__ __forceinline__ bool any_triangle(float4 a, float4 b, float4 c, const Ray& r,
                                             float tfar) {
  float t, u, v;
  return tri_test({a.x, a.y, a.z}, {a.w, b.x, b.y}, {b.z, b.w, c.x}, r.org, r.dir, r.tnear, tfar,
                  t, u, v);
}

// The primitive table and the point lights.
template <int kFew>
struct TableScene {
  const float4* sph;     // shared memory: S x (centre, radius)
  const float4* tri;     // shared memory: F x (p0 e1.x | e1.yz e2.xy | e2.z - - -)
  const float* rows;     // the P x 32-float records: shared memory, global always together
  int S, F;
  const float* lights;   // shared memory
  int NL;
  static constexpr bool kDirect = true;

  // A share of the table (entries first, first + step, ... of the spheres,
  // then of the triangles) against one ray, or two at once: each ray's
  // nearest hit with a strict t < best in ascending id, spheres first.  An
  // entry is read once for both rays, whose tests do not wait for each other.
  template <bool kTwo>
  __device__ __forceinline__ void scan(int first, int step, const Ray& ra, const Ray& rb,
                                       Hit& a, Hit& b) const {
    a = {INFINITY, 0.0f, 0.0f, -1};
    b = a;
    for (int i = first; i < S; i += step) {
      const float4 c = sph[i];
      try_sphere(c, i, ra, a);
      if constexpr (kTwo) try_sphere(c, i, rb, b);
    }
    for (int i = first; i < F; i += step) {
      const float4 p = tri[i * kTriVecs], q = tri[i * kTriVecs + 1], r = tri[i * kTriVecs + 2];
      try_triangle(p, q, r, S + i, ra, a);
      if constexpr (kTwo) try_triangle(p, q, r, S + i, rb, b);
    }
  }

  // Whether the share has a hit on the open segment (tnear, tfar) of each ray.
  template <bool kTwo>
  __device__ __forceinline__ void scan_any(int first, int step, const Ray& ra, const Ray& rb,
                                           float far_a, float far_b, bool& a, bool& b) const {
    a = false;
    b = false;
    for (int i = first; i < S; i += step) {
      const float4 c = sph[i];
      a = a || any_sphere(c, ra, far_a);
      if constexpr (kTwo) b = b || any_sphere(c, rb, far_b);
    }
    for (int i = first; i < F; i += step) {
      const float4 p = tri[i * kTriVecs], q = tri[i * kTriVecs + 1], r = tri[i * kTriVecs + 2];
      a = a || any_triangle(p, q, r, ra, far_a);
      if constexpr (kTwo) b = b || any_triangle(p, q, r, rb, far_b);
    }
  }

  // The ray of lane src, by shuffles.
  static __device__ __forceinline__ Ray ray_of(int src, V3 org, V3 dir, float tnear) {
    return {shfl3(org, src), shfl3(dir, src), __shfl_sync(kFullWarp, tnear, src)};
  }

  // The next two lanes of `rest`, lowest first; with one left, the second
  // repeats it and `two` is false.
  static __device__ __forceinline__ void next_two(unsigned& rest, int& src_a, int& src_b,
                                                  bool& two) {
    src_a = __ffs(rest) - 1;
    rest &= rest - 1;
    two = rest != 0;
    src_b = two ? __ffs(rest) - 1 : src_a;
    rest &= rest - 1;
  }

  // The warp's nearest of its lanes' hits, handed to lane src: smallest t, and
  // among equal t the lowest id, which is what a strict t < best in id order
  // selects (ids of one lane ascend, so its own strict < kept its lowest).  A
  // hit's t is at least tnear >= 0, so its bits order as it does, once -0
  // counts as 0.  With no hit at all every key is +inf and the lowest "id"
  // is -1.
  __device__ __forceinline__ void settle(const Hit& h, bool to_me, Hit& mine) const {
    const unsigned key = h.k < 0 ? kInfBits : (h.t == 0.0f ? 0u : __float_as_uint(h.t));
    const unsigned nearest = __reduce_min_sync(kFullWarp, key);
    const int k = (int)__reduce_min_sync(kFullWarp, key == nearest ? (unsigned)h.k : 0xffffffffu);
    const int holder = (k < S ? k : k - S) & 31;
    const Hit won = {__shfl_sync(kFullWarp, h.t, holder), __shfl_sync(kFullWarp, h.u, holder),
                     __shfl_sync(kFullWarp, h.v, holder), k};
    if (to_me) mine = won;
  }

  // Whether the warp, with rays in the lanes of `rays`, scans lane by lane:
  // the same answer in all 32 lanes.
  static __device__ __forceinline__ bool lane_by_lane(unsigned rays) {
    if constexpr (kFew == kLaneOnly) return true;
    if constexpr (kFew == kAlways) return false;
    return __popc(rays) > kFew;
  }

  // The rays of the lanes in `rest` through the warp together, two at a time:
  // lane l tests spheres l, l + 32, ... and triangles l, l + 32, ... against
  // both, and each ray's owner gets the warp's nearest hit.
  __device__ __forceinline__ void closest_together(unsigned rest, V3 org, V3 dir, float tnear,
                                                   Hit& mine) const {
    const int lane = threadIdx.x % 32;
    while (rest != 0) {
      int src_a, src_b;
      bool two;
      next_two(rest, src_a, src_b, two);
      const Ray ra = ray_of(src_a, org, dir, tnear), rb = ray_of(src_b, org, dir, tnear);
      Hit a, b;
      scan<true>(lane, 32, ra, rb, a, b);
      settle(a, lane == src_a, mine);
      settle(b, two && lane == src_b, mine);
    }
  }

  __device__ __forceinline__ void occluded_together(unsigned rest, V3 org, V3 dir, float tnear,
                                                    float tfar, bool& mine) const {
    const int lane = threadIdx.x % 32;
    while (rest != 0) {
      int src_a, src_b;
      bool two, a, b;
      next_two(rest, src_a, src_b, two);
      const Ray ra = ray_of(src_a, org, dir, tnear), rb = ray_of(src_b, org, dir, tnear);
      scan_any<true>(lane, 32, ra, rb, __shfl_sync(kFullWarp, tfar, src_a),
                     __shfl_sync(kFullWarp, tfar, src_b), a, b);
      a = __any_sync(kFullWarp, a);
      b = __any_sync(kFullWarp, b);
      if (lane == src_a) mine = a;
      if (two && lane == src_b) mine = b;
    }
  }

  // Closest hit of every active lane's ray, all 32 lanes together.
  __device__ __forceinline__ bool closest(bool active, V3 org, V3 dir, float tnear,
                                          HitRecord& rec) const {
    Hit mine = {INFINITY, 0.0f, 0.0f, -1};
    const unsigned rays = __ballot_sync(kFullWarp, active);
    if (lane_by_lane(rays)) {
      // every lane scans the whole table for its own ray
      if (active) {
        const Ray r = {org, dir, tnear};
        Hit unused;
        scan<false>(0, 1, r, r, mine, unused);
      }
    } else {
      closest_together(rays, org, dir, tnear, mine);
    }
    if (mine.k < 0) return false;
    const float* row = rows + mine.k * kRow;
    rec = mine.k < S ? sphere_record(row, org, dir, mine.t)
                     : triangle_record(row, mine.t, mine.u, mine.v);
    return true;
  }

  // Any hit on the open segment (tnear, tfar) of every active lane's ray, all
  // 32 lanes together: the NEE shadow test.
  __device__ __forceinline__ bool occluded(bool active, V3 org, V3 dir, float tnear,
                                           float tfar) const {
    bool mine = false;
    const unsigned rays = __ballot_sync(kFullWarp, active);
    if (lane_by_lane(rays)) {
      if (active) {
        const Ray r = {org, dir, tnear};
        bool unused;
        scan_any<false>(0, 1, r, r, tfar, tfar, mine, unused);
      }
    } else {
      occluded_together(rays, org, dir, tnear, tfar, mine);
    }
    return mine;
  }

  // point-light NEE with a brute-force shadow test, all 32 lanes together
  __device__ __forceinline__ void add_direct(bool active, V3& L, V3 pos, V3 n, V3 wi,
                                             const Material& mat, V3 T) const {
    if (NL == 0) return;
    V3 extra = {0.0f, 0.0f, 0.0f};
    for (int l = 0; l < NL; ++l) {
      const float* lr = lights + l * kLightRow;
      V3 wo = {0.0f, 0.0f, 0.0f}, value = wo;
      float dist = 0.0f, dist2 = 0.0f;
      if (active) {
        const V3 d = sub(load3(lr), pos);
        dist2 = dot(d, d);
        dist = sqrtf(dist2);
        wo = scale(d, 1.0f / fmaxf(dist, 1e-20f));
        float pdf_unused;
        value = eval_brdf(mat, n, wi, wo, pdf_unused);
      }
      if (!occluded(active, pos, wo, kSecondaryTnear, dist * 0.999f) && active) {
        const V3 c = scale(mul(mul(T, value), load3(lr + 3)), 1.0f / fmaxf(dist2, 1e-20f));
        extra = add(extra, c);
      }
    }
    if (active) L = add(L, extra);
  }
};

template <int kFew>
__global__ void __launch_bounds__(kBlock, kFew == kAlways ? 1 : kLaneBlocks)
megakernel(const float* prim_rows, int S, int F,
           const float* __restrict__ light_rows, int NL,
           const float* __restrict__ cam, const float* __restrict__ bg,
           float* __restrict__ out, int width, int height, int pix0, int count,
           uint32_t sample_start, int n_pass, uint32_t seed, int max_depth,
           int rr_start_depth) {
  // The test table: what the closest hit reads of every primitive, 16-byte
  // aligned (floats 1..9 of a triangle's record are p0, e1, e2); then the
  // camera and the background, then the lights.
  extern __shared__ float4 smem[];
  float4* sph = smem;
  float4* tri = smem + S;
  float* view = reinterpret_cast<float*>(tri + F * kTriVecs);
  float* lights = view + kViewFloats;
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    const float* r = prim_rows + i * kRow;
    sph[i] = make_float4(r[1], r[2], r[3], r[4]);
  }
  for (int i = threadIdx.x; i < F; i += blockDim.x) {
    const float* r = prim_rows + (S + i) * kRow;
    tri[i * kTriVecs] = make_float4(r[1], r[2], r[3], r[4]);
    tri[i * kTriVecs + 1] = make_float4(r[5], r[6], r[7], r[8]);
    tri[i * kTriVecs + 2] = make_float4(r[9], 0.0f, 0.0f, 0.0f);
  }
  if (threadIdx.x < 12) view[threadIdx.x] = cam[threadIdx.x];
  if (threadIdx.x < 3) view[12 + threadIdx.x] = bg[threadIdx.x];
  for (int i = threadIdx.x; i < NL * kLightRow; i += blockDim.x) lights[i] = light_rows[i];
  if constexpr (kFew != kAlways) {
    // a smaller table's records too (under 32 KiB): a hit's record is then
    // rebuilt from shared memory
    float* staged = lights + NL * kLightRow;
    for (int i = threadIdx.x; i < (S + F) * kRow; i += blockDim.x) staged[i] = prim_rows[i];
    prim_rows = staged;
  }
  __syncthreads();

  const int local = blockIdx.x * blockDim.x + threadIdx.x;
  const int pix = pix0 + local;
  const bool has_pixel = local < count && pix < width * height;

  const TableScene<kFew> scene = {sph, tri, prim_rows, S, F, lights, NL};
  const V3 acc = pixel_sums(scene, view, view + 12, has_pixel, (uint32_t)pix,
                            (float)(pix % width), (float)(pix / width), width, height,
                            sample_start, n_pass, seed, max_depth, rr_start_depth);
  if (!has_pixel) return;
  float* o = out + (size_t)local * 3;
  o[0] = acc.x;
  o[1] = acc.y;
  o[2] = acc.z;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int pt_megakernel_launch(const float* prim_rows, int num_spheres, int num_triangles,
                                    const float* light_rows, int num_lights, const float* cam,
                                    const float* bg, float* out, int width, int height, int pix0,
                                    int count, unsigned int sample_start, int num_samples,
                                    int num_real,
                                    unsigned int seed, int max_depth, int rr_start_depth,
                                    void* stream) {
  if (count <= 0) return 0;
  // How the warps go through the table follows from its size alone.
  const int prims = num_spheres + num_triangles;
  const bool together = prims >= kTogetherFrom;
  size_t smem_bytes =
      ((size_t)num_spheres + (size_t)num_triangles * kTriVecs) * sizeof(float4) +
      ((size_t)kViewFloats + (size_t)num_lights * kLightRow) * sizeof(float);
  if (!together) smem_bytes += (size_t)prims * kRow * sizeof(float);
  const auto kernel = together          ? megakernel<kAlways>
                      : prims >= kMixFrom ? megakernel<kMix>
                                          : megakernel<kLaneOnly>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_pass = num_real < 0 ? num_samples : (num_real < num_samples ? num_real : num_samples);
  const dim3 grid((unsigned)((count + kBlock - 1) / kBlock));
  kernel<<<grid, kBlock, smem_bytes, (cudaStream_t)stream>>>(
      prim_rows, num_spheres, num_triangles, light_rows, num_lights, cam, bg, out, width, height,
      pix0, count, sample_start, n_pass, seed, max_depth, rr_start_depth);
  return (int)cudaGetLastError();
}
