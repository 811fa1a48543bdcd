// Persistent large-scene render (kernel B6) for Hopper (sm_90a): whole
// progressive sample passes over a brick set in one launch.
//
// Replaces the JAX package's Pallas TPU kernel
// pathtracer_cuda_interactive_tpu/ops/brickkernel.py::_make_brick_kernel:
// the persistent shell of the megakernel (ops/megakernel.py::
// make_persistent_kernel) around the full-record brick intersector
// (make_brick_intersect(slim=False)), with no NEE.  For the pixels of screen
// tiles [tile0, tile0 + n_tiles) of the 64x32 tile grid it computes the
// radiance SUM of passes sample_start .. sample_start + n_pass - 1, each a
// full path with camera jitter, the radiance.cuh bounce logic, Russian
// roulette after rr_start_depth and a depth cap, and writes it straight to
// the pixel's place in a [height * width, 3] image.  The plain version it is
// held to is ops/brickkernel.py::render_tiles_bricks_plain.
//
// What bounds it on the card: the brick walk's dependent reads and the
// divergence of a warp's walks, as in B2 (csrc/brick_trace.cu), now inside
// every bounce of every path, and the divergence of the paths themselves: a
// sample takes 5.8 rays on average under a depth cap of 50, and after the
// first bounce a warp's lanes walk unrelated parts of the tree.  Shading is a
// small share.  The sorted wavefront pays a host dispatch of some 800 small
// kernels per wave between its traces; this kernel pays none, but its warps
// stay unsorted.
//
// What the design does about that:
//   * The closest hit is csrc/brick_walk.cuh::brick_closest: the resident
//     spheres, then the walk over the compact walk table, whose lanes meet
//     again before each phase and test a held chunk's 32 triangles together.
//     That helps most here, where a warp's rays are incoherent.
//   * A shell of its own, `pixel_sums`, not B1's (csrc/path_shell.cuh): one
//     thread per pixel and its samples in order, as there, but samples and
//     bounces are one flat loop, so a lane whose path ends starts its next
//     sample in the next round instead of waiting for its warp's longest
//     path, and all 32 lanes enter every closest hit together, as the walk's
//     shuffles need.  A pixel's sum is still acc + L for s = 0, 1, ... in
//     order, and the RNG is keyed by (pixel, sample, seed), so an image is
//     the same from run to run and the same as under B1's shell.  Handing a
//     warp's (pixel, sample) items out to whichever lane is idle, with the
//     sums kept in sample order through shared memory, gives the same image
//     2.5% slower at 2 samples a frame (PERF.md), so a lane keeps its
//     pixel.
//   * Each 128-thread block covers a compact 16x8 pixel patch and each warp
//     an 8x4 part of it, so a warp's camera rays are neighbours and walk the
//     same nodes; this plays the part of the TPU's 64x32 tile swizzle
//     (tile_permutation), and sums go straight to pixel indices, so there is
//     no un-permute step.  A 64x32 screen tile is 16 blocks.
//   * The resident sphere table (up to 512 x 32 floats = 64 KiB) is staged
//     once per block in dynamic shared memory, read as broadcasts; above
//     48 KB the launcher raises the block's limit, as B1's does.
//   * The walk's 192-slot stack is a per-thread local array: 768 bytes per
//     thread; a walk touches only its first depth + 1 slots.
//   * Arithmetic repeats the plain version op for op (--fmad=false, no fast
//     math, IEEE sqrtf and division).

#include "brick_walk.cuh"
#include "path_shell.cuh"

namespace {

using namespace pt;

constexpr int kBlock = 128;      // threads per block: a 16x8 pixel patch
constexpr int kTileW = 64;       // screen tile (ops/brickkernel.py::TILE)
constexpr int kTileH = 32;
constexpr int kPatchW = 16;
constexpr int kPatchH = 8;
constexpr int kBlocksPerTile = (kTileW / kPatchW) * (kTileH / kPatchH);

// One bounce of a path that hit `rec`: the bounce of csrc/path_shell.cuh
// (radiance.cuh:21-79) without a direct light.  Updates the path and returns
// whether it goes on.
__device__ __forceinline__ bool bounce(const HitRecord& rec, uint32_t& state, V3& org, V3& dir,
                                       V3& T, V3& L, int depth, int rr_start_depth) {
  const Material mat = record_to_material(rec);
  const V3 ns = normalize(rec.ns);
  const V3 wi = neg(dir);
  const float cos_view = dot(wi, ns);
  if (rec.emit > 0.0f && cos_view > 0.0f) L = add(L, mul(T, rec.emission));
  const V3 n = cos_view < 0.0f ? neg(ns) : ns;

  const float su1 = next_uniform(state);
  const float su2 = next_uniform(state);
  const float su3 = next_uniform(state);
  bool is_spec;
  V3 weight;
  const V3 wo = sample_brdf(mat, n, wi, su1, su2, su3, is_spec, weight);
  V3 contrib;
  if (is_spec) {
    if (!(max3(weight) > 0.0f)) return false;
    contrib = weight;
  } else {
    float pdf;
    const V3 value = eval_brdf(mat, n, wi, wo, pdf);
    if (!(max3(value) > 0.0f && pdf > 0.0f)) return false;
    contrib = scale(value, 1.0f / pdf);
  }
  T = mul(T, contrib);
  org = rec.pos;
  dir = wo;

  const float ru = next_uniform(state);
  if (depth > rr_start_depth) {
    const float p = fmaxf(0.5f, 1.0f - max3(T));
    if (ru < p) return false;
    if (p < 1.0f) T = scale(T, 1.0f / (1.0f - p));
  }
  return true;
}

// Radiance sum of passes sample_start .. sample_start + n_pass - 1 of pixel
// pix = (fi, fj); a lane with has_pixel = false renders nothing.  All 32
// lanes of a warp call it together.  Per sample a camera ray with jitter,
// then bounces until the path ends; the RNG streams and draw order are those
// of ops/integrator.py (2 camera draws, then 3 BSDF draws and 1 roulette
// draw per bounce that hits).
__device__ __forceinline__ V3 pixel_sums(const float* sph_rows, int S, const WalkTable& table,
                                         const CameraRays& cam, V3 background, bool has_pixel,
                                         uint32_t pix, float fi, float fj, int width,
                                         int height, uint32_t sample_start, int n_pass,
                                         uint32_t seed, int max_depth, int rr_start_depth) {
  V3 acc = {0.0f, 0.0f, 0.0f};
  V3 org = acc, dir = acc, T = acc, L = acc;
  uint32_t state = 0;
  float tnear = 0.0f;
  int s = 0, depth = 0;
  bool in_path = false;
  while (true) {
    if (!in_path && has_pixel && s < n_pass) {
      state = seed_ray(pix, sample_start + (uint32_t)s, seed);
      const float u1 = next_uniform(state);
      const float u2 = next_uniform(state);
      const float u = (fi + u1) / (float)width;
      const float v = (fj + u2) / (float)height;
      dir = normalize({cam.top_left.x + u * cam.horizontal.x - v * cam.vertical.x - cam.origin.x,
                       cam.top_left.y + u * cam.horizontal.y - v * cam.vertical.y - cam.origin.y,
                       cam.top_left.z + u * cam.horizontal.z - v * cam.vertical.z - cam.origin.z});
      org = cam.origin;
      T = {1.0f, 1.0f, 1.0f};
      L = {0.0f, 0.0f, 0.0f};
      tnear = 0.0f;
      depth = 0;
      in_path = true;
    }
    if (!__any_sync(kFullWarp, in_path)) break;
    HitRecord rec;
    WalkCounts unused;
    const bool hit = brick_closest<false>(sph_rows, S, table, in_path, org, dir, tnear, rec,
                                          unused);
    if (!in_path) continue;
    bool go_on = false;
    if (hit) {
      go_on = bounce(rec, state, org, dir, T, L, depth, rr_start_depth) && ++depth < max_depth;
      tnear = kSecondaryTnear;
    } else {
      L = add(L, mul(T, background));
    }
    if (!go_on) {
      acc = add(acc, L);
      ++s;
      in_path = false;
    }
  }
  return acc;
}

__global__ void __launch_bounds__(kBlock)
brick_render(const float* __restrict__ sph_rows, int S, WalkTable table,
             const float* __restrict__ cam, const float* __restrict__ bg,
             float* __restrict__ out, int width, int height, int tile0,
             uint32_t sample_start, int n_pass, uint32_t seed, int max_depth,
             int rr_start_depth) {
  extern __shared__ float sph[];
  for (int i = threadIdx.x; i < S * kRow; i += blockDim.x) sph[i] = sph_rows[i];
  __syncthreads();

  const int tile = tile0 + blockIdx.x / kBlocksPerTile;
  const int patch = blockIdx.x % kBlocksPerTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tiles_x = (width + kTileW - 1) / kTileW;
  const int ii = (tile % tiles_x) * kTileW + (patch % (kTileW / kPatchW)) * kPatchW +
                 (warp % 2) * 8 + lane % 8;
  const int jj = (tile / tiles_x) * kTileH + (patch / (kTileW / kPatchW)) * kPatchH +
                 (warp / 2) * 4 + lane / 8;
  const bool has_pixel = ii < width && jj < height;
  const int pix = jj * width + ii;

  const V3 acc = pixel_sums(sph, S, table, load_camera(cam), load3(bg), has_pixel,
                            (uint32_t)pix, (float)ii, (float)jj, width, height, sample_start,
                            n_pass, seed, max_depth, rr_start_depth);
  if (!has_pixel) return;
  float* o = out + (size_t)pix * 3;
  o[0] = acc.x;
  o[1] = acc.y;
  o[2] = acc.z;
}

}  // namespace

// Launch on `stream` into `out` ([width * height, 3], pixels outside the
// tiles untouched): `nodes` and `tris` are the set's walk table (16-byte
// aligned), `gates` its sub_boxes.  The caller checks that the tile range
// lies in the grid and that the top tree's depth + 2 is at most kStack.
// Returns cudaGetLastError() (0 on success).
extern "C" int pt_brick_render_launch(const float* sph_rows, int num_spheres,
                                      const void* nodes, const void* tris,
                                      const void* gates, const float* brick_data,
                                      const float* cam,
                                      const float* bg, float* out, int width, int height,
                                      int tile0, int n_tiles, unsigned int sample_start,
                                      int num_samples, int num_real, unsigned int seed,
                                      int max_depth, int rr_start_depth, void* stream) {
  if (n_tiles <= 0) return 0;
  const size_t smem_bytes = (size_t)num_spheres * kRow * sizeof(float);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        brick_render, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_pass = num_real < 0 ? num_samples : (num_real < num_samples ? num_real : num_samples);
  const WalkTable table = {(const float4*)nodes, (const float*)tris, (const float4*)gates,
                           brick_data};
  const dim3 grid((unsigned)(n_tiles * kBlocksPerTile));
  brick_render<<<grid, kBlock, smem_bytes, (cudaStream_t)stream>>>(
      sph_rows, num_spheres, table, cam, bg, out, width, height, tile0, sample_start, n_pass,
      seed, max_depth, rr_start_depth);
  return (int)cudaGetLastError();
}
