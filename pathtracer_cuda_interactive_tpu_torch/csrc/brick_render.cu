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
// divergence of paths, as in B2 (csrc/brick_trace.cu), now inside every
// bounce of every path; shading is a small share.  The sorted wavefront
// pays a host dispatch of some 800 small kernels per wave between its
// traces; this kernel pays none, but its warps stay unsorted: after the
// first bounce neighbouring threads walk unrelated parts of the tree.
//
// What the design does about that (a simple design that is right first):
//   * The shell is B1's own (csrc/path_shell.cuh): one thread per pixel,
//     samples looped one after another, so a thread whose path ends starts
//     its next sample at once; the RNG is the bit-exact PCG.  The closest
//     hit is csrc/brick_walk.cuh::brick_closest (spheres first, then the
//     per-ray brick walk carrying (t, slot, u, v), the record rebuilt once).
//   * Each 128-thread block covers a compact 16x8 pixel patch and each warp
//     an 8x4 part of it, so a warp's camera rays are neighbours and walk the
//     same nodes; this plays the part of the TPU's 64x32 tile swizzle
//     (tile_permutation), and sums go straight to pixel indices, so there is
//     no un-permute step.  A 64x32 screen tile is 16 blocks.
//   * The resident sphere table (up to 512 x 32 floats = 64 KiB) is staged
//     once per block in dynamic shared memory, read as broadcasts; above
//     48 KB the launcher raises the block's limit, as B1's does.
//   * The walk's 192-slot stack is a per-thread local array: 768 bytes per
//     thread, about 200 MB of local memory reserved across the card's
//     resident threads (132 SMs x 2048 threads); a walk touches only its
//     first depth + 1 slots.
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

// The brick set and the resident spheres (in shared memory); no NEE.
struct BrickScene {
  const float* sph_rows;
  int S;
  Bricks bricks;

  __device__ bool closest(V3 org, V3 dir, float tnear, HitRecord& rec) const {
    WalkCounts unused;
    return brick_closest<false>(sph_rows, S, bricks, org, dir, tnear, rec, unused);
  }

  __device__ void add_direct(V3&, V3, V3, V3, const Material&, V3) const {}
};

__global__ void __launch_bounds__(kBlock)
brick_render(const float* __restrict__ sph_rows, int S, const float* __restrict__ top_boxes,
             const int* __restrict__ top_links, const float* __restrict__ brick_data,
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
  if (ii >= width || jj >= height) return;
  const int pix = jj * width + ii;

  const BrickScene scene = {sph, S, {top_boxes, top_links, brick_data}};
  const V3 acc = pixel_radiance_sum(scene, load_camera(cam), load3(bg), (uint32_t)pix,
                                    (float)ii, (float)jj, width, height, sample_start, n_pass,
                                    seed, max_depth, rr_start_depth);
  float* o = out + (size_t)pix * 3;
  o[0] = acc.x;
  o[1] = acc.y;
  o[2] = acc.z;
}

}  // namespace

// Launch on `stream` into `out` ([width * height, 3], pixels outside the
// tiles untouched).  The caller checks that the tile range lies in the grid
// and that the top tree's depth + 2 is at most kStack.  Returns
// cudaGetLastError() (0 on success).
extern "C" int pt_brick_render_launch(const float* sph_rows, int num_spheres,
                                      const float* top_boxes, const int* top_links,
                                      const float* brick_data, const float* cam,
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
  const dim3 grid((unsigned)(n_tiles * kBlocksPerTile));
  brick_render<<<grid, kBlock, smem_bytes, (cudaStream_t)stream>>>(
      sph_rows, num_spheres, top_boxes, top_links, brick_data, cam, bg, out, width, height,
      tile0, sample_start, n_pass, seed, max_depth, rr_start_depth);
  return (int)cudaGetLastError();
}
