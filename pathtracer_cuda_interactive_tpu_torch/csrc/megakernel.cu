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
// shell and the shading are csrc/path_shell.cuh, which the brick render
// (csrc/brick_render.cu, B6) shares; this file adds the primitive table.
//
// What bounds it on the card: FP32 ALU work and divergence, not bytes.  Per
// bounce every thread tests all P <= 512 primitives (about 30 flops each) and
// then shades; per pixel it writes 12 bytes.  Threads of a warp end their
// paths at different depths and hit different materials, so lanes idle.
//
// What the design does about that:
//   * One thread per pixel, looping over its samples one after another (the
//     reference's own CUDA design).  A thread whose path ends starts its next
//     sample at once: the TPU kernel's lane-persistent while_loop and its
//     f32-coded masks are not needed.
//   * The primitive table (P x 32 floats, at most 64 KiB) and the light table
//     are staged once per block in dynamic shared memory.  Every thread of a
//     warp reads the same record at the same time, so each read is a
//     broadcast with no bank conflict and no trip to L2.  Above 48 KB the
//     launcher raises the block's shared-memory limit.
//   * The intersection loop carries only (t, k, u, v) of the best hit; the
//     hit's record is rebuilt once after the loop (pt_common.cuh).
//   * Arithmetic repeats the plain version op for op: the build uses
//     --fmad=false and no fast math, IEEE sqrtf and division (no rsqrtf),
//     and the same association order, so the two agree to transcendental
//     ulps.  The RNG is the same PCG in native uint32 and is bit-exact.

#include "path_shell.cuh"

namespace {

using namespace pt;

constexpr int kLightRow = 8;    // floats per point-light record
constexpr int kBlock = 128;     // threads per block

// Closest hit over the table: strict t < best in primitive order, spheres
// first, so ties go to the lowest id like the plain version's argmin.
__device__ __forceinline__ int closest_hit(const float* rows, int S, int P, V3 org, V3 dir,
                                           float tnear, float& best_t, float& best_u,
                                           float& best_v) {
  int best_k = -1;
  best_t = INFINITY;
  for (int k = 0; k < S; ++k) {
    const float* r = rows + k * kRow;
    float t;
    if (sphere_test(load3(r + 1), r[4], org, dir, tnear, best_t, t) && t < best_t) {
      best_t = t;
      best_k = k;
    }
  }
  for (int k = S; k < P; ++k) {
    const float* r = rows + k * kRow;
    float t, u, v;
    if (tri_test(load3(r + 1), load3(r + 4), load3(r + 7), org, dir, tnear, best_t, t, u, v) &&
        t < best_t) {
      best_t = t;
      best_u = u;
      best_v = v;
      best_k = k;
    }
  }
  return best_k;
}

// Any hit on the open segment (tnear, tfar): the NEE shadow test.
__device__ __forceinline__ bool occluded(const float* rows, int S, int P, V3 org, V3 dir,
                                         float tnear, float tfar) {
  for (int k = 0; k < S; ++k) {
    const float* r = rows + k * kRow;
    float t;
    if (sphere_test(load3(r + 1), r[4], org, dir, tnear, tfar, t)) return true;
  }
  for (int k = S; k < P; ++k) {
    const float* r = rows + k * kRow;
    float t, u, v;
    if (tri_test(load3(r + 1), load3(r + 4), load3(r + 7), org, dir, tnear, tfar, t, u, v))
      return true;
  }
  return false;
}

// The primitive table and the point lights, staged in shared memory.
struct TableScene {
  const float* rows;
  int S, P;
  const float* lights;
  int NL;

  __device__ bool closest(V3 org, V3 dir, float tnear, HitRecord& rec) const {
    float t, u = 0.0f, v = 0.0f;
    const int k = closest_hit(rows, S, P, org, dir, tnear, t, u, v);
    if (k < 0) return false;
    const float* r = rows + k * kRow;
    rec = k < S ? sphere_record(r, org, dir, t) : triangle_record(r, t, u, v);
    return true;
  }

  // point-light NEE with a brute-force shadow test
  __device__ void add_direct(V3& L, V3 pos, V3 n, V3 wi, const Material& mat, V3 T) const {
    if (NL == 0) return;
    V3 extra = {0.0f, 0.0f, 0.0f};
    for (int l = 0; l < NL; ++l) {
      const float* lr = lights + l * kLightRow;
      const V3 d = sub(load3(lr), pos);
      const float dist2 = dot(d, d);
      const float dist = sqrtf(dist2);
      const V3 wo = scale(d, 1.0f / fmaxf(dist, 1e-20f));
      float pdf_unused;
      const V3 value = eval_brdf(mat, n, wi, wo, pdf_unused);
      if (!occluded(rows, S, P, pos, wo, kSecondaryTnear, dist * 0.999f)) {
        const V3 c = scale(mul(mul(T, value), load3(lr + 3)), 1.0f / fmaxf(dist2, 1e-20f));
        extra = add(extra, c);
      }
    }
    L = add(L, extra);
  }
};

__global__ void __launch_bounds__(kBlock)
megakernel(const float* __restrict__ prim_rows, int S, int F,
           const float* __restrict__ light_rows, int NL,
           const float* __restrict__ cam, const float* __restrict__ bg,
           float* __restrict__ out, int width, int height, int pix0, int count,
           uint32_t sample_start, int n_pass, uint32_t seed, int max_depth,
           int rr_start_depth) {
  extern __shared__ float smem[];
  const int P = S + F;
  float* rows = smem;
  float* lights = smem + P * kRow;
  for (int i = threadIdx.x; i < P * kRow; i += blockDim.x) rows[i] = prim_rows[i];
  for (int i = threadIdx.x; i < NL * kLightRow; i += blockDim.x) lights[i] = light_rows[i];
  __syncthreads();

  const int local = blockIdx.x * blockDim.x + threadIdx.x;
  if (local >= count) return;
  const int pix = pix0 + local;
  if (pix >= width * height) return;

  const TableScene scene = {rows, S, P, lights, NL};
  const V3 acc = pixel_radiance_sum(scene, load_camera(cam), load3(bg), (uint32_t)pix,
                                    (float)(pix % width), (float)(pix / width), width,
                                    height, sample_start, n_pass, seed, max_depth,
                                    rr_start_depth);
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
  const size_t smem_bytes =
      ((size_t)(num_spheres + num_triangles) * kRow + (size_t)num_lights * kLightRow) *
      sizeof(float);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        megakernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_pass = num_real < 0 ? num_samples : (num_real < num_samples ? num_real : num_samples);
  const dim3 grid((unsigned)((count + kBlock - 1) / kBlock));
  megakernel<<<grid, kBlock, smem_bytes, (cudaStream_t)stream>>>(
      prim_rows, num_spheres, num_triangles, light_rows, num_lights, cam, bg, out, width, height,
      pix0, count, sample_start, n_pass, seed, max_depth, rr_start_depth);
  return (int)cudaGetLastError();
}
