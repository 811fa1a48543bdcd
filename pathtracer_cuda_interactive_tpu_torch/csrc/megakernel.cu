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
// plain version it is held to is ops/integrator.py::render_pixel_sums.
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
//     hit's position, normal and material are rebuilt once after the loop.
//   * Arithmetic repeats the plain version op for op: the build uses
//     --fmad=false and no fast math, IEEE sqrtf and division (no rsqrtf),
//     and the same association order, so the two agree to transcendental
//     ulps.  The RNG is the same PCG in native uint32 and is bit-exact.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRow = 32;        // floats per primitive record
constexpr int kLightRow = 8;    // floats per point-light record
constexpr int kBlock = 128;     // threads per block
constexpr float kSecondaryTnear = 1e-4f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInvPi = 0.3183098861837907f;
constexpr float kHalfInvPi = 0.15915494309189535f;

// material type codes (models/scenepack.py)
constexpr int kDiffuse = 0;
constexpr int kMirror = 1;
constexpr int kPlastic = 2;
constexpr int kPhong = 3;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ float max3(V3 a) { return fmaxf(fmaxf(a.x, a.y), a.z); }
__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ V3 normalize(V3 a) {
  const float inv = 1.0f / sqrtf(fmaxf(dot(a, a), 1e-20f));
  return scale(a, inv);
}

__device__ __forceinline__ V3 load3(const float* p) { return {p[0], p[1], p[2]}; }

// -- PCG-RXS-M-XS 32/32, bit-exact with ops/rng.py --------------------------

__device__ __forceinline__ uint32_t pcg_permute(uint32_t s) {
  uint32_t word = (s >> ((s >> 28) + 4u)) ^ s;
  word *= 277803737u;
  return (word >> 22) ^ word;
}

__device__ __forceinline__ uint32_t seed_ray(uint32_t pix, uint32_t sample, uint32_t seed) {
  uint32_t s = pix * 0x9E3779B9u + sample * 0x85EBCA6Bu + seed;
  s = s * 747796405u + 2891336453u;
  return pcg_permute(s) * 747796405u + 2891336453u;
}

__device__ __forceinline__ float next_uniform(uint32_t& state) {
  state = state * 747796405u + 2891336453u;
  return (float)(pcg_permute(state) >> 8) * (1.0f / 16777216.0f);
}

// -- intersection (ops/geometry.py) -----------------------------------------

__device__ __forceinline__ bool sphere_test(V3 center, float radius, V3 org, V3 dir,
                                            float tnear, float tfar, float& t_out) {
  const V3 v = sub(org, center);
  const float a = dot(dir, dir);
  const float b = 2.0f * dot(dir, v);
  const float c = dot(v, v) - radius * radius;
  const float disc = b * b - 4.0f * a * c;
  bool has_root = disc >= 0.0f;
  const float root_disc = sqrtf(fmaxf(disc, 0.0f));
  const bool b_pos = b >= 0.0f;
  const float q = b_pos ? -b - root_disc : -b + root_disc;
  const float safe_a = a == 0.0f ? 1.0f : a;
  const float safe_q = q == 0.0f ? 1.0f : q;
  const float qa = q / (2.0f * safe_a);
  const float cq = 2.0f * c / safe_q;
  const float r0 = b_pos ? qa : cq;
  const float r1 = b_pos ? cq : qa;
  const bool lin_ok = b != 0.0f;
  const float lin_t = -c / (lin_ok ? b : 1.0f);
  float t0, t1;
  if (a == 0.0f) {
    t0 = lin_t;
    t1 = lin_t;
    has_root = lin_ok;
  } else {
    t0 = fminf(r0, r1);
    t1 = fmaxf(r0, r1);
  }
  const bool t0_ok = (t0 >= tnear) && (t0 < tfar);
  const bool t1_ok = (t1 >= tnear) && (t1 < tfar);
  const float t = t0_ok ? t0 : (t1_ok ? t1 : t0);
  t_out = t;
  return has_root && (t >= tnear) && (t < tfar);
}

__device__ __forceinline__ bool tri_test(V3 p0, V3 e1, V3 e2, V3 org, V3 dir, float tnear,
                                         float tfar, float& t, float& u, float& v) {
  const V3 s1 = cross(dir, e2);
  const float divisor = dot(s1, e1);
  const bool ok = divisor != 0.0f;
  const float inv_div = 1.0f / (ok ? divisor : 1.0f);
  const V3 s = sub(org, p0);
  u = dot(s, s1) * inv_div;
  const V3 s2 = cross(s, e1);
  v = dot(dir, s2) * inv_div;
  t = dot(e2, s2) * inv_div;
  return ok && (t > tnear) && (t < tfar) && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f);
}

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

// -- BSDF (ops/brdf.py) -------------------------------------------------------

struct Material {
  int type;
  V3 color;
  float param;
};

__device__ __forceinline__ V3 reflect(V3 wi, V3 n) { return add(neg(wi), scale(n, 2.0f * dot(wi, n))); }

__device__ __forceinline__ float schlick(float f0, float cos_theta) {
  const float m = clamp01(1.0f - cos_theta);
  const float m5 = m * m * m * m * m;
  return f0 + (1.0f - f0) * m5;
}

__device__ __forceinline__ float plastic_f0(float eta) {
  const float r = (eta - 1.0f) / (eta + 1.0f);
  return r * r;
}

__device__ __forceinline__ void make_frame(V3 n, V3& x, V3& y) {
  const float s = n.z >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (s + n.z);
  const float b = n.x * n.y * a;
  x = {1.0f + s * n.x * n.x * a, s * b, -s * n.x};
  y = {b, s + n.y * n.y * a, -n.y};
}

__device__ __forceinline__ V3 frame_to_world(V3 x, V3 y, V3 n, V3 v) {
  return add(add(scale(x, v.x), scale(y, v.y)), scale(n, v.z));
}

// Returns wo; sets is_spec and weight (weight is 1 except for mirrors).
__device__ __forceinline__ V3 sample_brdf(const Material& m, V3 n, V3 wi, float u1, float u2,
                                          float u3, bool& is_spec, V3& weight) {
  const V3 refl = reflect(wi, n);
  weight = {1.0f, 1.0f, 1.0f};
  is_spec = false;
  if (m.type == kMirror) {
    const float c = dot(n, refl);
    weight = {schlick(m.color.x, c), schlick(m.color.y, c), schlick(m.color.z, c)};
    is_spec = true;
    return refl;
  }
  const float phi = kTwoPi * u1;
  const float cos_phi = cosf(phi);
  const float sin_phi = sinf(phi);
  if (m.type == kPhong) {
    const float cos_theta = powf(fminf(fmaxf(u2, 1e-30f), 1.0f), 1.0f / (m.param + 1.0f));
    const float sin_theta = sqrtf(clamp01(1.0f - cos_theta * cos_theta));
    V3 rx, ry;
    make_frame(refl, rx, ry);
    return frame_to_world(rx, ry, refl, {cos_phi * sin_theta, sin_phi * sin_theta, cos_theta});
  }
  if (m.type == kPlastic && u3 <= schlick(plastic_f0(m.param), dot(n, wi))) {
    is_spec = true;
    return refl;
  }
  const float tmp = sqrtf(clamp01(1.0f - u2));
  V3 fx, fy;
  make_frame(n, fx, fy);
  return frame_to_world(fx, fy, n, {cos_phi * tmp, sin_phi * tmp, sqrtf(clamp01(u2))});
}

// value includes the cosine term; mirrors (pure specular) evaluate to 0.
__device__ __forceinline__ V3 eval_brdf(const Material& m, V3 n, V3 wi, V3 wo, float& pdf) {
  const float cos_term = fmaxf(dot(wo, n), 0.0f) * kInvPi;
  if (m.type == kDiffuse) {
    pdf = cos_term;
    return scale(m.color, cos_term);
  }
  if (m.type == kPlastic) {
    const float kd = 1.0f - schlick(plastic_f0(m.param), dot(n, wi));
    pdf = kd * cos_term;
    return {kd * m.color.x * cos_term, kd * m.color.y * cos_term, kd * m.color.z * cos_term};
  }
  if (m.type == kPhong) {
    const float r_dot_wo = dot(reflect(wi, n), wo);
    float resp = 0.0f;
    if (r_dot_wo > 0.0f && dot(n, wo) > 0.0f) {
      resp = (m.param + 1.0f) * kHalfInvPi * powf(fmaxf(r_dot_wo, 1e-30f), m.param);
    }
    pdf = resp;
    return scale(m.color, resp);
  }
  pdf = 0.0f;
  return {0.0f, 0.0f, 0.0f};
}

// -- the kernel ---------------------------------------------------------------

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
  const float fi = (float)(pix % width);
  const float fj = (float)(pix / width);

  const V3 cam_o = load3(cam + 0);
  const V3 cam_tl = load3(cam + 3);
  const V3 cam_h = load3(cam + 6);
  const V3 cam_v = load3(cam + 9);
  const V3 background = load3(bg);

  V3 acc = {0.0f, 0.0f, 0.0f};
  for (int s = 0; s < n_pass; ++s) {
    uint32_t state = seed_ray((uint32_t)pix, sample_start + (uint32_t)s, seed);
    const float u1 = next_uniform(state);
    const float u2 = next_uniform(state);
    const float u = (fi + u1) / (float)width;
    const float v = (fj + u2) / (float)height;
    V3 dir = normalize({cam_tl.x + u * cam_h.x - v * cam_v.x - cam_o.x,
                        cam_tl.y + u * cam_h.y - v * cam_v.y - cam_o.y,
                        cam_tl.z + u * cam_h.z - v * cam_v.z - cam_o.z});
    V3 org = cam_o;
    V3 T = {1.0f, 1.0f, 1.0f};
    V3 L = {0.0f, 0.0f, 0.0f};
    float tnear = 0.0f;

    for (int depth = 0; depth < max_depth; ++depth) {
      float t, bu = 0.0f, bv = 0.0f;
      const int k = closest_hit(rows, S, P, org, dir, tnear, t, bu, bv);
      if (k < 0) {
        L = add(L, mul(T, background));
        break;
      }

      // hit reconstruction exactly as the TPU kernel and ops/shade.py
      const float* r = rows + k * kRow;
      V3 pos, ns_raw;
      if (k < S) {
        pos = add(org, scale(dir, t));
        ns_raw = sub(pos, load3(r + 1));
      } else {
        const V3 p0 = load3(r + 1);
        const V3 e1 = load3(r + 4);
        const V3 e2 = load3(r + 7);
        // barycentric, not org + t*dir, which self-shadows
        pos = add(add(p0, scale(e1, bu)), scale(e2, bv));
        if (r[28] > 0.5f) {
          const float w = 1.0f - bu - bv;
          ns_raw = add(add(scale(load3(r + 10), w), scale(load3(r + 13), bu)),
                       scale(load3(r + 16), bv));
        } else {
          ns_raw = cross(e1, e2);
        }
      }
      const Material mat = {(int)r[19], load3(r + 20), r[23]};

      const V3 ns = normalize(ns_raw);
      const V3 wi = neg(dir);
      const float cos_view = dot(wi, ns);
      if (r[27] > 0.0f && cos_view > 0.0f) L = add(L, mul(T, load3(r + 24)));
      const V3 n = cos_view < 0.0f ? neg(ns) : ns;

      if (NL > 0) {
        // point-light NEE: draws no RNG, so sample streams match NEE off
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

      const float su1 = next_uniform(state);
      const float su2 = next_uniform(state);
      const float su3 = next_uniform(state);
      bool is_spec;
      V3 weight;
      const V3 wo = sample_brdf(mat, n, wi, su1, su2, su3, is_spec, weight);
      V3 contrib;
      if (is_spec) {
        if (!(max3(weight) > 0.0f)) break;
        contrib = weight;
      } else {
        float pdf;
        const V3 value = eval_brdf(mat, n, wi, wo, pdf);
        if (!(max3(value) > 0.0f && pdf > 0.0f)) break;
        contrib = scale(value, 1.0f / pdf);
      }
      T = mul(T, contrib);
      org = pos;
      dir = wo;

      const float ru = next_uniform(state);
      if (depth > rr_start_depth) {
        const float p = fmaxf(0.5f, 1.0f - max3(T));
        if (ru < p) break;
        if (p < 1.0f) T = scale(T, 1.0f / (1.0f - p));
      }
      tnear = kSecondaryTnear;
    }
    acc = add(acc, L);
  }
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
