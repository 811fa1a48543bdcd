// Device code shared by the package's kernels (csrc/*.cu): vector math, the
// PCG generator, the sphere and triangle tests, the 16-channel hit record
// and the BSDF.  Each function repeats its plain torch version op for op
// (ops/vec.py, ops/rng.py, ops/geometry.py, ops/brdf.py); the kernels are
// built with --fmad=false and no fast math, so the two agree to the ulps of
// the transcendentals (cosf, sinf, powf), and the RNG is bit-exact.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pt {

constexpr int kRow = 32;        // floats per primitive record (device_scene.py)
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

// Moller-Trumbore on p0, e1 = p1 - p0, e2 = p2 - p0
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

// -- the hit record ----------------------------------------------------------

// The 16 channels of the JAX package's full closest-hit record (ops/
// brickkernel.py::_select16): t (inf on a miss), the raw shading normal, the
// hit position, then the material fields of the primitive's record.
struct HitRecord {
  float t;
  V3 ns;
  V3 pos;
  float mtype;
  V3 albedo;
  float mparam;
  V3 emission;
  float emit;
};

__device__ __forceinline__ HitRecord miss_record() {
  const V3 z = {0.0f, 0.0f, 0.0f};
  return {INFINITY, z, z, 0.0f, z, 0.0f, z, 0.0f};
}

__device__ __forceinline__ void record_material(const float* r, HitRecord& h) {
  h.mtype = r[19];
  h.albedo = load3(r + 20);
  h.mparam = r[23];
  h.emission = load3(r + 24);
  h.emit = r[27];
}

// a sphere hit at t: position org + t dir, normal from the centre
__device__ __forceinline__ HitRecord sphere_record(const float* r, V3 org, V3 dir, float t) {
  HitRecord h;
  h.t = t;
  h.pos = add(org, scale(dir, t));
  h.ns = sub(h.pos, load3(r + 1));
  record_material(r, h);
  return h;
}

// a triangle hit at barycentric (u, v) of its own test: the position from
// the barycentrics (org + t dir self-shadows), the interpolated corner
// normals of a smooth triangle or the geometric normal of a flat one
__device__ __forceinline__ HitRecord triangle_record(const float* r, float t, float u, float v) {
  HitRecord h;
  h.t = t;
  const V3 p0 = load3(r + 1);
  const V3 e1 = load3(r + 4);
  const V3 e2 = load3(r + 7);
  h.pos = add(add(p0, scale(e1, u)), scale(e2, v));
  if (r[28] > 0.5f) {
    const float w = 1.0f - u - v;
    h.ns = add(add(scale(load3(r + 10), w), scale(load3(r + 13), u)), scale(load3(r + 16), v));
  } else {
    h.ns = cross(e1, e2);
  }
  record_material(r, h);
  return h;
}

// -- BSDF (ops/brdf.py) -------------------------------------------------------

struct Material {
  int type;
  V3 color;
  float param;
};

__device__ __forceinline__ Material record_to_material(const HitRecord& h) {
  return {(int)h.mtype, h.albedo, h.mparam};
}

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

}  // namespace pt
