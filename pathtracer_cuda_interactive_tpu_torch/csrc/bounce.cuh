// One bounce of a path that hit a surface, shared by the persistent brick
// render (csrc/brick_render.cu, B6) and the wavefront's shading kernel
// (csrc/wave_step.cu, W2): the bounce of csrc/path_shell.cuh (radiance.cuh:
// 21-79) without a direct light, op for op ops/wavefront.py::_shade for a ray
// that hit.
#pragma once

#include "pt_common.cuh"

namespace pt {

// Updates the path that hit `rec` and returns whether it goes on.  It draws
// four uniforms whatever happens, the three of the BSDF and the roulette's, as
// _shade does for every ray; a path that ends drops its state, so where the
// roulette's draw falls does not change a path's result.
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
  const float ru = next_uniform(state);
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

  if (depth > rr_start_depth) {
    const float p = fmaxf(0.5f, 1.0f - max3(T));
    if (ru < p) return false;
    if (p < 1.0f) T = scale(T, 1.0f / (1.0f - p));
  }
  return true;
}

}  // namespace pt
