// The render shell shared by the full-render kernels, the small-scene
// megakernel (csrc/megakernel.cu, B1) and the persistent brick render
// (csrc/brick_render.cu, B6): the counterpart of the JAX package's
// ops/megakernel.py::make_persistent_kernel.  One thread renders one pixel
// and loops over its samples one after another: per sample a camera ray
// with jitter, then the radiance.cuh:21-79 bounce logic with Russian
// roulette after rr_start_depth and a depth cap.  The RNG streams and draw
// order are those of ops/integrator.py: 2 camera draws, then 3 BSDF draws
// and 1 roulette draw per bounce that hits.
//
// A scene type supplies the closest hit and the optional direct light:
//   bool closest(V3 org, V3 dir, float tnear, HitRecord& rec) const;
//   void add_direct(V3& L, V3 pos, V3 n, V3 wi, const Material& m, V3 T) const;
#pragma once

#include "pt_common.cuh"

namespace pt {

struct CameraRays {
  V3 origin, top_left, horizontal, vertical;
};

__device__ __forceinline__ CameraRays load_camera(const float* cam) {
  return {load3(cam + 0), load3(cam + 3), load3(cam + 6), load3(cam + 9)};
}

// Radiance sum of passes sample_start .. sample_start + n_pass - 1 of pixel
// pix = (fi, fj) of a width x height image.
template <class Scene>
__device__ __forceinline__ V3 pixel_radiance_sum(const Scene& scene, const CameraRays& cam,
                                                 V3 background, uint32_t pix, float fi,
                                                 float fj, int width, int height,
                                                 uint32_t sample_start, int n_pass,
                                                 uint32_t seed, int max_depth,
                                                 int rr_start_depth) {
  V3 acc = {0.0f, 0.0f, 0.0f};
  for (int s = 0; s < n_pass; ++s) {
    uint32_t state = seed_ray(pix, sample_start + (uint32_t)s, seed);
    const float u1 = next_uniform(state);
    const float u2 = next_uniform(state);
    const float u = (fi + u1) / (float)width;
    const float v = (fj + u2) / (float)height;
    V3 dir = normalize({cam.top_left.x + u * cam.horizontal.x - v * cam.vertical.x - cam.origin.x,
                        cam.top_left.y + u * cam.horizontal.y - v * cam.vertical.y - cam.origin.y,
                        cam.top_left.z + u * cam.horizontal.z - v * cam.vertical.z - cam.origin.z});
    V3 org = cam.origin;
    V3 T = {1.0f, 1.0f, 1.0f};
    V3 L = {0.0f, 0.0f, 0.0f};
    float tnear = 0.0f;

    for (int depth = 0; depth < max_depth; ++depth) {
      HitRecord rec;
      if (!scene.closest(org, dir, tnear, rec)) {
        L = add(L, mul(T, background));
        break;
      }
      const Material mat = record_to_material(rec);
      const V3 ns = normalize(rec.ns);
      const V3 wi = neg(dir);
      const float cos_view = dot(wi, ns);
      if (rec.emit > 0.0f && cos_view > 0.0f) L = add(L, mul(T, rec.emission));
      const V3 n = cos_view < 0.0f ? neg(ns) : ns;

      // draws no RNG, so sample streams match with the direct light off
      scene.add_direct(L, rec.pos, n, wi, mat, T);

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
      org = rec.pos;
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
  return acc;
}

}  // namespace pt
