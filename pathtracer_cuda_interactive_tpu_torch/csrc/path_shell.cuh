// The render shell of the small-scene megakernel (csrc/megakernel.cu, B1):
// the counterpart of the JAX package's
// ops/megakernel.py::make_persistent_kernel.  One thread renders one pixel
// and takes its samples one after another: per sample a camera ray with
// jitter, then the radiance.cuh:21-79 bounce logic with Russian roulette
// after rr_start_depth and a depth cap.  The RNG streams and draw order are
// those of ops/integrator.py: 2 camera draws, then 3 BSDF draws and 1
// roulette draw per bounce that hits.
//
// What bounds it on the card is the divergence of a warp's 32 paths: a sample
// takes 5.7 rays on average under a depth cap of 50.  What the design does
// about it: samples and bounces are ONE flat loop, so a lane whose path ends
// starts its pixel's next sample in the next round instead of waiting for its
// warp's longest path, and all 32 lanes of a warp reach every closest hit and
// every shadow test together, which lets a scene type answer them with the
// whole warp (shuffles and votes name the full warp; a lane without a ray
// passes active = false and stays in the loop until the warp is done).  A
// pixel's sum is still acc + L for s = 0, 1, ... in order and the RNG is
// keyed by (pixel, sample, seed), so an image is the same from run to run and
// the same as under a loop over bounces nested in a loop over samples.  The
// camera is read once a sample, not held in registers over the bounces.
//
// The persistent brick render (csrc/brick_render.cu, B6) takes only the
// camera rays from here.  Its own flat loop has no direct light and keeps the
// camera in registers; on this shell it measured 1.23 times slower (PERF.md),
// so the two stay apart.
//
// A scene type supplies, for all 32 lanes of a warp together:
//   bool closest(bool active, V3 org, V3 dir, float tnear, HitRecord& rec) const;
//   static constexpr bool kDirect;   // whether it has a direct light
//   void add_direct(bool active, V3& L, V3 pos, V3 n, V3 wi,
//                   const Material& m, V3 T) const;
#pragma once

#include "pt_common.cuh"

namespace pt {

struct CameraRays {
  V3 origin, top_left, horizontal, vertical;
};

__device__ __forceinline__ CameraRays load_camera(const float* cam) {
  return {load3(cam + 0), load3(cam + 3), load3(cam + 6), load3(cam + 9)};
}

// A bounce's first part, before the direct light: the emitter seen from its
// front adds to L; gives the material, the normal turned to the viewer and
// the direction back along the ray.
__device__ __forceinline__ void shade_hit(const HitRecord& rec, V3 dir, V3 T, V3& L,
                                          Material& mat, V3& n, V3& wi) {
  mat = record_to_material(rec);
  const V3 ns = normalize(rec.ns);
  wi = neg(dir);
  const float cos_view = dot(wi, ns);
  if (rec.emit > 0.0f && cos_view > 0.0f) L = add(L, mul(T, rec.emission));
  n = cos_view < 0.0f ? neg(ns) : ns;
}

// A bounce's second part: samples the BSDF, updates the path and plays
// roulette.  Returns whether the path goes on.
__device__ __forceinline__ bool scatter(const HitRecord& rec, const Material& mat, V3 n, V3 wi,
                                        uint32_t& state, V3& org, V3& dir, V3& T, int depth,
                                        int rr_start_depth) {
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
// pix = (fi, fj) of a width x height image; a lane with has_pixel = false
// renders nothing; cam_data holds the camera's 12 floats (origin, top left,
// horizontal, vertical) and background 3.  All 32 lanes of a warp call it
// together.
template <class Scene>
__device__ __forceinline__ V3 pixel_sums(const Scene& scene, const float* cam_data,
                                         const float* background, bool has_pixel, uint32_t pix,
                                         float fi, float fj, int width, int height,
                                         uint32_t sample_start, int n_pass, uint32_t seed,
                                         int max_depth, int rr_start_depth) {
  V3 acc = {0.0f, 0.0f, 0.0f};
  V3 org = acc, dir = acc, T = acc, L = acc;
  uint32_t state = 0;
  float tnear = 0.0f;
  int s = 0, depth = 0;
  bool in_path = false;
  while (true) {
    if (!in_path && has_pixel && s < n_pass) {
      // read here, once a sample, and not held in registers over the bounces
      const CameraRays cam = load_camera(cam_data);
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
    const bool hit = scene.closest(in_path, org, dir, tnear, rec);
    Material mat;
    V3 n, wi;
    if (hit) shade_hit(rec, dir, T, L, mat, n, wi);
    // draws no RNG, so sample streams match with the direct light off
    if constexpr (Scene::kDirect) scene.add_direct(hit, L, rec.pos, n, wi, mat, T);
    if (!in_path) continue;
    bool go_on = false;
    if (hit) {
      go_on = scatter(rec, mat, n, wi, state, org, dir, T, depth, rr_start_depth) &&
              ++depth < max_depth;
      tnear = kSecondaryTnear;
    } else {
      L = add(L, mul(T, load3(background)));
    }
    if (!go_on) {
      acc = add(acc, L);
      ++s;
      in_path = false;
    }
  }
  return acc;
}

}  // namespace pt
