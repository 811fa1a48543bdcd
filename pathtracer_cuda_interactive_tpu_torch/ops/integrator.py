"""Masked wavefront path-tracing integrator in plain torch ops.

The port of ``pathtracer_cuda_interactive_tpu/ops/integrator.py``, the
reference's CUDA megakernel (``radiance()`` radiance.cuh:21-79 + the render
kernels main.cu:30-89) written as a loop over the whole ray batch with an
active-ray mask: miss, dead-throughput and Russian-roulette "breaks" clear
a ray's mask.  It is the plain version of the CUDA megakernel
(ops/megakernel.py): the CPU path, and what the kernel is held to on the
card.

Semantics matched to radiance.cuh line by line:
  * miss -> L += T * background, ray done            (radiance.cuh:27-30)
  * emissive hit, front-facing -> L += T * radiance  (radiance.cuh:35-43)
  * shading normal flipped toward the ray            (radiance.cuh:45-47)
  * pure-specular: T *= weight if max(weight) > 0 else done
  * otherwise: T *= value/pdf if max(value) > 0 and pdf > 0 else done
                                                     (radiance.cuh:49-63)
  * next ray tnear = 1e-4 (camera rays use 0)        (radiance.cuh:65)
  * Russian roulette after depth 5 with
    p = max(0.5, 1 - max(T))                         (radiance.cuh:68-74)
  * MAX_DEPTH = 50 bounces                           (radiance.cuh:12)

The closest hit dispatches as the JAX package's ``intersect_scene`` does:
brute force (ops/bruteforce.py) up to ``BRUTE_FORCE_MAX_PRIMS`` primitives,
the skip-link BVH walk (ops/trace.py) above that.  The renderer sends such
large scenes to the sorted wavefront (ops/wavefront.py) when they hold
triangles; this integrator is what that path is held to, and it renders the
large sphere-only scenes (the renderer's "plain" mode).
"""

from __future__ import annotations

import torch

from ..models.device_scene import DeviceScene
from . import brdf, camera, rng, shade
from .bruteforce import BRUTE_FORCE_MAX_PRIMS, intersect_brute, occluded_brute
from .trace import trace_occluded, trace_rays
from .vec import Vec3, dot, max_elem, where

MAX_DEPTH = 50          # radiance.cuh:12
RR_START_DEPTH = 5      # radiance.cuh:68
SECONDARY_TNEAR = 1e-4  # radiance.cuh:65


def intersect_scene(scene: DeviceScene, org: Vec3, dirn: Vec3, tnear):
    """Closest hit: brute force for small scenes, the BVH walk above
    ``BRUTE_FORCE_MAX_PRIMS``.  Returns (prim i32, -1 = miss; t)."""
    if scene.num_prims <= BRUTE_FORCE_MAX_PRIMS:
        return intersect_brute(scene, org, dirn, tnear)
    return trace_rays(scene.bvh_nodes, org, dirn, tnear)


def occluded(scene: DeviceScene, org: Vec3, dirn: Vec3, tnear, tfar):
    """Any hit on the segment (tnear, tfar): the NEE shadow test.  Brute
    force for small scenes, the BVH walk above ``BRUTE_FORCE_MAX_PRIMS``;
    the JAX package always walks the BVH (trace_occluded), whose boxes
    only cull primitives the segment misses, so the answers agree."""
    if scene.num_prims <= BRUTE_FORCE_MAX_PRIMS:
        return occluded_brute(scene, org, dirn, tnear, tfar)
    return trace_occluded(scene.bvh_nodes, org, dirn, tnear, tfar)


def _direct_point_lights(scene: DeviceScene, isect, n: Vec3, wi: Vec3,
                         mat, T: Vec3, active) -> Vec3:
    """Next-event estimation for point lights (the reference parses point
    lights but never samples them, SURVEY.md §3.5).  Deterministic (no RNG
    draws), so enabling it leaves every sample stream bit-identical.

    The shadow test is ``occluded``.  Returns the direct-lighting radiance
    to add."""
    num = int(scene.light_pos.shape[0])
    shape = wi.x.shape
    out = Vec3.zeros(shape, device=wi.x.device)
    for l in range(num):
        lp = Vec3(scene.light_pos[l, 0], scene.light_pos[l, 1],
                  scene.light_pos[l, 2])
        d = lp - isect.position
        dist2 = dot(d, d)
        dist = torch.sqrt(dist2)
        wo = d * (1.0 / torch.clamp_min(dist, 1e-20))
        ev = brdf.eval_brdf(mat, n, wi, wo)   # value includes cos/pi terms
        occ = occluded(scene, isect.position, wo, SECONDARY_TNEAR,
                       dist * (1.0 - 1e-3))
        inten = Vec3(scene.light_intensity[l, 0],
                     scene.light_intensity[l, 1],
                     scene.light_intensity[l, 2])
        contrib = T * ev.value * inten * (1.0 / torch.clamp_min(dist2, 1e-20))
        take = active & ~occ
        out = out + where(take, contrib, Vec3.zeros(shape, device=wi.x.device))
    return out


def _bounce(scene: DeviceScene, org, dirn, T, L, active, tnear, state,
            rr_depth, nee: bool = False,
            rr_start_depth: int = RR_START_DEPTH):
    """One bounce for every ray.  rr_depth: the bounce index for RR
    gating, or None to disable RR.  nee: sample point lights at every
    hit."""
    prim, _t = intersect_scene(scene, org, dirn, tnear)
    zeros = Vec3.zeros(prim.shape, device=prim.device)

    miss = prim < 0
    take_bg = active & miss
    L = L + where(take_bg, T * scene.background, zeros)
    active = active & ~miss

    isect = shade.shade_setup(scene, prim, org, dirn, tnear)
    wi = -dirn
    cos_view = dot(wi, isect.shading_normal)

    front_emit = active & isect.is_emitter & (cos_view > 0.0)
    L = L + where(front_emit, T * isect.emission, zeros)

    n = where(cos_view < 0.0, -isect.shading_normal, isect.shading_normal)

    mat = brdf.lookup_materials(scene, isect.material_id)

    if nee and int(scene.light_pos.shape[0]) > 0:
        L = L + _direct_point_lights(scene, isect, n, wi, mat, T, active)

    samp = brdf.sample_brdf(mat, n, wi, state)
    state = samp.state
    ev = brdf.eval_brdf(mat, n, wi, samp.wo)

    ok_spec = max_elem(samp.weight) > 0.0
    ok_scatter = (max_elem(ev.value) > 0.0) & (ev.pdf > 0.0)
    pdf_safe = torch.where(ev.pdf > 0.0, ev.pdf, 1.0)
    contrib = where(samp.is_pure_specular, samp.weight,
                    ev.value * (1.0 / pdf_safe))
    ok = torch.where(samp.is_pure_specular, ok_spec, ok_scatter)

    upd = active & ok
    T = where(upd, T * contrib, T)
    active = active & ok

    org = where(active, isect.position, org)
    dirn = where(active, samp.wo, dirn)
    tnear = torch.full_like(prim, SECONDARY_TNEAR, dtype=torch.float32)

    # Russian roulette (radiance.cuh:68-74); the draw always happens so the
    # RNG streams of RR and no-RR variants stay aligned.
    state, u = rng.next_uniform(state)
    if rr_depth is not None and rr_depth > rr_start_depth:
        p = torch.clamp_min(1.0 - max_elem(T), 0.5)
        kill = u < p
        scale = 1.0 / torch.where(~kill & (p < 1.0), 1.0 - p, 1.0)
        T = where(active & ~kill, T * scale, T)
        active = active & ~kill

    return org, dirn, T, L, active, tnear, state


def radiance(scene: DeviceScene, org: Vec3, dirn: Vec3,
             state: torch.Tensor, max_depth: int = MAX_DEPTH,
             nee: bool = False,
             rr_start_depth: int = RR_START_DEPTH) -> Vec3:
    """Path-traced radiance for a batch of rays.  org/dirn: Vec3 of one
    shape; state: int32 RNG states of that shape.  Returns Vec3."""
    L, _ = radiance_with_ray_count(scene, org, dirn, state, max_depth, nee,
                                   rr_start_depth)
    return L


def radiance_with_ray_count(scene: DeviceScene, org: Vec3, dirn: Vec3,
                            state: torch.Tensor, max_depth: int = MAX_DEPTH,
                            nee: bool = False,
                            rr_start_depth: int = RR_START_DEPTH):
    """radiance() plus the number of rays traced (the camera ray and every
    surviving bounce ray; NEE shadow rays not counted).  The loop stops
    after ``max_depth`` bounces or once every ray is done."""
    shape = state.shape
    dev = state.device
    L = Vec3.zeros(shape, device=dev)
    T = Vec3.full(shape, (1.0, 1.0, 1.0), device=dev)
    active = torch.ones(shape, dtype=torch.bool, device=dev)
    tnear = torch.zeros(shape, dtype=torch.float32, device=dev)
    nrays = torch.zeros((), dtype=torch.float32, device=dev)
    for depth in range(max_depth):
        if not bool(active.any()):
            break
        nrays = nrays + active.sum(dtype=torch.float32)
        org, dirn, T, L, active, tnear, state = _bounce(
            scene, org, dirn, T, L, active, tnear, state, depth, nee,
            rr_start_depth)
    return L, nrays


def radiance_fixed(scene: DeviceScene, org: Vec3, dirn: Vec3,
                   state: torch.Tensor, num_bounces: int,
                   use_rr: bool = True, nee: bool = False,
                   rr_start_depth: int = RR_START_DEPTH) -> Vec3:
    """Bounded-depth radiance for autograd (grad/inverse.py): exactly
    ``num_bounces`` calls of ``_bounce`` in a Python loop, with no early
    exit, so torch records every bounce.  ``use_rr=False`` turns Russian
    roulette off (its draw still happens).  With ``use_rr=True`` and
    ``num_bounces <= RR_START_DEPTH + 1`` it equals ``radiance`` at
    ``max_depth=num_bounces`` bit for bit."""
    shape = state.shape
    dev = state.device
    L = Vec3.zeros(shape, device=dev)
    T = Vec3.full(shape, (1.0, 1.0, 1.0), device=dev)
    active = torch.ones(shape, dtype=torch.bool, device=dev)
    tnear = torch.zeros(shape, dtype=torch.float32, device=dev)
    for depth in range(num_bounces):
        org, dirn, T, L, active, tnear, state = _bounce(
            scene, org, dirn, T, L, active, tnear, state,
            depth if use_rr else None, nee, rr_start_depth)
    return L


def measure_path_stats(scene: DeviceScene, cam_data: torch.Tensor,
                       width: int, height: int, sample_start: int,
                       num_samples: int = 1, seed: int = 1984,
                       max_depth: int = MAX_DEPTH, nee: bool = False,
                       rr_start_depth: int = RR_START_DEPTH):
    """(total_rays, total_samples) over a frame; the average path length
    is their ratio.  Path length is a property of the scene and the
    integrator's semantics, not of the compute path, so this count applies
    to the megakernel too."""
    pix = _pixel_grid(width, height, cam_data.device)
    i = (pix % width).to(torch.float32)
    j = (pix // width).to(torch.float32)
    total = torch.zeros((), dtype=torch.float32, device=cam_data.device)
    for k in range(num_samples):
        state = rng.seed_rays(pix, sample_start + k, seed)
        state, u1 = rng.next_uniform(state)
        state, u2 = rng.next_uniform(state)
        org, dirn = camera.generate_primary_rays(
            cam_data, (i + u1) / width, (j + u2) / height)
        _, nrays = radiance_with_ray_count(scene, org, dirn, state,
                                           max_depth, nee, rr_start_depth)
        total = total + nrays
    return total, float(width * height * num_samples)


def _pixel_grid(width: int, height: int, device) -> torch.Tensor:
    """Flat pixel indices [W*H] (int32)."""
    return torch.arange(width * height, dtype=torch.int32, device=device)


def render_pixel_sums(scene: DeviceScene, cam_data: torch.Tensor,
                      pix: torch.Tensor, width: int, height: int,
                      sample_start: int, num_samples: int = 1,
                      seed: int = 1984, max_depth: int = MAX_DEPTH,
                      nee: bool = False,
                      rr_start_depth: int = RR_START_DEPTH,
                      num_real=None) -> torch.Tensor:
    """Sample loop over an explicit batch of flat pixel indices ``pix``
    (int32, any shape).  Returns the per-pixel radiance sum of the first
    ``num_real`` (None: all) of ``num_samples`` passes, shaped
    pix.shape + (3,)."""
    i = (pix % width).to(torch.float32)
    j = (pix // width).to(torch.float32)
    n_passes = num_samples if num_real is None else min(num_real, num_samples)
    acc = torch.zeros(pix.shape + (3,), dtype=torch.float32,
                      device=pix.device)
    for k in range(n_passes):
        state = rng.seed_rays(pix, sample_start + k, seed)
        state, u1 = rng.next_uniform(state)
        state, u2 = rng.next_uniform(state)
        u = (i + u1) / width
        v = (j + u2) / height
        org, dirn = camera.generate_primary_rays(cam_data, u, v)
        L = radiance(scene, org, dirn, state, max_depth, nee, rr_start_depth)
        acc = acc + L.to_array()
    return acc


def render_samples(scene: DeviceScene, cam_data: torch.Tensor, width: int,
                   height: int, sample_start: int, num_samples: int = 1,
                   seed: int = 1984, max_depth: int = MAX_DEPTH,
                   nee: bool = False,
                   rr_start_depth: int = RR_START_DEPTH) -> torch.Tensor:
    """Render ``num_samples`` full-image sample passes and return their SUM
    [H, W, 3] (the newSamples loop of render_progressive, main.cu:74-80).
    ``sample_start`` decorrelates RNG streams across frames."""
    pix = _pixel_grid(width, height, cam_data.device)
    acc = render_pixel_sums(scene, cam_data, pix, width, height,
                            sample_start, num_samples, seed, max_depth, nee,
                            rr_start_depth)
    return acc.reshape(height, width, 3)
