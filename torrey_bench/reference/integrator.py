"""Masked wavefront path-tracing integrator in plain torch ops.

Frozen from the PyTorch port's ``ops/integrator.py``, the
reference's CUDA megakernel (``radiance()`` radiance.cuh:21-79 + the render
kernels main.cu:30-89) written as a loop over the whole ray batch with an
active-ray mask: miss, dead-throughput and Russian-roulette "breaks" clear
a ray's mask.  In the port it is the plain version of the CUDA
megakernel; here it is the benchmark's reference.

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

The closest hit is brute force (bruteforce.py) up to
``BRUTE_FORCE_MAX_PRIMS`` primitives and the skip-link BVH walk (trace.py)
over the reference's own tree above that.

``pixel_sample_sums`` is the benchmark's entry: every (pixel, sample) pair
of a set of pixels and a sample range as one batch of independent paths,
each with its own RNG stream keyed by pixel and sample index, the batch
compacted to its live paths after every bounce (a path's arithmetic does
not depend on the others, so the sums are those of the frame-by-frame
loop).  ``store_dtype`` rounds every path's state through a narrower float
type after each bounce: the benchmark's control.
"""

from __future__ import annotations

import numpy as np
import torch

from .device_scene import DeviceScene
from . import brdf, camera, rng, shade
from . import geometry as g
from .bruteforce import BRUTE_FORCE_MAX_PRIMS, intersect_brute, occluded_brute
from .scenepack import KIND_INTERNAL, KIND_SPHERE, KIND_TRI
from .trace import COMPACT_STEPS, trace_occluded, trace_rays, walk_step
from .vec import Vec3, dot, max_elem, where

MAX_DEPTH = 50          # radiance.cuh:12
RR_START_DEPTH = 5      # radiance.cuh:68
SECONDARY_TNEAR = 1e-4  # radiance.cuh:65


def intersect_scene(scene: DeviceScene, org: Vec3, dirn: Vec3, tnear,
                    counts=None):
    """Closest hit: brute force for small scenes, the BVH walk above
    ``BRUTE_FORCE_MAX_PRIMS``.  Returns (prim i32, -1 = miss; t).
    ``counts``, a dict, gets the box, triangle and sphere tests made added
    under "box", "tri" and "sphere"."""
    if scene.num_prims <= BRUTE_FORCE_MAX_PRIMS:
        if counts is not None:
            n = int(org.x.numel())
            counts["tri"] = counts.get("tri", 0) + n * scene.num_triangles
            counts["sphere"] = (counts.get("sphere", 0)
                                + n * scene.num_spheres)
        return intersect_brute(scene, org, dirn, tnear)
    return trace_rays(scene.bvh_nodes, org, dirn, tnear)


def occluded(scene: DeviceScene, org: Vec3, dirn: Vec3, tnear, tfar,
             counts=None):
    """Any hit on the segment (tnear, tfar): the NEE shadow test.  Brute
    force for small scenes, the BVH walk above ``BRUTE_FORCE_MAX_PRIMS``.
    ``counts``, a dict, gets the shadow rays traced added under
    "shadow_rays", and the box, triangle and sphere tests of their search
    under "shadow_box", "shadow_tri" and "shadow_sphere"."""
    if counts is not None:
        _add(counts, shadow_rays=int(org.x.numel()))
    if scene.num_prims <= BRUTE_FORCE_MAX_PRIMS:
        if counts is not None:      # every primitive, no early exit
            n = int(org.x.numel())
            _add(counts, shadow_tri=n * scene.num_triangles,
                 shadow_sphere=n * scene.num_spheres)
        return occluded_brute(scene, org, dirn, tnear, tfar)
    tests = None if counts is None else {}
    occ = trace_occluded(scene.bvh_nodes, org, dirn, tnear, tfar, tests)
    if counts is not None:
        _add(counts, **{f"shadow_{k}": v for k, v in tests.items()})
    return occ


def _add(counts: dict, **more) -> None:
    for key, value in more.items():
        counts[key] = counts.get(key, 0) + value


def _direct_point_lights(scene: DeviceScene, isect, n: Vec3, wi: Vec3,
                         mat, T: Vec3, active, counts=None) -> Vec3:
    """Next-event estimation for point lights (the reference parses point
    lights but never samples them, SURVEY.md §3.5).  Deterministic (no RNG
    draws), so enabling it leaves every sample stream bit-identical.

    The shadow test is ``occluded``, over the ``active`` rays alone (those
    that hit: no other ray adds direct light), as one batch ``[n]``; each
    ray's answer is its own, whatever else the batch holds.  ``counts``:
    as in ``occluded``.  Returns the direct-lighting radiance to add."""
    num = int(scene.light_pos.shape[0])
    shape = wi.x.shape
    out = Vec3.zeros(shape, device=wi.x.device)
    hits = active.nonzero().squeeze(1)
    for l in range(num):
        lp = Vec3(scene.light_pos[l, 0], scene.light_pos[l, 1],
                  scene.light_pos[l, 2])
        d = lp - isect.position
        dist2 = dot(d, d)
        dist = torch.sqrt(dist2)
        wo = d * (1.0 / torch.clamp_min(dist, 1e-20))
        ev = brdf.eval_brdf(mat, n, wi, wo)   # value includes cos/pi terms
        occ = torch.zeros(shape, dtype=torch.bool, device=wi.x.device)
        if hits.numel():
            occ.index_copy_(0, hits, occluded(
                scene, _take(isect.position, hits), _take(wo, hits),
                SECONDARY_TNEAR, (dist * (1.0 - 1e-3)).index_select(0, hits),
                counts))
        inten = Vec3(scene.light_intensity[l, 0],
                     scene.light_intensity[l, 1],
                     scene.light_intensity[l, 2])
        contrib = T * ev.value * inten * (1.0 / torch.clamp_min(dist2, 1e-20))
        take = active & ~occ
        out = out + where(take, contrib, Vec3.zeros(shape, device=wi.x.device))
    return out


def _bounce(scene: DeviceScene, org, dirn, T, L, active, tnear, state,
            rr_depth, nee: bool = False,
            rr_start_depth: int = RR_START_DEPTH, counts=None):
    """One bounce for every ray.  rr_depth: the bounce index for RR
    gating, or None to disable RR.  nee: sample point lights at every
    hit.  counts: as in ``intersect_scene``."""
    prim, _t = intersect_scene(scene, org, dirn, tnear, counts)
    rr_on = torch.full_like(active, rr_depth is not None
                            and rr_depth > rr_start_depth)
    return _shade(scene, prim, org, dirn, T, L, active, tnear, state, rr_on,
                  nee, counts)


def _shade(scene: DeviceScene, prim, org, dirn, T, L, active, tnear, state,
           rr_on, nee: bool = False, counts=None):
    """The bounce after the closest hit ``prim``: emission, point lights
    where ``nee`` (their shadow tests counted into ``counts``, as in
    ``occluded``), the BSDF sample, Russian roulette where ``rr_on`` (a
    per-ray mask; the draw always happens).  Returns (org, dirn, T, L,
    active, tnear, state)."""
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
        L = L + _direct_point_lights(scene, isect, n, wi, mat, T, active,
                                     counts)

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
    p = torch.clamp_min(1.0 - max_elem(T), 0.5)
    kill = (u < p) & rr_on
    scale = 1.0 / torch.where(~kill & (p < 1.0) & rr_on, 1.0 - p, 1.0)
    T = where(active & ~kill, T * scale, T)
    active = active & ~kill

    return org, dirn, T, L, active, tnear, state


def _take(v: Vec3, idx) -> Vec3:
    return Vec3(*(x.index_select(0, idx) for x in v))


def _round(v: Vec3, dtype) -> Vec3:
    return Vec3(*(c.to(dtype).to(torch.float32) for c in v))


@torch.no_grad()
def _paths(scene: DeviceScene, cam_data: torch.Tensor, pix: torch.Tensor,
           samp: torch.Tensor, width: int, height: int, seed: int,
           max_depth: int, rr_start_depth: int, nee: bool, store_dtype,
           counts) -> torch.Tensor:
    """Radiance [n, 3] of the paths of pixels ``pix`` at sample indices
    ``samp`` (int tensors of one shape [n])."""
    state = rng.seed_rays(pix, samp, seed)
    state, u1 = rng.next_uniform(state)
    state, u2 = rng.next_uniform(state)
    i = (pix % width).to(torch.float32)
    j = (pix // width).to(torch.float32)
    org, dirn = camera.generate_primary_rays(cam_data, (i + u1) / width,
                                             (j + u2) / height)
    if store_dtype is not None:
        org, dirn = _round(org, store_dtype), _round(dirn, store_dtype)
    if scene.num_prims > BRUTE_FORCE_MAX_PRIMS:
        return _paths_walk(scene, org, dirn, state, max_depth,
                           rr_start_depth, nee, store_dtype, counts)
    n = int(pix.numel())
    dev = pix.device
    out = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    L = Vec3.zeros((n,), device=dev)
    T = Vec3.full((n,), (1.0, 1.0, 1.0), device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    tnear = torch.zeros((n,), dtype=torch.float32, device=dev)
    ids = torch.arange(n, device=dev)
    for depth in range(max_depth):
        if counts is not None:
            counts["rays"] = counts.get("rays", 0) + int(ids.numel())
        org, dirn, T, L, active, tnear, state = _bounce(
            scene, org, dirn, T, L, active, tnear, state, depth, nee,
            rr_start_depth, counts)
        if store_dtype is not None:
            org, dirn = _round(org, store_dtype), _round(dirn, store_dtype)
            T, L = _round(T, store_dtype), _round(L, store_dtype)
        if depth + 1 == max_depth:
            out.index_copy_(0, ids, L.to_array())
            break
        fin = (~active).nonzero().squeeze(1)
        if fin.numel():
            out.index_copy_(0, ids[fin], L.to_array()[fin])
            keep = active.nonzero().squeeze(1)
            if not keep.numel():
                break
            ids, active, tnear, state = (v.index_select(0, keep) for v in
                                         (ids, active, tnear, state))
            org, dirn, T, L = (_take(v, keep) for v in (org, dirn, T, L))
    return out


@torch.no_grad()
def _paths_walk(scene: DeviceScene, org: Vec3, dirn: Vec3, state, max_depth,
                rr_start_depth, nee, store_dtype, counts) -> torch.Tensor:
    """Radiance [n, 3] of the paths of ``n`` camera rays over the BVH, all
    paths in one loop of walk steps: each step advances every path's
    current ray by one node (trace.py's walk, op for op); every
    ``COMPACT_STEPS`` steps the paths whose ray's walk ended are shaded
    (``_shade``, Russian roulette by each path's own depth) and start their
    next ray's walk, and the paths that ended leave the batch.  A path's
    arithmetic is that of the bounce-by-bounce loop; the loop runs as many
    steps as the longest path walks in all, not the sum over bounces of the
    longest walk."""
    nodes = scene.bvh_nodes.contiguous()
    ints = nodes.view(torch.int32)
    N = int(nodes.shape[0])
    n = int(org.x.numel())
    dev = nodes.device
    inf = float("inf")
    out = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    pid = torch.arange(n, device=dev)
    depth = torch.zeros(n, dtype=torch.int32, device=dev)
    T = Vec3.full((n,), (1.0, 1.0, 1.0), device=dev)
    # written in place below: three tensors, not Vec3.zeros's one
    L = Vec3.full((n,), (0.0, 0.0, 0.0), device=dev)
    org, dirn = (Vec3(*(x.clone() for x in v)) for v in (org, dirn))
    tn = torch.zeros(n, dtype=torch.float32, device=dev)
    inv = Vec3(1.0 / dirn.x, 1.0 / dirn.y, 1.0 / dirn.z)
    t_max = torch.full((n,), inf, dtype=torch.float32, device=dev)
    hit = torch.full((n,), -1, dtype=torch.int32, device=dev)
    cur = torch.zeros(n, dtype=torch.int64, device=dev)
    tests = torch.zeros(3, dtype=torch.int64, device=dev)
    kinds = torch.tensor([KIND_INTERNAL, KIND_TRI, KIND_SPHERE],
                         dtype=torch.int32, device=dev)
    rays = n
    step = 0
    while pid.numel():
        cur, t_max, hit, kind, walking = walk_step(
            nodes, ints, cur, org, dirn, inv, tn, t_max, hit)
        if counts is not None:
            tests += ((kind[None] == kinds[:, None])
                      & walking[None]).sum(dim=1)
        step += 1
        if step % COMPACT_STEPS:
            continue
        done = cur >= N
        if not int(done.sum()):             # the one host read a block
            continue
        f = done.nonzero().squeeze(1)
        o2, d2, T2, L2, active, _, st2 = _shade(
            scene, hit.index_select(0, f), _take(org, f), _take(dirn, f),
            _take(T, f), _take(L, f),
            torch.ones(f.shape, dtype=torch.bool, device=dev),
            tn.index_select(0, f), state.index_select(0, f),
            depth.index_select(0, f) > rr_start_depth, nee, counts)
        if store_dtype is not None:
            o2, d2, T2, L2 = (_round(v, store_dtype)
                              for v in (o2, d2, T2, L2))
        d_next = depth.index_select(0, f) + 1
        ended = ~active | (d_next >= max_depth)
        e = ended.nonzero().squeeze(1)
        out.index_copy_(0, pid.index_select(0, f.index_select(0, e)),
                        L2.to_array().index_select(0, e))
        go = (~ended).nonzero().squeeze(1)
        slots = f.index_select(0, go)
        rays += int(go.numel())
        for dst, src in ((org, o2), (dirn, d2), (T, T2), (L, L2)):
            for x, y in zip(dst, _take(src, go)):
                x.index_copy_(0, slots, y)
        d_go = _take(d2, go)
        for x, y in zip(inv, (1.0 / d_go.x, 1.0 / d_go.y, 1.0 / d_go.z)):
            x.index_copy_(0, slots, y)
        state.index_copy_(0, slots, st2.index_select(0, go))
        depth.index_copy_(0, slots, d_next.index_select(0, go))
        tn.index_fill_(0, slots, SECONDARY_TNEAR)
        t_max.index_fill_(0, slots, inf)
        hit.index_fill_(0, slots, -1)
        cur.index_fill_(0, slots, 0)
        keep = torch.ones_like(walking)
        keep[f.index_select(0, e)] = False
        keep = keep.nonzero().squeeze(1)
        pid, depth, tn, t_max, hit, cur, state = (
            v.index_select(0, keep)
            for v in (pid, depth, tn, t_max, hit, cur, state))
        org, dirn, inv, T, L = (_take(v, keep)
                                for v in (org, dirn, inv, T, L))
    if counts is not None:
        counts["rays"] = counts.get("rays", 0) + rays
        for key, value in zip(("box", "tri", "sphere"), tests.tolist()):
            counts[key] = counts.get(key, 0) + value
    return out


def pixel_sample_sums(scene: DeviceScene, cam_data: torch.Tensor,
                      pix: np.ndarray, width: int, height: int,
                      sample_start: int, num_samples: int, seed: int,
                      max_depth: int = MAX_DEPTH,
                      rr_start_depth: int = RR_START_DEPTH,
                      nee: bool = False, store_dtype=None,
                      batch: int = 1 << 22, counts=None):
    """Per-pixel sums over samples ``sample_start`` .. ``+ num_samples``
    of the flat pixels ``pix`` ([P] ints): (radiance sum [P, 3], sum of its
    squares [P, 3]), float64 numpy arrays.  ``batch`` bounds the paths
    traced at once.  ``counts``, a dict, gets the rays traced ("rays") and
    the box, triangle and sphere tests of their closest hits added, and
    with ``nee`` the shadow rays and their tests (``occluded``)."""
    dev = scene.device
    pix_t = torch.as_tensor(np.asarray(pix), dtype=torch.int64, device=dev)
    P = int(pix_t.numel())
    total = P * num_samples
    s1 = torch.zeros((P, 3), dtype=torch.float64, device=dev)
    s2 = torch.zeros((P, 3), dtype=torch.float64, device=dev)
    for start in range(0, total, batch):
        flat = torch.arange(start, min(start + batch, total), device=dev)
        slot = flat % P
        samp = sample_start + flat // P
        L = _paths(scene, cam_data, pix_t[slot].to(torch.int32),
                   samp.to(torch.int32), width, height, seed, max_depth,
                   rr_start_depth, nee, store_dtype, counts).to(torch.float64)
        s1.index_add_(0, slot, L)
        s2.index_add_(0, slot, L * L)
    return s1.cpu().numpy(), s2.cpu().numpy()
