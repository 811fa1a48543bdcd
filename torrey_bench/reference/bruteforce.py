"""Brute-force closest-hit and any-hit over every primitive (SoA layout).

Frozen from the PyTorch port's ``ops/bruteforce.py``: for
scenes of up to a few hundred primitives (the sphere scenes and the
Cornell box) every primitive is tested against every ray, in chunks along
a leading axis, with no traversal.  Ties resolve to the lowest primitive id
(spheres first, then triangles), as in the JAX package and the megakernel.
Both searches run under ``torch.no_grad``: a hit id carries no gradient
(the JAX package stop-grads its hit search, ops/trace.py), and the
differentiable path (grad/inverse.py) recomputes the hit point from the id,
so the [chunk, rays] tests stay out of the autograd graph.
"""

from __future__ import annotations

import torch

from .device_scene import DeviceScene
from . import geometry as g
from .vec import Vec3

CHUNK = 8
# Scenes up to this many primitives brute-force in the plain integrator;
# larger ones walk the BVH (ops/trace.py), as in the JAX package.
BRUTE_FORCE_MAX_PRIMS = 512


def _expand(ray_v: Vec3) -> Vec3:
    """ray components -> leading singleton chunk axis for broadcasting."""
    return Vec3(ray_v.x[None], ray_v.y[None], ray_v.z[None])


def _chunk(arr, c0, c1, ray_ndim):
    """[C] slice -> [C, 1...] with ray_ndim trailing singletons."""
    return arr[c0:c1].reshape((c1 - c0,) + (1,) * ray_ndim)


def _chunk_vec(xs, ys, zs, c0, c1, ray_ndim) -> Vec3:
    return Vec3(_chunk(xs, c0, c1, ray_ndim), _chunk(ys, c0, c1, ray_ndim),
                _chunk(zs, c0, c1, ray_ndim))


def _tnear_e(tnear):
    return tnear[None] if isinstance(tnear, torch.Tensor) and tnear.ndim \
        else tnear


@torch.no_grad()
def intersect_brute(scene: DeviceScene, org: Vec3, dirn: Vec3, tnear):
    """Closest hit over all primitives.  Returns (prim i32, -1 = miss; t),
    each of the rays' shape."""
    shape = org.x.shape
    dev = org.x.device
    best_t = torch.full(shape, float("inf"), dtype=torch.float32, device=dev)
    best_prim = torch.full(shape, -1, dtype=torch.int32, device=dev)
    org_e = _expand(org)
    dirn_e = _expand(dirn)
    tnear_e = _tnear_e(tnear)

    S = scene.num_spheres
    F = scene.num_triangles

    nd = org.x.ndim
    for c0 in range(0, S, CHUNK):
        c1 = min(c0 + CHUNK, S)
        center = _chunk_vec(scene.sph_x, scene.sph_y, scene.sph_z, c0, c1, nd)
        radius = _chunk(scene.sph_rad, c0, c1, nd)
        t, hit = g.intersect_sphere(center, radius, org_e, dirn_e,
                                    tnear_e, best_t[None])
        t = torch.where(hit, t, float("inf"))
        k = torch.argmin(t, dim=0)      # first minimum: lowest id wins
        tk = torch.amin(t, dim=0)
        closer = tk < best_t
        best_t = torch.where(closer, tk, best_t)
        best_prim = torch.where(closer, (c0 + k).to(torch.int32), best_prim)

    for c0 in range(0, F, CHUNK):
        c1 = min(c0 + CHUNK, F)
        p0 = _chunk_vec(scene.tri_p0x, scene.tri_p0y, scene.tri_p0z, c0, c1, nd)
        e1 = _chunk_vec(scene.tri_e1x, scene.tri_e1y, scene.tri_e1z, c0, c1, nd)
        e2 = _chunk_vec(scene.tri_e2x, scene.tri_e2y, scene.tri_e2z, c0, c1, nd)
        t, _u, _v, hit = g.intersect_triangle(p0, e1, e2, org_e, dirn_e,
                                              tnear_e, best_t[None])
        t = torch.where(hit, t, float("inf"))
        k = torch.argmin(t, dim=0)      # first minimum: lowest id wins
        tk = torch.amin(t, dim=0)
        closer = tk < best_t
        best_t = torch.where(closer, tk, best_t)
        best_prim = torch.where(closer, (S + c0 + k).to(torch.int32),
                                best_prim)

    return best_prim, best_t


@torch.no_grad()
def occluded_brute(scene: DeviceScene, org: Vec3, dirn: Vec3, tnear, tfar):
    """Any-hit over all primitives: True where some primitive lies on the
    segment (tnear, tfar).  The shadow-ray test of point-light NEE; it
    gives the same answer as the JAX package's BVH walk
    (ops/trace.py::trace_occluded), whose boxes only cull primitives the
    segment misses."""
    org_e = _expand(org)
    dirn_e = _expand(dirn)
    tnear_e = _tnear_e(tnear)
    tfar_e = _tnear_e(tfar)
    occ = torch.zeros(org.x.shape, dtype=torch.bool, device=org.x.device)
    S = scene.num_spheres
    F = scene.num_triangles
    nd = org.x.ndim
    for c0 in range(0, S, CHUNK):
        c1 = min(c0 + CHUNK, S)
        center = _chunk_vec(scene.sph_x, scene.sph_y, scene.sph_z, c0, c1, nd)
        radius = _chunk(scene.sph_rad, c0, c1, nd)
        _, hit = g.intersect_sphere(center, radius, org_e, dirn_e, tnear_e,
                                    tfar_e)
        occ = occ | hit.any(dim=0)
    for c0 in range(0, F, CHUNK):
        c1 = min(c0 + CHUNK, F)
        p0 = _chunk_vec(scene.tri_p0x, scene.tri_p0y, scene.tri_p0z, c0, c1, nd)
        e1 = _chunk_vec(scene.tri_e1x, scene.tri_e1y, scene.tri_e1z, c0, c1, nd)
        e2 = _chunk_vec(scene.tri_e2x, scene.tri_e2y, scene.tri_e2z, c0, c1, nd)
        _, _, _, hit = g.intersect_triangle(p0, e1, e2, org_e, dirn_e,
                                            tnear_e, tfar_e)
        occ = occ | hit.any(dim=0)
    return occ
