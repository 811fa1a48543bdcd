"""Hit-point reconstruction ("shading setup"), SoA layout.

Frozen from the PyTorch port's ``ops/shade.py``: given the
discrete hit primitive ids, re-derive the intersection record the reference
builds inline during traversal (find_intersection_with_triangle / _sphere,
scene.h:176-238 + shape.cuh:135-186): position, geometric + shading normal,
uv, material id and emitted radiance, by gathers from the DeviceScene's
flat per-component tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .device_scene import DeviceScene
from . import geometry as g
from .vec import Vec3, cross, normalize, where


class Intersection(NamedTuple):
    """SoA analog of the reference Intersection (intersection.h:5-13)."""
    position: Vec3
    geometric_normal: Vec3
    shading_normal: Vec3
    distance: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    material_id: torch.Tensor
    emission: Vec3
    is_emitter: torch.Tensor


def _take3(ax, ay, az, idx) -> Vec3:
    return Vec3(ax[idx], ay[idx], az[idx])


def shade_setup(scene: DeviceScene, prim, org: Vec3, dirn: Vec3,
                tnear=0.0) -> Intersection:
    """prim: unified primitive id per ray (miss rays are masked by the
    caller; their outputs here are garbage-but-finite).

    ``tnear`` must be the same near-clip the traversal used: the sphere
    re-intersection here re-solves the quadratic, and a secondary ray that
    re-hit its own sphere (near root < tnear) must select the far root the
    traversal actually hit, not the near one."""
    S = scene.num_spheres
    F = scene.num_triangles
    shape = prim.shape
    dev = prim.device
    p_safe = torch.clamp(prim, 0, S + F - 1).long()
    is_sph = p_safe < S

    pos = Vec3.zeros(shape, device=dev)
    ng = Vec3.zeros(shape, device=dev)
    ns = Vec3.zeros(shape, device=dev)
    t = torch.zeros(shape, dtype=torch.float32, device=dev)
    u = torch.zeros(shape, dtype=torch.float32, device=dev)
    v = torch.zeros(shape, dtype=torch.float32, device=dev)

    if S > 0:
        si = torch.where(is_sph, p_safe, 0)
        center = _take3(scene.sph_x, scene.sph_y, scene.sph_z, si)
        radius = scene.sph_rad[si]
        t_s, _ = g.intersect_sphere(center, radius, org, dirn, tnear, g.INF)
        p_s, n_s, u_s, v_s = g.sphere_shading(center, radius, org, dirn, t_s)
        pos = where(is_sph, p_s, pos)
        ng = where(is_sph, n_s, ng)
        ns = where(is_sph, n_s, ns)
        t = torch.where(is_sph, t_s, t)
        u = torch.where(is_sph, u_s, u)
        v = torch.where(is_sph, v_s, v)

    if F > 0:
        fi = torch.where(is_sph, 0, p_safe - S)
        p0 = _take3(scene.tri_p0x, scene.tri_p0y, scene.tri_p0z, fi)
        e1 = _take3(scene.tri_e1x, scene.tri_e1y, scene.tri_e1z, fi)
        e2 = _take3(scene.tri_e2x, scene.tri_e2y, scene.tri_e2z, fi)
        t_t, u_t, v_t, _ = g.intersect_triangle(p0, e1, e2, org, dirn,
                                                -g.INF, g.INF)
        w_t = 1.0 - u_t - v_t
        pos_t = p0 + e1 * u_t + e2 * v_t
        ng_t = normalize(cross(e1, e2))

        flags = scene.prim_flags[p_safe]
        i0 = scene.tri_i0[fi].long()
        i1 = scene.tri_i1[fi].long()
        i2 = scene.tri_i2[fi].long()
        n0 = _take3(scene.vtx_nx, scene.vtx_ny, scene.vtx_nz, i0)
        n1 = _take3(scene.vtx_nx, scene.vtx_ny, scene.vtx_nz, i1)
        n2 = _take3(scene.vtx_nx, scene.vtx_ny, scene.vtx_nz, i2)
        ns_interp = normalize(n0 * w_t + n1 * u_t + n2 * v_t)
        use_sn = (flags & 1) != 0
        ns_t = where(use_sn, ns_interp, ng_t)

        has_uv = (flags & 2) != 0
        u_attr = (scene.vtx_u[i0] * w_t + scene.vtx_u[i1] * u_t
                  + scene.vtx_u[i2] * v_t)
        v_attr = (scene.vtx_v[i0] * w_t + scene.vtx_v[i1] * u_t
                  + scene.vtx_v[i2] * v_t)
        uu = torch.where(has_uv, u_attr, u_t)
        vv = torch.where(has_uv, v_attr, v_t)

        tri = ~is_sph
        pos = where(tri, pos_t, pos)
        ng = where(tri, ng_t, ng)
        ns = where(tri, ns_t, ns)
        t = torch.where(tri, t_t, t)
        u = torch.where(tri, uu, u)
        v = torch.where(tri, vv, v)

    material_id = scene.prim_mat[p_safe]
    emission = _take3(scene.prim_em_r, scene.prim_em_g, scene.prim_em_b,
                      p_safe)
    is_emitter = ((emission.x != 0.0) | (emission.y != 0.0)
                  | (emission.z != 0.0))

    return Intersection(pos, ng, ns, t, u, v, material_id, emission,
                        is_emitter)
