"""Flat SoA device scene ("ScenePack").

Replacement for the reference's pointer-soup GPU scene (``GPUScene`` in
scene.h:53-173 + per-mesh device pointers in shape.cuh:28-41): instead of
tagged unions and raw device pointers we build flat, statically-shaped
host arrays, uploaded once as tensors (models/device_scene.py).  The mesh
"explosion" into per-triangle shapes (scene.cpp:76-87) becomes
concatenated index/vertex pools; materials become a table of plain arrays.

Unified primitive id space: ``0..S-1`` are spheres, ``S..S+F-1`` are
triangles — the analog of the reference's ``shapes`` vector ordering.

The BVH (models/bvh.py) is packed into a single "fat node" record of 16
f32 lanes (64 B) so the traversal inner loop does exactly ONE gather per
step per ray:

====  ==========================  ==========================  ==================
lane  internal node               triangle leaf               sphere leaf
====  ==========================  ==========================  ==================
0:3   box min                     p0                          center
3:6   box max                     e1 = p1 - p0                radius, -, -
6:9   unused                      e2 = p2 - p0                unused
12    skip link (bitcast i32)     skip                        skip
13    -1                          unified prim id             unified prim id
14    kind 0                      kind 1                      kind 2
====  ==========================  ==========================  ==================

Leaves skip the AABB test entirely (the primitive test subsumes it), which
is why leaf boxes need not be stored.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ..utils import math3d as m3
from ..utils.trace import setup_span
from .bvh import FlatBVH, build_bvh
from .ir import (ImageTexture, ParsedBlinnPhong, ParsedBlinnPhongMicrofacet,
                 ParsedDiffuse, ParsedDiffuseAreaLight, ParsedMirror,
                 ParsedPhong, ParsedPlastic, ParsedPointLight, ParsedScene,
                 ParsedSphere, ParsedTriangleMesh)

# Material type codes (analog of the reference's MaterialType enum,
# material.h:27-86).
MAT_DIFFUSE = 0
MAT_MIRROR = 1
MAT_PLASTIC = 2
MAT_PHONG = 3

KIND_INTERNAL = 0
KIND_TRI = 1
KIND_SPHERE = 2


def _resolve_color(color) -> np.ndarray:
    """Constant colors pass through; image textures resolve to the bitmap's
    MEAN linear color (the reference parses textures but never evaluates
    them at render time — texture.h:18-56 is commented out; eval() ignores
    uv — so a flat mean color is already beyond its runtime capability).
    Unreadable/missing bitmaps fall back to mid-gray."""
    if isinstance(color, ImageTexture):
        try:
            from ..utils.image import read_png_any
            img = read_png_any(color.filename).astype(np.float32) / 255.0
            # bytes are gamma-encoded; square matches the renderer's
            # sqrt display transform (opengl_display.cpp:104-111)
            return (img * img).mean(axis=(0, 1)).astype(np.float32)
        except Exception:
            return np.array([0.5, 0.5, 0.5], np.float32)
    return np.asarray(color, np.float32)


@dataclass
class ScenePack:
    """Host build product: numpy arrays plus static counts.
    models/device_scene.py turns it into tensors on a device."""
    # materials (differentiable)
    mat_type: np.ndarray        # [M] i32
    mat_color: np.ndarray       # [M,3] f32 reflectance
    mat_param: np.ndarray       # [M] f32 (plastic eta / phong exponent)
    # spheres
    sph_center: np.ndarray      # [S,3] f32
    sph_radius: np.ndarray      # [S] f32
    # triangle pools
    vert_pos: np.ndarray        # [V,3] f32
    vert_nrm: np.ndarray        # [V,3] f32 (zeros where face normals)
    vert_uv: np.ndarray         # [V,2] f32
    tri_vidx: np.ndarray        # [F,3] i32
    # pre-expanded triangle geometry (p0, p1-p0, p2-p0) — used by the
    # brute-force small-scene intersector and BVH leaf re-tests
    tri_p0: np.ndarray          # [F,3] f32
    tri_e1: np.ndarray          # [F,3] f32
    tri_e2: np.ndarray          # [F,3] f32
    # unified per-primitive tables (spheres then triangles)
    prim_mat: np.ndarray        # [P] i32
    prim_emission: np.ndarray   # [P,3] f32 (area-light radiance or 0)
    prim_flags: np.ndarray      # [P] i32 bit0=use shading normals, bit1=has uv
    # point lights (parsed + stored; optional NEE consumer — the reference
    # uploads but never samples them, SURVEY.md §3.5)
    light_pos: np.ndarray       # [L,3] f32
    light_intensity: np.ndarray # [L,3] f32
    # flattened BVH
    bvh_nodes: np.ndarray       # [N,16] f32 fat nodes (int lanes bitcast)
    # background
    background: np.ndarray      # [3] f32
    # static metadata
    num_spheres: int
    num_triangles: int
    num_nodes: int
    bvh_depth: int

    @property
    def num_prims(self) -> int:
        return self.num_spheres + self.num_triangles


def _pack_nodes(bvh: FlatBVH, sph_center, sph_radius, tri_v0, tri_e1, tri_e2,
                num_spheres: int) -> np.ndarray:
    N = bvh.num_nodes
    nodes = np.zeros((N, 16), np.float32)
    prim = bvh.prim
    internal = prim < 0
    is_sph = (~internal) & (prim < num_spheres)
    is_tri = (~internal) & (prim >= num_spheres)

    nodes[internal, 0:3] = bvh.node_min[internal]
    nodes[internal, 3:6] = bvh.node_max[internal]

    sp = prim[is_sph]
    nodes[is_sph, 0:3] = sph_center[sp]
    nodes[is_sph, 3] = sph_radius[sp]

    tp = prim[is_tri] - num_spheres
    nodes[is_tri, 0:3] = tri_v0[tp]
    nodes[is_tri, 3:6] = tri_e1[tp]
    nodes[is_tri, 6:9] = tri_e2[tp]

    iview = nodes.view(np.int32)
    iview[:, 12] = bvh.skip
    iview[:, 13] = prim
    iview[:, 14] = np.where(internal, KIND_INTERNAL,
                            np.where(is_sph, KIND_SPHERE, KIND_TRI))
    return nodes


@setup_span("setup.pack")
def pack_scene(parsed: ParsedScene) -> ScenePack:
    """Flatten a ParsedScene into device arrays + BVH (the analog of
    ``Scene(ParsedScene)`` + ``GPUScene::copyFrom``, scene.cpp:11-153 /
    scene.h:73-142, re-architected as SoA)."""
    # ---- materials ----------------------------------------------------
    mat_type, mat_color, mat_param = [], [], []
    for mat in parsed.materials:
        if isinstance(mat, ParsedDiffuse):
            mat_type.append(MAT_DIFFUSE)
            mat_color.append(_resolve_color(mat.reflectance))
            mat_param.append(0.0)
        elif isinstance(mat, ParsedMirror):
            mat_type.append(MAT_MIRROR)
            mat_color.append(_resolve_color(mat.reflectance))
            mat_param.append(0.0)
        elif isinstance(mat, ParsedPlastic):
            mat_type.append(MAT_PLASTIC)
            mat_color.append(_resolve_color(mat.reflectance))
            mat_param.append(mat.eta)
        elif isinstance(mat, (ParsedPhong, ParsedBlinnPhong,
                              ParsedBlinnPhongMicrofacet)):
            # blinn variants shade as phong lobes; see models/ir.py note.
            mat_type.append(MAT_PHONG)
            mat_color.append(_resolve_color(mat.reflectance))
            mat_param.append(mat.exponent)
        else:
            raise TypeError(f"unknown material {type(mat)}")
    M = max(len(mat_type), 1)
    mat_type_np = np.zeros(M, np.int32)
    mat_color_np = np.full((M, 3), 0.5, np.float32)
    mat_param_np = np.zeros(M, np.float32)
    if mat_type:
        mat_type_np[:len(mat_type)] = mat_type
        mat_color_np[:len(mat_type)] = np.stack(mat_color)
        mat_param_np[:len(mat_type)] = mat_param

    # ---- area-light radiance per parsed light id ----------------------
    light_radiance = {}
    point_lights = []
    for i, light in enumerate(parsed.lights):
        if isinstance(light, ParsedDiffuseAreaLight):
            light_radiance[i] = np.asarray(light.radiance, np.float32)
        elif isinstance(light, ParsedPointLight):
            point_lights.append(light)

    # ---- shapes -> unified primitive arrays ---------------------------
    sph_center, sph_radius, sph_mat, sph_emit = [], [], [], []
    vert_pos, vert_nrm, vert_uv = [], [], []
    tri_vidx, tri_mat, tri_emit, tri_flags = [], [], [], []
    v_off = 0
    for shape in parsed.shapes:
        if isinstance(shape, ParsedSphere):
            sph_center.append(np.asarray(shape.center, np.float32))
            sph_radius.append(np.float32(shape.radius))
            sph_mat.append(shape.material_id)
            sph_emit.append(light_radiance.get(shape.area_light_id,
                                               np.zeros(3, np.float32)))
        elif isinstance(shape, ParsedTriangleMesh):
            V = shape.positions.shape[0]
            F = shape.indices.shape[0]
            if F == 0:
                continue
            vert_pos.append(np.asarray(shape.positions, np.float32))
            has_nrm = shape.normals is not None and len(shape.normals) == V
            vert_nrm.append(np.asarray(shape.normals, np.float32) if has_nrm
                            else np.zeros((V, 3), np.float32))
            has_uv = shape.uvs is not None and len(shape.uvs) == V
            vert_uv.append(np.asarray(shape.uvs, np.float32) if has_uv
                           else np.zeros((V, 2), np.float32))
            tri_vidx.append(np.asarray(shape.indices, np.int64) + v_off)
            tri_mat.append(np.full(F, shape.material_id, np.int32))
            emit = light_radiance.get(shape.area_light_id,
                                      np.zeros(3, np.float32))
            tri_emit.append(np.tile(emit, (F, 1)))
            flags = (1 if has_nrm else 0) | (2 if has_uv else 0)
            tri_flags.append(np.full(F, flags, np.int32))
            v_off += V
        else:
            raise TypeError(f"unknown shape {type(shape)}")

    S = len(sph_center)
    sph_center_np = (np.stack(sph_center) if S else np.zeros((0, 3), np.float32))
    sph_radius_np = np.asarray(sph_radius, np.float32)
    vert_pos_np = (np.concatenate(vert_pos) if vert_pos
                   else np.zeros((0, 3), np.float32))
    vert_nrm_np = (np.concatenate(vert_nrm) if vert_nrm
                   else np.zeros((0, 3), np.float32))
    vert_uv_np = (np.concatenate(vert_uv) if vert_uv
                  else np.zeros((0, 2), np.float32))
    tri_vidx_np = (np.concatenate(tri_vidx).astype(np.int32) if tri_vidx
                   else np.zeros((0, 3), np.int32))
    F = tri_vidx_np.shape[0]

    prim_mat = np.concatenate([
        np.asarray(sph_mat, np.int32).reshape(S),
        (np.concatenate(tri_mat) if tri_mat else np.zeros(0, np.int32))])
    prim_emission = np.concatenate([
        (np.stack(sph_emit) if S else np.zeros((0, 3), np.float32)),
        (np.concatenate(tri_emit) if tri_emit else np.zeros((0, 3), np.float32))])
    prim_flags = np.concatenate([
        np.full(S, 1, np.int32),  # spheres: analytic shading normals
        (np.concatenate(tri_flags) if tri_flags else np.zeros(0, np.int32))])
    # Negative material ids (shape with no material) -> material 0, like an
    # out-of-range id would be UB in the reference; clamp for safety.
    prim_mat = np.where(prim_mat < 0, 0, prim_mat).astype(np.int32)

    # ---- per-primitive AABBs + BVH (scene.cpp:124-149 analog) ---------
    if S + F == 0:
        raise ValueError("scene has no primitives")
    tri_p0 = vert_pos_np[tri_vidx_np[:, 0]] if F else np.zeros((0, 3), np.float32)
    tri_p1 = vert_pos_np[tri_vidx_np[:, 1]] if F else np.zeros((0, 3), np.float32)
    tri_p2 = vert_pos_np[tri_vidx_np[:, 2]] if F else np.zeros((0, 3), np.float32)
    prim_min = np.concatenate([
        sph_center_np - sph_radius_np[:, None],
        np.minimum(np.minimum(tri_p0, tri_p1), tri_p2)])
    prim_max = np.concatenate([
        sph_center_np + sph_radius_np[:, None],
        np.maximum(np.maximum(tri_p0, tri_p1), tri_p2)])
    bvh = build_bvh(prim_min, prim_max)

    nodes = _pack_nodes(bvh, sph_center_np, sph_radius_np,
                        tri_p0, tri_p1 - tri_p0, tri_p2 - tri_p0, S)

    L = len(point_lights)
    light_pos = (np.stack([pl.position for pl in point_lights]).astype(np.float32)
                 if L else np.zeros((0, 3), np.float32))
    light_intensity = (np.stack([pl.intensity for pl in point_lights])
                       .astype(np.float32) if L else np.zeros((0, 3), np.float32))

    return ScenePack(
        mat_type=mat_type_np, mat_color=mat_color_np, mat_param=mat_param_np,
        sph_center=sph_center_np, sph_radius=sph_radius_np,
        vert_pos=vert_pos_np, vert_nrm=vert_nrm_np, vert_uv=vert_uv_np,
        tri_vidx=tri_vidx_np,
        tri_p0=tri_p0, tri_e1=tri_p1 - tri_p0, tri_e2=tri_p2 - tri_p0,
        prim_mat=prim_mat, prim_emission=prim_emission.astype(np.float32),
        prim_flags=prim_flags,
        light_pos=light_pos, light_intensity=light_intensity,
        bvh_nodes=nodes,
        background=np.asarray(parsed.background_color, np.float32),
        num_spheres=S, num_triangles=F, num_nodes=bvh.num_nodes,
        bvh_depth=bvh.depth,
    )



def load_scene(xml_path: str) -> Tuple[ScenePack, "ParsedScene"]:
    """Parse + pack in one call; returns (pack, parsed)."""
    from ..io.xml_scene import parse_scene
    parsed = parse_scene(xml_path)
    return pack_scene(parsed), parsed
