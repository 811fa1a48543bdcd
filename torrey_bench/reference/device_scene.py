"""Device-resident scene: the per-component SoA form of a ScenePack, as
tensors.

Frozen from the PyTorch port's ``models/device_scene.py``.
``ScenePack`` (scenepack.py) is the host build product with ``[N, 3]``
numpy arrays; ``DeviceScene`` splits every hot array into flat ``[N]``
component tensors (the layout the plain path tracer gathers from).  It is
a plain dataclass of tensors: ``.to(device)`` is the reference's
``GPUScene::copyFrom`` upload (scene.h:73-142).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .scenepack import ScenePack


@dataclass
class DeviceScene:
    # materials
    mat_type: torch.Tensor    # [M] i32
    mat_r: torch.Tensor       # [M] f32 reflectance per channel
    mat_g: torch.Tensor
    mat_b: torch.Tensor
    mat_param: torch.Tensor   # [M] f32 eta / exponent
    # spheres
    sph_x: torch.Tensor       # [S]
    sph_y: torch.Tensor
    sph_z: torch.Tensor
    sph_rad: torch.Tensor
    # triangles: p0 + edges, per component
    tri_p0x: torch.Tensor     # [F]
    tri_p0y: torch.Tensor
    tri_p0z: torch.Tensor
    tri_e1x: torch.Tensor
    tri_e1y: torch.Tensor
    tri_e1z: torch.Tensor
    tri_e2x: torch.Tensor
    tri_e2y: torch.Tensor
    tri_e2z: torch.Tensor
    # triangle vertex indices (for shading attributes)
    tri_i0: torch.Tensor      # [F] i32
    tri_i1: torch.Tensor
    tri_i2: torch.Tensor
    # vertex attribute pools, per component
    vtx_nx: torch.Tensor      # [V]
    vtx_ny: torch.Tensor
    vtx_nz: torch.Tensor
    vtx_u: torch.Tensor
    vtx_v: torch.Tensor
    # unified per-primitive tables
    prim_mat: torch.Tensor    # [P] i32
    prim_em_r: torch.Tensor   # [P] f32 emission
    prim_em_g: torch.Tensor
    prim_em_b: torch.Tensor
    prim_flags: torch.Tensor  # [P] i32
    # flattened BVH (fat nodes, int lanes bitcast into f32); walked by
    # ops/trace.py in scenes above BRUTE_FORCE_MAX_PRIMS primitives
    bvh_nodes: torch.Tensor   # [N,16] f32
    # background
    bg_r: torch.Tensor        # 0-dim f32
    bg_g: torch.Tensor
    bg_b: torch.Tensor
    # point lights (NEE extension)
    light_pos: torch.Tensor        # [L,3] f32
    light_intensity: torch.Tensor  # [L,3] f32
    # static metadata
    num_spheres: int
    num_triangles: int
    num_nodes: int

    @property
    def num_prims(self) -> int:
        return self.num_spheres + self.num_triangles

    @property
    def device(self) -> torch.device:
        return self.prim_mat.device

    @property
    def background(self):
        from .vec import Vec3
        return Vec3(self.bg_r, self.bg_g, self.bg_b)

    def to(self, device) -> "DeviceScene":
        """A copy with every tensor on ``device``."""
        moved = {}
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            moved[f.name] = (value.to(device)
                             if isinstance(value, torch.Tensor) else value)
        return DeviceScene(**moved)

    @staticmethod
    def from_numpy(fields: dict, device="cpu") -> "DeviceScene":
        """Build from a mapping of every field name to a numpy array (or an
        int, for the counts) — for example the fields of the JAX package's
        ``DeviceScene`` read back with ``np.asarray``."""
        kwargs = {}
        for f in dataclasses.fields(DeviceScene):
            value = fields[f.name]
            if f.name in _STATIC:
                kwargs[f.name] = int(value)
            else:
                kwargs[f.name] = torch.as_tensor(np.array(value),
                                                 device=device)
        return DeviceScene(**kwargs)

    @staticmethod
    def from_pack(pack: ScenePack, device="cpu") -> "DeviceScene":
        f32 = np.float32
        c = pack.sph_center.astype(f32)
        p0 = pack.tri_p0.astype(f32)
        e1 = pack.tri_e1.astype(f32)
        e2 = pack.tri_e2.astype(f32)
        nrm = pack.vert_nrm.astype(f32)
        uv = pack.vert_uv.astype(f32)
        em = pack.prim_emission.astype(f32)
        return DeviceScene.from_numpy(dict(
            mat_type=pack.mat_type,
            mat_r=pack.mat_color[:, 0], mat_g=pack.mat_color[:, 1],
            mat_b=pack.mat_color[:, 2],
            mat_param=pack.mat_param,
            sph_x=c[:, 0], sph_y=c[:, 1], sph_z=c[:, 2],
            sph_rad=pack.sph_radius.astype(f32),
            tri_p0x=p0[:, 0], tri_p0y=p0[:, 1], tri_p0z=p0[:, 2],
            tri_e1x=e1[:, 0], tri_e1y=e1[:, 1], tri_e1z=e1[:, 2],
            tri_e2x=e2[:, 0], tri_e2y=e2[:, 1], tri_e2z=e2[:, 2],
            tri_i0=pack.tri_vidx[:, 0], tri_i1=pack.tri_vidx[:, 1],
            tri_i2=pack.tri_vidx[:, 2],
            vtx_nx=nrm[:, 0], vtx_ny=nrm[:, 1], vtx_nz=nrm[:, 2],
            vtx_u=uv[:, 0], vtx_v=uv[:, 1],
            prim_mat=pack.prim_mat,
            prim_em_r=em[:, 0], prim_em_g=em[:, 1], prim_em_b=em[:, 2],
            prim_flags=pack.prim_flags,
            bvh_nodes=pack.bvh_nodes,
            bg_r=np.float32(pack.background[0]),
            bg_g=np.float32(pack.background[1]),
            bg_b=np.float32(pack.background[2]),
            light_pos=pack.light_pos, light_intensity=pack.light_intensity,
            num_spheres=pack.num_spheres,
            num_triangles=pack.num_triangles,
            num_nodes=pack.num_nodes,
        ), device)


_STATIC = ("num_spheres", "num_triangles", "num_nodes")
