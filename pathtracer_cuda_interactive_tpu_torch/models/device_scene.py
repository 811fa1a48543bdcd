"""Device-resident scene: the per-component SoA form of a ScenePack, as
tensors.

The port of ``pathtracer_cuda_interactive_tpu/models/device_scene.py``.
``ScenePack`` (scenepack.py) is the host build product with ``[N, 3]``
numpy arrays; ``DeviceScene`` splits every hot array into flat ``[N]``
component tensors (the layout the plain path tracer in ops/ gathers from)
and carries the megakernel's fat primitive records (``prim_rows``).  It is
a plain dataclass of tensors: ``.to(device)`` is the reference's
``GPUScene::copyFrom`` upload (scene.h:73-142).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.trace import setup_span
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
    # megakernel prim rows (ops/megakernel.py): one 32-float record per
    # primitive with geometry, corner shading normals and the material
    # folded in, so the kernel's bounce loop does no gathers.  Layout:
    #   0      kind (1 tri / 2 sphere)
    #   1:4    sphere center | tri p0
    #   4:7    (radius,-,-)  | e1
    #   7:10   -             | e2
    #   10:19  -             | corner shading normals n0 n1 n2
    #   19     material type (f32-coded enum)
    #   20:23  albedo rgb      23  material param (eta / exponent)
    #   24:27  emission rgb    27  is_emitter (0/1)
    #   28     smooth-shading flag (1 = interpolate corner normals,
    #          0 = geometric normal, computed in-kernel as cross(e1,e2))
    prim_rows: torch.Tensor   # [P_pad, 32] f32
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
        return self.prim_rows.device

    @property
    def background(self):
        from ..ops.vec import Vec3
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
    @setup_span("setup.host_set")
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
            prim_rows=_build_prim_rows(pack),
            bg_r=np.float32(pack.background[0]),
            bg_g=np.float32(pack.background[1]),
            bg_b=np.float32(pack.background[2]),
            light_pos=pack.light_pos, light_intensity=pack.light_intensity,
            num_spheres=pack.num_spheres,
            num_triangles=pack.num_triangles,
            num_nodes=pack.num_nodes,
        ), device)


_STATIC = ("num_spheres", "num_triangles", "num_nodes")


def _build_prim_rows(pack: ScenePack) -> np.ndarray:
    """Pack the megakernel's fat prim records (layout documented on the
    ``prim_rows`` field).  Spheres first, triangles after — same unified id
    order as everywhere else; P padded to a multiple of 8 rows, as in the
    JAX package."""
    S, F = pack.num_spheres, pack.num_triangles
    P = S + F
    Ppad = max(8, -(-P // 8) * 8)
    rows = np.zeros((Ppad, 32), np.float32)

    mat = pack.prim_mat
    rows[:P, 19] = pack.mat_type[mat].astype(np.float32)
    rows[:P, 20:23] = pack.mat_color[mat]
    rows[:P, 23] = pack.mat_param[mat]
    rows[:P, 24:27] = pack.prim_emission
    rows[:P, 27] = (np.abs(pack.prim_emission).sum(axis=1) > 0)

    if S:
        rows[:S, 0] = 2.0
        rows[:S, 1:4] = pack.sph_center
        rows[:S, 4] = pack.sph_radius
    if F:
        rows[S:P, 0] = 1.0
        rows[S:P, 1:4] = pack.tri_p0
        rows[S:P, 4:7] = pack.tri_e1
        rows[S:P, 7:10] = pack.tri_e2
        # corner shading normals (used only when the smooth flag at 28 is
        # set; flat triangles take the in-kernel cross(e1,e2) instead)
        use_sn = (pack.prim_flags[S:P] & 1).astype(bool)
        for corner in range(3):
            vn = pack.vert_nrm[pack.tri_vidx[:, corner]]
            rows[S:P, 10 + 3 * corner:13 + 3 * corner] = \
                np.where(use_sn[:, None], vn, 0.0)
        rows[S:P, 28] = use_sn
    return rows
