"""Plucker-matmul brick decomposition: triangles as coefficient matrices.

The port of ``pathtracer_cuda_interactive_tpu/experiments/mxset.py``.
Every Moller-Trumbore quantity is LINEAR in a 10-dim ray feature vector.
With ray features

    F = [o, d, o x d, 1]                       (10 floats per ray)

and a triangle (p0, e1, e2) with n = e1 x e2, the four scalars of
ops/geometry.py::intersect_triangle (shape.cuh:188-215) satisfy

    det     = dot(e1, d x e2)                =  F . [0,       -n,          0,   0]
    u * det = dot(o - p0, d x e2)            =  F . [0,  p0 x e2,         e2,   0]
    v * det = dot(d, (o - p0) x e1)          =  F . [0, -(p0 x e1),      -e1,   0]
    t * det = dot(e2, (o - p0) x e1)         =  F . [n,        0,          0, -p0.n]

(identities: a.(b x c) = c.(a x b) = det[a,b,c]).  So intersecting R rays
with a brick of T triangles is ONE [R, 10] x [10, 4T] product followed by a
sign-corrected validity test, with no per-ray gather.

Bricks are binned-SAH treelet leaves (models/sah.py) of up to
``MX_BRICK_PRIMS`` triangles; above them there is no tree: every packet of
rays is culled against every brick box at once (ops/pairtrace.py::
_interval_cull).

``MXSet`` is a dataclass of tensors like ``BrickSet``: ``.to(device)``
uploads it, ``from_numpy`` builds it from numpy arrays named like its fields
(for example the JAX package's MXSet fields) and ``from_pack`` runs the host
build, which is the JAX package's numpy code unchanged.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..models.device_scene import _build_prim_rows
from ..models.sah import build_sah_treelets
from ..models.scenepack import ScenePack

MX_BRICK_PRIMS = 128   # triangles per brick (one [10, 512] coeff slab)


class TensorSet:
    """What the sets of tensors of this package share: ``device``,
    ``nbytes``, ``.to(device)`` and ``from_numpy``.  A subclass is a
    dataclass whose int fields are named in ``_STATIC``."""

    _STATIC: tuple = ()

    @property
    def device(self) -> torch.device:
        return self.coeff.device

    @property
    def nbytes(self) -> int:
        """Bytes of all tensors (what ``.to(device)`` uploads)."""
        return sum(v.numel() * v.element_size()
                   for v in (getattr(self, f.name)
                             for f in dataclasses.fields(self))
                   if isinstance(v, torch.Tensor))

    def to(self, device):
        """A copy with every tensor on ``device``."""
        return type(self)(**{
            f.name: (getattr(self, f.name).to(device)
                     if isinstance(getattr(self, f.name), torch.Tensor)
                     else getattr(self, f.name))
            for f in dataclasses.fields(self)})

    @classmethod
    def from_numpy(cls, device="cpu", **arrays):
        """Build from numpy arrays (or ints for the counts) named like the
        fields, for example the fields of the JAX package's set of the same
        name read back with ``np.asarray``."""
        return cls(**{
            f.name: (int(arrays[f.name]) if f.name in cls._STATIC
                     else torch.as_tensor(np.array(arrays[f.name]),
                                          device=device))
            for f in dataclasses.fields(cls)})


@dataclass
class MXSet(TensorSet):
    """Plucker-matmul brick scene as tensors (all on one device)."""
    # [B, 10, 4*T] f32 coefficient slabs; columns grouped [det | u | v | t]
    coeff: torch.Tensor
    brick_lo: torch.Tensor     # [B, 3] f32 brick AABB min
    brick_hi: torch.Tensor     # [B, 3] f32 brick AABB max
    # megakernel-layout attribute rows (models/device_scene.py::
    # _build_prim_rows) for triangle slot b*T + k; zero rows = padding
    tri_rows: torch.Tensor     # [B*T, 32] f32
    sph_rows: torch.Tensor     # [S_pad, 32] f32 resident sphere table
    bg_r: torch.Tensor         # background (0-dim f32)
    bg_g: torch.Tensor
    bg_b: torch.Tensor
    light_pos: torch.Tensor        # [L,3] point lights (NEE)
    light_intensity: torch.Tensor  # [L,3]
    scene_lo: torch.Tensor     # [3] f32 scene AABB (sort-key normalization)
    scene_hi: torch.Tensor     # [3]
    num_spheres: int
    num_bricks: int
    brick_prims: int

    _STATIC = ("num_spheres", "num_bricks", "brick_prims")

    @classmethod
    def from_pack(cls, pack: ScenePack, device="cpu") -> "MXSet":
        return cls.from_numpy(device=device, **build_mxset(pack))


def _tri_coeff(p0: np.ndarray, e1: np.ndarray, e2: np.ndarray) -> np.ndarray:
    """[T, 10, 4] Plucker coefficient block for T triangles (f64 in, f32
    out).  Feature order: [o(0:3), d(3:6), o x d(6:9), 1(9)]."""
    T = p0.shape[0]
    n = np.cross(e1, e2)
    c = np.zeros((T, 10, 4), np.float64)
    c[:, 3:6, 0] = -n                      # det  = -n . d
    c[:, 6:9, 1] = e2                      # u*det =  e2 . (o x d) + ...
    c[:, 3:6, 1] = np.cross(p0, e2)        #         (p0 x e2) . d
    c[:, 6:9, 2] = -e1                     # v*det = -e1 . (o x d) - ...
    c[:, 3:6, 2] = -np.cross(p0, e1)       #         (p0 x e1) . d
    c[:, 0:3, 3] = n                       # t*det =  n . o - n . p0
    c[:, 9, 3] = -(p0 * n).sum(-1)
    return c.astype(np.float32)


def scene_tables(pack: ScenePack):
    """What ``build_mxset`` and ``build_mx2set`` start from: (sph_rows
    [S_pad, 32], the triangles' attribute rows [F, 32], p0, e1, e2 as f64
    [F, 3], the triangles' boxes tmin, tmax as f32 [F, 3])."""
    S, F = pack.num_spheres, pack.num_triangles
    if F == 0:
        raise ValueError("the Plucker-matmul sets need triangles; "
                         "sphere-only scenes take the megakernel path")
    rows = _build_prim_rows(pack)            # [P_pad, 32], spheres first
    sph_pad = max(8, -(-max(S, 1) // 8) * 8)
    sph_rows = np.zeros((sph_pad, 32), np.float32)
    sph_rows[:S] = rows[:S]
    p0 = pack.tri_p0.astype(np.float64)
    e1 = pack.tri_e1.astype(np.float64)
    e2 = pack.tri_e2.astype(np.float64)
    p1, p2 = p0 + e1, p0 + e2
    tmin = np.minimum(np.minimum(p0, p1), p2).astype(np.float32)
    tmax = np.maximum(np.maximum(p0, p1), p2).astype(np.float32)
    return sph_rows, rows[S:S + F], p0, e1, e2, tmin, tmax


def build_mxset(pack: ScenePack, brick_prims: int = MX_BRICK_PRIMS) -> dict:
    """Host build of the brick decomposition: a dict of numpy arrays and
    ints named like the MXSet fields (``MXSet.from_numpy``)."""
    S = pack.num_spheres
    sph_rows, tri_rows_src, p0, e1, e2, tmin, tmax = scene_tables(pack)

    top = build_sah_treelets(tmin, tmax, leaf_size=brick_prims)
    B = top.num_leaves
    T = brick_prims

    coeff = np.zeros((B, 10, 4 * T), np.float32)
    tri_rows = np.zeros((B * T, 32), np.float32)
    brick_lo = np.zeros((B, 3), np.float32)
    brick_hi = np.zeros((B, 3), np.float32)
    all_c = _tri_coeff(p0, e1, e2)           # [F, 10, 4]
    for b in range(B):
        ids = top.order[top.leaf_start[b]:top.leaf_start[b]
                        + top.leaf_count[b]]
        nb = len(ids)
        cb = np.zeros((T, 10, 4), np.float32)
        cb[:nb] = all_c[ids]
        # group columns by quantity: [det(T) | u(T) | v(T) | t(T)]
        coeff[b] = cb.transpose(1, 2, 0).reshape(10, 4 * T)
        tri_rows[b * T:b * T + nb] = tri_rows_src[ids]
        brick_lo[b] = tmin[ids].min(0)
        brick_hi[b] = tmax[ids].max(0)

    lo = np.minimum(tmin.min(0), (sph_rows[:S, 1:4] - sph_rows[:S, 4:5])
                    .min(0) if S else tmin.min(0)).astype(np.float32)
    hi = np.maximum(tmax.max(0), (sph_rows[:S, 1:4] + sph_rows[:S, 4:5])
                    .max(0) if S else tmax.max(0)).astype(np.float32)

    return dict(
        coeff=coeff, brick_lo=brick_lo, brick_hi=brick_hi,
        tri_rows=tri_rows, sph_rows=sph_rows,
        bg_r=np.float32(pack.background[0]),
        bg_g=np.float32(pack.background[1]),
        bg_b=np.float32(pack.background[2]),
        light_pos=pack.light_pos.astype(np.float32),
        light_intensity=pack.light_intensity.astype(np.float32),
        scene_lo=lo, scene_hi=hi,
        num_spheres=S, num_bricks=B, brick_prims=T)
