"""Superbrick decomposition for the packet tracer of mx2.py (kernel B7).

The port of ``pathtracer_cuda_interactive_tpu/experiments/mx2set.py``:

  * **superbrick**: a binned-SAH treelet leaf (models/sah.py) of up to
    ``SB_PRIMS`` (512) triangles, stored as one dense coefficient slab
    [256, 128] f32;
  * **sub-brick**: 32 consecutive (Morton-ordered) triangles inside the
    superbrick with their own AABB; the kernel culls at sub granularity
    and intersects one sub with one product C[16, 128]^T . F[16, 128] =
    [128, 128], whose rows are [det(32) | u*det(32) | v*det(32) |
    t*det(32)] and whose columns are the packet's 128 rays.

Slab layout: ``coeff[b, s*16 + k, q*32 + j]`` = Plucker coefficient
(mxset.py) of feature k (0..9; rows 10..15 zero padding) for quantity q
(det, u, v, t) of triangle j of sub-brick s.  The 16-row stride and the
128-wide rows are the TPU's tile; the port keeps the layout so that both
packages can be handed the same arrays, and kernel B7 reads only the 10
rows that carry numbers.

Translation invariance: coefficients are built from ``p0 - shift`` with
shift = the scene-box centre, and the tracer subtracts the same shift from
ray origins before it builds features, so the o x d feature's magnitude
scales with the scene, not with its position in the world.

``MX2Set`` is a dataclass of tensors like ``BrickSet``; the host build is
the JAX package's numpy code unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.bvh import morton_codes
from ..models.sah import build_sah_treelets
from ..models.scenepack import ScenePack
from .mxset import TensorSet, _tri_coeff, scene_tables

SB_PRIMS = 512           # triangles per superbrick (one [256, 128] slab)
SUB_PRIMS = 32           # triangles per sub-brick (one product)
NUM_SUBS = SB_PRIMS // SUB_PRIMS     # 16
SLAB_ROWS = NUM_SUBS * 16            # 16 feature rows (10 + 6 pad) per sub


@dataclass
class MX2Set(TensorSet):
    """Superbrick scene as tensors (all on one device)."""
    coeff: torch.Tensor      # [B, 256, 128] f32 transposed Plucker slabs
    subbox: torch.Tensor     # [B, 128] f32: sub s field f at [b, s*8+f],
    #                          f = 0..5 min/max xyz, 6 = valid flag
    brick_lo: torch.Tensor   # [B, 3] f32 superbrick AABB min (world)
    brick_hi: torch.Tensor   # [B, 3] f32
    tri_rows: torch.Tensor   # [B*512, 32] f32 megakernel-layout attr rows
    sph_rows: torch.Tensor   # [S_pad, 32] f32 resident sphere table
    shift: torch.Tensor      # [3] f32 origin shift baked into coeff
    bg_r: torch.Tensor       # background (0-dim f32)
    bg_g: torch.Tensor
    bg_b: torch.Tensor
    light_pos: torch.Tensor        # [L,3] point lights (NEE)
    light_intensity: torch.Tensor  # [L,3]
    scene_lo: torch.Tensor   # [3] f32 scene AABB (sort-key normalization)
    scene_hi: torch.Tensor
    num_spheres: int
    num_bricks: int

    _STATIC = ("num_spheres", "num_bricks")

    @classmethod
    def from_pack(cls, pack: ScenePack, device="cpu") -> "MX2Set":
        return cls.from_numpy(device=device, **build_mx2set(pack))


def build_mx2set(pack: ScenePack) -> dict:
    """Host build of the superbrick decomposition: a dict of numpy arrays
    and ints named like the MX2Set fields (``MX2Set.from_numpy``)."""
    S = pack.num_spheres
    sph_rows, tri_rows_src, p0, e1, e2, tmin, tmax = scene_tables(pack)

    lo = tmin.min(0)
    hi = tmax.max(0)
    if S:
        lo = np.minimum(lo, (sph_rows[:S, 1:4] - sph_rows[:S, 4:5]).min(0))
        hi = np.maximum(hi, (sph_rows[:S, 1:4] + sph_rows[:S, 4:5]).max(0))
    shift = (0.5 * (lo.astype(np.float64) + hi)).astype(np.float32)

    top = build_sah_treelets(tmin, tmax, leaf_size=SB_PRIMS)
    B = top.num_leaves

    # per-brick triangle id table [B, 512], -1 = padding, Morton-ordered
    # within the brick so consecutive 32-prim subs have tight AABBs
    morton = morton_codes(0.5 * (tmin.astype(np.float64) + tmax))
    perm = np.full((B, SB_PRIMS), -1, np.int64)
    brick_lo = np.zeros((B, 3), np.float32)
    brick_hi = np.zeros((B, 3), np.float32)
    for b in range(B):
        ids = top.order[top.leaf_start[b]:top.leaf_start[b]
                        + top.leaf_count[b]]
        ids = ids[np.argsort(morton[ids], kind="stable")]
        perm[b, :len(ids)] = ids
        brick_lo[b] = tmin[ids].min(0)
        brick_hi[b] = tmax[ids].max(0)

    valid = perm >= 0
    safe = np.maximum(perm, 0)

    # coefficient slabs, vectorized: [F,10,4] -> [B,16,10,4,32] -> [B,256,128]
    all_c = _tri_coeff(p0 - shift.astype(np.float64), e1, e2)   # [F, 10, 4]
    cp = np.where(valid[:, :, None, None], all_c[safe], 0.0)    # [B,512,10,4]
    cp = cp.reshape(B, NUM_SUBS, SUB_PRIMS, 10, 4)
    cp = cp.transpose(0, 1, 3, 4, 2)                 # [B,16,10,4,32]
    cp = cp.reshape(B, NUM_SUBS, 10, 4 * SUB_PRIMS)  # [B,16,10,128]
    coeff = np.zeros((B, NUM_SUBS, 16, 128), np.float32)
    coeff[:, :, :10, :] = cp
    coeff = coeff.reshape(B, SLAB_ROWS, 128)

    # sub-brick AABBs [B, 16, 8] -> packed [B, 128]
    smin = np.where(valid[:, :, None], tmin[safe], np.inf)
    smax = np.where(valid[:, :, None], tmax[safe], -np.inf)
    smin = smin.reshape(B, NUM_SUBS, SUB_PRIMS, 3).min(2)
    smax = smax.reshape(B, NUM_SUBS, SUB_PRIMS, 3).max(2)
    sub_valid = valid.reshape(B, NUM_SUBS, SUB_PRIMS).any(2)
    subbox = np.zeros((B, NUM_SUBS, 8), np.float32)
    subbox[:, :, 0:3] = np.where(sub_valid[:, :, None], smin, 0.0)
    subbox[:, :, 3:6] = np.where(sub_valid[:, :, None], smax, 0.0)
    subbox[:, :, 6] = sub_valid
    subbox = subbox.reshape(B, 128)

    tri_rows = np.where(valid.reshape(-1)[:, None],
                        tri_rows_src[safe.reshape(-1)],
                        0.0).astype(np.float32)      # [B*512, 32]

    return dict(
        coeff=coeff, subbox=subbox, brick_lo=brick_lo, brick_hi=brick_hi,
        tri_rows=tri_rows, sph_rows=sph_rows, shift=shift,
        bg_r=np.float32(pack.background[0]),
        bg_g=np.float32(pack.background[1]),
        bg_b=np.float32(pack.background[2]),
        light_pos=pack.light_pos.astype(np.float32),
        light_intensity=pack.light_intensity.astype(np.float32),
        scene_lo=lo.astype(np.float32), scene_hi=hi.astype(np.float32),
        num_spheres=S, num_bricks=B)
