"""Brick decomposition of large triangle scenes, as tensors.

The port of ``pathtracer_cuda_interactive_tpu/models/bricks.py``.  The
host build is the JAX package's, unchanged: triangles are partitioned by a
binned-SAH treelet cut (models/sah.py); each SAH leaf of up to
``BRICK_PRIMS`` (512) prims becomes a **brick**, one dense
[BRICK_ROWS, 128] f32 block of BRICK_DATA_ROWS (128) rows of megakernel-
layout prim records (models/device_scene.py::_build_prim_rows) plus a
sub-AABB row.  The SAH tree itself, flattened preorder skip-link, is the
top tree the brick trace walks.  Within a brick, prims are Morton-ordered
so the 16 consecutive 32-prim sub-chunks have tight AABBs for the chunk
gates of the trace.

Spheres are not bricked: the scenes in scope have at most dozens, so they
stay in a small resident table that the wavefront's epilogue brute-forces
(ops/wavefront.py).

``BrickSet`` is a dataclass of tensors, like ``DeviceScene``: ``.to(device)``
uploads it, ``from_numpy`` builds it from numpy arrays (for example the
fields of the JAX package's BrickSet) and ``from_pack`` runs the host build.
The layout keeps the TPU's 128-wide packing of the top tree and the
``MAX_TOP_NODES`` / ``STACK_DEPTH`` bounds for parity with the JAX package;
on the card they are not memory budgets.

``WalkTable`` is what the brick kernels' per-ray walk reads on a card
(csrc/brick_walk.cuh): the top tree as one 64-byte record per node and the
nine floats of every triangle's test apart from its 128-byte record.  It is
derived from a ``BrickSet``'s tensors in torch ops, once per set and device
(``BrickSet.walk_table``), and carried along by ``.to(device)``.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.trace import setup_span
from .bvh import morton_codes
from .device_scene import _build_prim_rows
from .sah import build_sah_treelets
from .scenepack import ScenePack

BRICK_PRIMS = 512           # max prims per brick (512 * 32 f32 = 128 rows)
SUB_PRIMS = 32              # prims per sub-chunk, culled by sub-AABB
NUM_SUBS = BRICK_PRIMS // SUB_PRIMS          # 16 sub-AABBs per brick
BRICK_DATA_ROWS = BRICK_PRIMS * 32 // 128    # 128 rows of prim records
# one extra row carries the sub-AABB table: sub s field f (0..5 = min xyz,
# max xyz, 6 = non-empty flag) at [BRICK_DATA_ROWS, s * 8 + f]; padded to
# 8-row alignment
BRICK_ROWS = BRICK_DATA_ROWS + 8             # [136, 128] per-brick block
# stack slots of the JAX package's walk (the TPU kernel's SMEM stack); the
# walk needs at most tree_depth + 1 live slots
STACK_DEPTH = 192
# coarse boxes for the target-signature sort key (one bit per box in the
# key's high bits; ops/wave_step.py::_sig_key)
SIG_BOXES = 16
# the JAX package's resident top-tree budget (TPU SMEM), kept so that both
# packages accept the same scenes
MAX_TOP_NODES = 18_000


# floats of a WalkTable node record (64 bytes)
NODE_FLOATS = 16
# floats 1..9 of a prim record: p0, e1, e2 of the triangle test
TRI_FLOATS = 9


@dataclass
class WalkTable:
    """The compact table the per-ray brick walk reads (all on one device).

    ``nodes`` [num_top, 16] f32, one 64-byte record per top-tree node:
    floats 0..5 the node's own box (min xyz, max xyz), 6 its skip link and
    7 its brick id (int32 bits; -1 for an internal node); for an internal
    node 8..10 the sums ``b[f] + b[f + 3]`` (twice the box centre) of its
    left child's box, 11 the left child (node + 1, int32 bits), 12..14 the
    same sums of its right child and 15 the right child (the left child's
    skip link).  A leaf's floats 8..15 are zero.  One pop of the walk reads
    one record; the nearer child is the one whose sums project lower on the
    ray's direction, which is the walk's ``center_key`` with the sums
    formed first, as it forms them.

    ``tris`` [num_bricks * 16, 9, 32] f32: per chunk of 32 triangle slots,
    nine runs of 32 floats, run c holding float 1 + c of each slot's record
    (p0 xyz, e1 xyz, e2 xyz).  Empty slots keep their zeros, so they miss as
    they do in the records.  The 32 lanes of a warp test a chunk's 32 triangles
    together and read each run as one 128-byte line.

    The chunk gates are compact already: the walk reads the set's own
    ``sub_boxes``."""
    nodes: torch.Tensor
    tris: torch.Tensor
    # host seconds the build took (set-up time; with the device's work when
    # the set is on a card)
    build_s: float = 0.0

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.nodes, self.tris))

    def to(self, device) -> "WalkTable":
        return WalkTable(self.nodes.to(device), self.tris.to(device),
                         self.build_s)

    @staticmethod
    def build(bricks: "BrickSet") -> "WalkTable":
        """Derive the table from a BrickSet's tensors, on their device."""
        dev = bricks.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        n = bricks.num_top
        boxes = bricks.top_boxes.reshape(-1, 8)[:n]
        links = bricks.top_links.reshape(-1, 2)[:n]
        skip, brick = links[:, 0], links[:, 1]
        inner = brick < 0
        ids = torch.arange(n, dtype=torch.int32, device=dev)
        zero = torch.zeros_like(ids)
        left = torch.where(inner, ids + 1, zero)
        right = torch.where(inner, skip[left.long()], zero)
        sums = boxes[:, 0:3] + boxes[:, 3:6]
        nodes = torch.zeros((n, NODE_FLOATS), dtype=torch.float32, device=dev)
        bits = nodes.view(torch.int32)
        nodes[:, 0:6] = boxes[:, 0:6]
        bits[:, 6] = skip
        bits[:, 7] = brick
        nodes[:, 8:11] = torch.where(inner[:, None], sums[left.long()], 0.0)
        bits[:, 11] = left
        nodes[:, 12:15] = torch.where(inner[:, None], sums[right.long()], 0.0)
        bits[:, 15] = right

        B = int(bricks.brick_data.shape[0])
        recs = bricks.brick_data[:, :BRICK_DATA_ROWS].reshape(
            B, NUM_SUBS, SUB_PRIMS, 32)
        tris = recs[..., 1:1 + TRI_FLOATS].permute(0, 1, 3, 2).reshape(
            B * NUM_SUBS, TRI_FLOATS, SUB_PRIMS).contiguous()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return WalkTable(nodes, tris, time.perf_counter() - t0)


@dataclass
class BrickSet:
    """Brick decomposition as tensors (all on one device)."""
    # [B, BRICK_ROWS, 128] f32 — brick b, prim k (0..BRICK_PRIMS-1), float
    # j (0..31) lives at [b, k // 4, (k % 4) * 32 + j], so prim k's record
    # is the 32 floats at offset k * 32 of the brick's block; row
    # BRICK_DATA_ROWS carries the 16-entry sub-AABB table
    brick_data: torch.Tensor
    # top-level tree over brick AABBs (skip-link preorder), packed 128 wide:
    # node n's box field f is top_boxes[n // 16, (n % 16) * 8 + f] (f = 0..5:
    # min xyz, max xyz), flat offset n * 8 + f; its links are
    # top_links[n // 64, (n % 64) * 2 + {0: skip, 1: brick}], flat offset
    # n * 2 + {0, 1} (brick id is -1 for internal nodes)
    top_boxes: torch.Tensor   # [ceil(Ntop/16), 128] f32
    top_links: torch.Tensor   # [ceil(Ntop/64), 128] i32
    # per-brick world AABBs (= the SAH leaf boxes)
    brick_lo: torch.Tensor    # [B,3] f32
    brick_hi: torch.Tensor    # [B,3] f32
    # the 16 sub-chunk AABBs per brick (same numbers as brick_data row
    # BRICK_DATA_ROWS): [B, NUM_SUBS, 8] f32, fields 0..5 = min/max xyz,
    # 6 = non-empty flag
    sub_boxes: torch.Tensor
    # up to SIG_BOXES coarse top-tree node AABBs, preorder, for the per-ray
    # target-signature sort key (ops/wave_step.py::_sig_key): [K, 8] f32,
    # fields 0..5 = min/max xyz, 6 = valid flag
    coarse_boxes: torch.Tensor
    # resident sphere table, megakernel row layout
    sph_rows: torch.Tensor    # [S_pad, 32] f32
    # background (0-dim f32)
    bg_r: torch.Tensor
    bg_g: torch.Tensor
    bg_b: torch.Tensor
    # point lights (NEE)
    light_pos: torch.Tensor        # [L,3] f32
    light_intensity: torch.Tensor  # [L,3] f32
    num_spheres: int
    num_bricks: int
    num_top: int
    # levels of the top tree (a lone leaf is 1); the walk's stack needs at
    # most top_depth + 1 slots
    top_depth: int

    def __post_init__(self):
        # the walk table of this set on this device, built on first use
        self._walk = None
        self._visit_boxes = None

    @property
    def device(self) -> torch.device:
        return self.brick_data.device

    def walk_table(self) -> WalkTable:
        """The set's ``WalkTable``, built on the first call and kept."""
        if self._walk is None:
            with setup_span("setup.walk_table"):
                self._walk = WalkTable.build(self)
        return self._walk

    def visit_boxes(self) -> torch.Tensor:
        """[B, 8] f32, one 32-byte record per brick for kernel B5's vote on
        a whole brick: floats 0..5 its box (``brick_lo``, ``brick_hi``), 6
        the number of its valid chunks, 7 zero.  Derived in torch ops on the
        set's device at the first call and kept (a copy made by ``.to``
        derives its own).  The box holds every valid chunk's gate box: both
        are minima and maxima of the same triangles' float32 bounds."""
        if self._visit_boxes is None:
            valid = self.sub_boxes[:, :, 6] > 0.0
            self._visit_boxes = torch.cat(
                [self.brick_lo, self.brick_hi,
                 valid.sum(dim=1, keepdim=True).to(torch.float32),
                 torch.zeros_like(self.brick_lo[:, :1])], dim=1).contiguous()
        return self._visit_boxes

    @property
    def nbytes(self) -> int:
        """Bytes of all tensors (what ``.to(device)`` uploads)."""
        return sum(v.numel() * v.element_size()
                   for v in (getattr(self, f.name)
                             for f in dataclasses.fields(self))
                   if isinstance(v, torch.Tensor))

    def to(self, device) -> "BrickSet":
        """A copy with every tensor on ``device``; a walk table that was
        built goes with it."""
        moved = {}
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            moved[f.name] = (value.to(device)
                             if isinstance(value, torch.Tensor) else value)
        out = BrickSet(**moved)
        if self._walk is not None:
            out._walk = self._walk.to(device)
        return out

    @staticmethod
    def from_numpy(device="cpu", **arrays) -> "BrickSet":
        """Build from numpy arrays (or ints for the counts) named like the
        fields — for example the JAX package's BrickSet fields read back
        with ``np.asarray``.  ``top_depth`` is computed from the links when
        it is not given (the JAX BrickSet has no such field)."""
        kwargs = {}
        for f in dataclasses.fields(BrickSet):
            if f.name == "top_depth":
                continue
            value = arrays[f.name]
            if f.name in _STATIC:
                kwargs[f.name] = int(value)
            else:
                kwargs[f.name] = torch.as_tensor(np.array(value),
                                                 device=device)
        depth = arrays.get("top_depth")
        if depth is None:
            depth = top_tree_depth(np.asarray(arrays["top_links"]),
                                   kwargs["num_top"])
        kwargs["top_depth"] = int(depth)
        return BrickSet(**kwargs)

    @staticmethod
    @setup_span("setup.host_set")
    def from_pack(pack: ScenePack, device="cpu") -> "BrickSet":
        return BrickSet.from_numpy(device=device, **build_bricks(pack))


_STATIC = ("num_spheres", "num_bricks", "num_top", "top_depth")


def top_tree_depth(top_links: np.ndarray, num_top: int) -> int:
    """Levels of the skip-link preorder tree stored in ``top_links`` (the
    SAH build's ``depth``): an internal node n has children n + 1 and
    skip[n + 1], and preorder visits parents first."""
    links = np.asarray(top_links).reshape(-1, 2)[:num_top]
    skip, brick = links[:, 0], links[:, 1]
    level = np.zeros(num_top, np.int64)
    level[0] = 1
    for n in range(num_top):
        if brick[n] < 0:
            level[n + 1] = level[n] + 1
            level[skip[n + 1]] = level[n] + 1
    return int(level.max())


def build_bricks(pack: ScenePack) -> dict:
    """Host build of the brick decomposition: a dict of numpy arrays and
    ints named like the BrickSet fields (``BrickSet.from_numpy``)."""
    S, F = pack.num_spheres, pack.num_triangles
    if F == 0:
        raise ValueError("brick set needs triangles; sphere-only scenes "
                         "take the megakernel path")
    rows = _build_prim_rows(pack)            # [P_pad, 32], spheres first

    sph_pad = max(8, -(-max(S, 1) // 8) * 8)
    sph_rows = np.zeros((sph_pad, 32), np.float32)
    sph_rows[:S] = rows[:S]

    tri_rows = rows[S:S + F]                 # [F, 32]
    p0 = pack.tri_p0.astype(np.float32)
    p1 = p0 + pack.tri_e1.astype(np.float32)
    p2 = p0 + pack.tri_e2.astype(np.float32)
    tmin = np.minimum(np.minimum(p0, p1), p2)
    tmax = np.maximum(np.maximum(p0, p1), p2)

    top = build_sah_treelets(tmin, tmax, leaf_size=BRICK_PRIMS)
    if top.num_nodes > MAX_TOP_NODES:
        raise ValueError(
            f"scene needs {top.num_nodes} top-tree nodes; the brick top "
            f"tree caps at {MAX_TOP_NODES} (~4.6M triangles)")
    assert top.depth + 2 <= STACK_DEPTH, (top.depth, STACK_DEPTH)
    B = top.num_leaves

    # global Morton order used WITHIN each brick: tight consecutive
    # 32-prim sub-chunks for the chunk gates
    morton = morton_codes(0.5 * (tmin.astype(np.float64) + tmax))

    # one stable lexsort orders all prims (brick-major, Morton within
    # brick), one fancy-index scatter fills the padded blocks, and
    # per-chunk AABBs come from minimum/maximum.reduceat over the
    # chunk-run boundaries
    brick_of = np.repeat(np.arange(B, dtype=np.int64), top.leaf_count)
    sort_in_brick = np.lexsort((morton[top.order], brick_of))
    ids_sorted = top.order[sort_in_brick]           # brick-major, Morton
    pos = np.arange(F, dtype=np.int64) - top.leaf_start[brick_of]
    flat = brick_of * BRICK_PRIMS + pos             # slot in padded blocks

    brick_prims = np.zeros((B * BRICK_PRIMS, 32), np.float32)
    brick_prims[flat] = tri_rows[ids_sorted]

    sid = brick_of * NUM_SUBS + pos // SUB_PRIMS    # chunk id, nondecreasing
    starts = np.flatnonzero(np.diff(sid, prepend=-1))
    smin = np.minimum.reduceat(tmin[ids_sorted], starts, axis=0)
    smax = np.maximum.reduceat(tmax[ids_sorted], starts, axis=0)
    sub_tbl = np.zeros((B * NUM_SUBS, 8), np.float32)
    occ = sid[starts]                               # occupied chunk ids
    sub_tbl[occ, 0:3] = smin
    sub_tbl[occ, 3:6] = smax
    # field 6 marks real (non-empty) chunks — an inverted/sentinel box
    # is NOT a reliable slab-test miss once min/max swaps normalize it
    sub_tbl[occ, 6] = 1.0

    data = np.zeros((B, BRICK_ROWS, 128), np.float32)
    data[:, :BRICK_DATA_ROWS, :] = brick_prims.reshape(
        B, BRICK_DATA_ROWS, 128)
    data[:, BRICK_DATA_ROWS, :] = sub_tbl.reshape(B, 128)

    Ntop = top.num_nodes
    boxes = np.zeros((-(-Ntop // 16) * 16, 8), np.float32)
    boxes[:Ntop, 0:3] = top.node_min
    boxes[:Ntop, 3:6] = top.node_max
    top_boxes = boxes.reshape(-1, 128)
    links = np.zeros((-(-Ntop // 64) * 64, 2), np.int32)
    links[:Ntop, 0] = top.skip
    links[:Ntop, 1] = top.leaf_of_node   # brick id at leaves, -1 internal
    top_links = links.reshape(-1, 128)

    # brick AABBs = the SAH leaf node boxes, in brick (preorder-leaf) order
    leaf_nodes = np.nonzero(top.leaf_of_node >= 0)[0]
    brick_lo = top.node_min[leaf_nodes].astype(np.float32)
    brick_hi = top.node_max[leaf_nodes].astype(np.float32)

    # coarse boxes: split the top tree breadth-first (largest-area node
    # first) until SIG_BOXES nodes cover every brick — the per-ray target
    # signature groups rays by which of these their line can touch
    coarse = _coarse_cut(top, SIG_BOXES)

    return dict(
        brick_data=data,
        brick_lo=brick_lo, brick_hi=brick_hi,
        sub_boxes=sub_tbl.reshape(B, NUM_SUBS, 8).copy(),
        coarse_boxes=coarse,
        top_boxes=top_boxes, top_links=top_links, sph_rows=sph_rows,
        bg_r=np.float32(pack.background[0]),
        bg_g=np.float32(pack.background[1]),
        bg_b=np.float32(pack.background[2]),
        light_pos=pack.light_pos.astype(np.float32),
        light_intensity=pack.light_intensity.astype(np.float32),
        num_spheres=S, num_bricks=B, num_top=Ntop, top_depth=top.depth)


def _coarse_cut(top, k_max: int) -> np.ndarray:
    """Cut the preorder skip-link treelet into <= ``k_max`` disjoint
    subtree-root boxes by repeatedly splitting the largest-surface node.
    Returns [k_max, 8] f32 rows (min xyz, max xyz, valid, 0), preorder
    ordered so neighboring signature bits are spatially adjacent."""
    def area(n):
        d = np.maximum(top.node_max[n] - top.node_min[n], 0.0)
        return float(d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    def children(n):
        if top.leaf_of_node[n] >= 0:
            return None
        left = n + 1
        return left, int(top.skip[left])

    cut = [0]
    while len(cut) < k_max:
        splittable = [n for n in cut if children(n) is not None]
        if not splittable:
            break
        n = max(splittable, key=area)
        l, r = children(n)
        cut.remove(n)
        cut.extend([l, r])
    cut.sort()   # preorder = spatial locality of neighboring bits
    out = np.zeros((k_max, 8), np.float32)
    for i, n in enumerate(cut):
        out[i, 0:3] = top.node_min[n]
        out[i, 3:6] = top.node_max[n]
        out[i, 6] = 1.0
    return out


def brick_prim_count(brickset: BrickSet, b: int) -> int:
    """Real (non-padding) prims in brick b — padding rows have kind 0."""
    rows = brickset.brick_data[b, :BRICK_DATA_ROWS].reshape(BRICK_PRIMS, 32)
    return int((rows[:, 0] != 0).sum())
