"""Vectorized host-side BVH builder with a TPU-friendly flattened layout.

Replaces the reference's recursive copy-and-sort median-split builder
(bvh.cu:16-65 in jayHuggie/PathTracer_CUDA_Interactive), which is
O(n log^2 n) with a full vector copy per node and takes 56 s for the 1.09M
triangle buddha (README.md:132).  Here the whole build is vectorized numpy:

1. primitive centroids -> 63-bit Morton codes (one argsort)
2. implicit balanced binary tree over the Morton-sorted order
   (ranges computed level-by-level with array ops; ~log2(P) iterations)
3. bottom-up AABB merge per level
4. preorder (DFS) index assignment propagated top-down per level:
     pre(left) = pre(parent) + 1, pre(right) = pre(parent) + |left subtree|
   + 1 — so the flattened skip-link layout is produced with ~log2(P)
   vectorized passes and no sequential traversal.

Flattened layout ("skip-link" / escape-index BVH, the stackless-friendly
form SURVEY.md §7 calls for):  nodes stored in DFS preorder, so that during
traversal a box *hit* on an internal node advances to ``i + 1`` and a miss
(or a processed leaf) jumps to ``skip[i]``.  Leaves hold one primitive each
(like the reference, bvh.cu:18-25).  The device traversal therefore needs a
single int cursor per ray — no per-lane stack (contrast scene.h:251-256's
64-deep stack).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class FlatBVH:
    """Preorder skip-link BVH arrays (host numpy; device packing happens in
    scenepack)."""
    node_min: np.ndarray   # [N,3] f32 — valid for internal nodes and leaves
    node_max: np.ndarray   # [N,3] f32
    skip: np.ndarray       # [N] i32 — next preorder index on miss/after-leaf
    prim: np.ndarray       # [N] i32 — original primitive id at leaves, -1 internal
    depth: int             # max tree depth (diagnostic; reference scene.cpp:147-149)

    @property
    def num_nodes(self) -> int:
        return int(self.node_min.shape[0])


def _expand_bits_21(v: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of each uint64 to every 3rd bit."""
    v = v.astype(np.uint64) & np.uint64(0x1FFFFF)
    v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
    return v


def morton_codes(centroids: np.ndarray) -> np.ndarray:
    """63-bit Morton codes for [P,3] points (normalized to the scene AABB)."""
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    extent = np.maximum(hi - lo, 1e-30)
    q = np.clip((centroids - lo) / extent, 0.0, 1.0)
    grid = np.minimum((q * (1 << 21)).astype(np.uint64), np.uint64((1 << 21) - 1))
    return ((_expand_bits_21(grid[:, 0]) << np.uint64(2))
            | (_expand_bits_21(grid[:, 1]) << np.uint64(1))
            | _expand_bits_21(grid[:, 2]))


def build_bvh(prim_min: np.ndarray, prim_max: np.ndarray) -> FlatBVH:
    """Build the flattened preorder BVH for primitives with AABBs
    ``prim_min``/``prim_max`` ([P,3] float arrays).

    Vectorized numpy, with no native twin."""
    P = int(prim_min.shape[0])
    if P == 0:
        raise ValueError("cannot build a BVH over zero primitives")

    prim_min = np.asarray(prim_min, np.float32)
    prim_max = np.asarray(prim_max, np.float32)

    centroids = 0.5 * (prim_min.astype(np.float64) + prim_max.astype(np.float64))
    order = np.argsort(morton_codes(centroids), kind="stable").astype(np.int64)
    smin = prim_min[order]
    smax = prim_max[order]

    # --- enumerate tree levels top-down, assigning preorder ------------
    # Each node is a contiguous range [f, l] of the sorted order; internal
    # nodes split at the midpoint.  levels[d] = (f_array, l_array, pre_array).
    levels = []
    f = np.array([0], np.int64)
    l = np.array([P - 1], np.int64)
    pre = np.array([0], np.int64)
    while len(f):
        levels.append((f, l, pre))
        internal = f < l
        fi, li, pi = f[internal], l[internal], pre[internal]
        n = li - fi + 1
        s = fi + (n + 1) // 2 - 1  # left gets ceil(n/2)
        # preorder: left child right after parent; right child after the
        # whole left subtree (size 2*(s-f+1)-1).
        f = np.concatenate([fi, s + 1])
        l = np.concatenate([s, li])
        pre = np.concatenate([pi + 1, pi + 2 * (s - fi + 1)])
        # keep children of one level together, ordered (left..., right...)
        if not internal.any():
            break

    max_depth = len(levels)

    all_f = np.concatenate([lv[0] for lv in levels])
    all_l = np.concatenate([lv[1] for lv in levels])
    pre = np.concatenate([lv[2] for lv in levels])
    N = len(all_f)
    assert N == 2 * P - 1

    subtree = 2 * (all_l - all_f + 1) - 1
    skip = np.empty(N, np.int64)
    skip[pre] = pre + subtree  # == N for the rightmost spine

    # --- AABBs: leaves direct, internal bottom-up ----------------------
    node_min = np.empty((N, 3), np.float32)
    node_max = np.empty((N, 3), np.float32)
    prim = np.full(N, -1, np.int32)

    is_leaf_all = all_f == all_l
    leaf_pre = pre[is_leaf_all]
    node_min[leaf_pre] = smin[all_f[is_leaf_all]]
    node_max[leaf_pre] = smax[all_f[is_leaf_all]]
    prim[leaf_pre] = order[all_f[is_leaf_all]].astype(np.int32)

    # Internal nodes, deepest level first.  Children of node [f,l] are
    # [f,s] and [s+1,l]; their preorder indices are pre+1 and skip(left).
    offsets = np.cumsum([0] + [len(lv[0]) for lv in levels])
    for d in range(max_depth - 1, -1, -1):
        sl = slice(offsets[d], offsets[d + 1])
        f_d, l_d, pre_d = all_f[sl], all_l[sl], pre[sl]
        internal = f_d < l_d
        if not internal.any():
            continue
        fi, li, pi = f_d[internal], l_d[internal], pre_d[internal]
        s = fi + (li - fi + 2) // 2 - 1
        left_pre = pi + 1
        right_pre = pi + 1 + 2 * (s - fi + 1) - 1
        node_min[pi] = np.minimum(node_min[left_pre], node_min[right_pre])
        node_max[pi] = np.maximum(node_max[left_pre], node_max[right_pre])

    return FlatBVH(node_min=node_min, node_max=node_max,
                   skip=skip.astype(np.int32), prim=prim, depth=max_depth)
