"""Binned-SAH treelet builder for the brick tracer (host numpy).

The port of ``pathtracer_cuda_interactive_tpu/models/sah.py``.  A classic
top-down **binned SAH** (16 bins per axis) over triangle AABBs, ending at
leaves of up to ``leaf_size`` prims.  The leaves become the bricks of
models/bricks.py (spatially tight, variable fill) and the SAH tree itself,
flattened to the same preorder skip-link layout as models/bvh.py, becomes
the top tree the brick trace walks.  Build is vectorized numpy per node;
total work is O(P · depth), a few seconds at 300k prims.

``build_sah_treelets`` dispatches to a C++ twin (models/native.py,
native/sah_treelets.cpp) when that library builds; the numpy body is its
reference and gives the same trees (tests/test_torch_native.py).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

NUM_BINS = 16


@dataclass
class SAHTreelets:
    """Preorder skip-link tree whose leaves are prim *ranges* (treelets).

    ``order`` is a permutation of primitive ids; leaf k owns
    ``order[leaf_start[k] : leaf_start[k] + leaf_count[k]]``.
    ``leaf_of_node[n]`` is k for leaf nodes, -1 for internal nodes.
    """
    node_min: np.ndarray     # [N,3] f32
    node_max: np.ndarray     # [N,3] f32
    skip: np.ndarray         # [N] i32
    leaf_of_node: np.ndarray  # [N] i32
    order: np.ndarray        # [P] i64
    leaf_start: np.ndarray   # [B] i64
    leaf_count: np.ndarray   # [B] i64
    depth: int

    @property
    def num_nodes(self) -> int:
        return int(self.node_min.shape[0])

    @property
    def num_leaves(self) -> int:
        return int(self.leaf_start.shape[0])


def _sah_split(idx, prim_min, prim_max, cent):
    """Best binned-SAH split of the prim set ``idx``.
    Returns (left_idx, right_idx) or None when no valid split exists
    (degenerate: all centroids coincide)."""
    c = cent[idx]
    cmin = c.min(axis=0)
    cmax = c.max(axis=0)
    ext = cmax - cmin
    n = len(idx)
    pmin = prim_min[idx]
    pmax = prim_max[idx]

    best_cost = np.inf
    best = None
    for ax in range(3):
        if ext[ax] <= 0.0:
            continue
        t = np.minimum(((c[:, ax] - cmin[ax]) * (NUM_BINS / ext[ax]))
                       .astype(np.int64), NUM_BINS - 1)
        counts = np.bincount(t, minlength=NUM_BINS)
        bmin = np.full((NUM_BINS, 3), np.inf, np.float64)
        bmax = np.full((NUM_BINS, 3), -np.inf, np.float64)
        np.minimum.at(bmin, t, pmin)
        np.maximum.at(bmax, t, pmax)
        lmin = np.minimum.accumulate(bmin, axis=0)
        lmax = np.maximum.accumulate(bmax, axis=0)
        rmin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1]
        rmax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1]

        def area(mn, mx):
            d = np.maximum(mx - mn, 0.0)
            return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

        nl = np.cumsum(counts)[:-1]
        nr = n - nl
        cost = area(lmin[:-1], lmax[:-1]) * nl + area(rmin[1:], rmax[1:]) * nr
        cost = np.where((nl > 0) & (nr > 0), cost, np.inf)
        b = int(np.argmin(cost))
        if cost[b] < best_cost:
            best_cost = cost[b]
            best = (t <= b)
    if best is None:
        return None
    return idx[best], idx[~best]


# Beyond this depth, splits switch from SAH to balanced median halves so
# the total depth stays within the brick trace's stack (models/bricks.py
# STACK_DEPTH; the walk uses at most depth + 1 slots).
MAX_SAH_DEPTH = 96


def build_sah_treelets(prim_min: np.ndarray, prim_max: np.ndarray,
                       leaf_size: int = 512) -> SAHTreelets:
    """Top-down binned-SAH build terminating at ≤ ``leaf_size``-prim
    leaves.  Depth is bounded: past MAX_SAH_DEPTH the split degrades to
    balanced centroid-median halves (adds ≤ log2(n) further levels).

    Dispatches to the C++ twin (native/sah_treelets.cpp via
    models/native.py: the same numerics, bit-identical output) when it is
    available; the numpy body is the always-available fallback and the
    reference."""
    from .native import build_sah_treelets_native
    nat = build_sah_treelets_native(prim_min, prim_max, leaf_size)
    if nat is not None:
        return SAHTreelets(node_min=nat[0], node_max=nat[1], skip=nat[2],
                           leaf_of_node=nat[3], order=nat[4],
                           leaf_start=nat[5], leaf_count=nat[6],
                           depth=nat[7])
    return _build_sah_treelets_numpy(prim_min, prim_max, leaf_size)


def _build_sah_treelets_numpy(prim_min: np.ndarray, prim_max: np.ndarray,
                              leaf_size: int = 512) -> SAHTreelets:
    prim_min = np.asarray(prim_min, np.float64)
    prim_max = np.asarray(prim_max, np.float64)
    P = int(prim_min.shape[0])
    if P == 0:
        raise ValueError("cannot build a tree over zero primitives")
    cent = 0.5 * (prim_min + prim_max)

    # children[i] = (left, right) or None for leaf; boxes per node
    children: list = []
    node_lo: list = []
    node_hi: list = []
    leaf_sets: list = []
    leaf_of: list = []

    sys.setrecursionlimit(max(10000, sys.getrecursionlimit()))

    def rec(idx, depth):
        ni = len(children)
        children.append(None)
        node_lo.append(prim_min[idx].min(axis=0))
        node_hi.append(prim_max[idx].max(axis=0))
        leaf_of.append(-1)
        split = None
        if len(idx) > leaf_size:
            if depth < MAX_SAH_DEPTH:
                split = _sah_split(idx, prim_min, prim_max, cent)
            if split is None:
                # degenerate (coincident centroids) or depth-capped:
                # balanced median halves on the largest centroid axis
                c = cent[idx]
                ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
                half = len(idx) // 2
                part = np.argpartition(c[:, ax], half)
                split = (idx[part[:half]], idx[part[half:]])
        if split is None:
            leaf_of[ni] = len(leaf_sets)
            leaf_sets.append(idx)
            return ni, 1
        li, dl = rec(split[0], depth + 1)
        ri, dr = rec(split[1], depth + 1)
        children[ni] = (li, ri)
        return ni, 1 + max(dl, dr)

    root, depth = rec(np.arange(P, dtype=np.int64), 0)
    assert root == 0
    M = len(children)

    # ---- flatten to preorder skip-link arrays (explicit stack) ----------
    N = M
    pre = np.empty(N, np.int64)          # build index -> preorder index
    order_nodes = np.empty(N, np.int64)  # preorder index -> build index
    skip = np.empty(N, np.int64)
    # subtree sizes bottom-up (children always have larger build index)
    size = np.ones(N, np.int64)
    for i in range(N - 1, -1, -1):
        if children[i] is not None:
            size[i] = 1 + size[children[i][0]] + size[children[i][1]]
    stack = [(root, 0)]
    while stack:
        i, p = stack.pop()
        pre[i] = p
        order_nodes[p] = i
        skip[p] = p + size[i]
        if children[i] is not None:
            l, r = children[i]
            stack.append((r, p + 1 + size[l]))
            stack.append((l, p + 1))

    node_min = np.asarray(node_lo, np.float32)[order_nodes]
    node_max = np.asarray(node_hi, np.float32)[order_nodes]
    leaf_of_node = np.asarray(leaf_of, np.int32)[order_nodes]

    # leaves numbered in preorder; order grouped accordingly
    leaf_nodes = np.nonzero(leaf_of_node >= 0)[0]
    sets = [leaf_sets[leaf_of_node[n]] for n in leaf_nodes]
    leaf_of_node_out = np.full(N, -1, np.int32)
    leaf_of_node_out[leaf_nodes] = np.arange(len(sets), dtype=np.int32)
    counts = np.array([len(s) for s in sets], np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    order = np.concatenate(sets) if sets else np.empty(0, np.int64)
    assert order.shape[0] == P

    return SAHTreelets(node_min=node_min, node_max=node_max,
                       skip=skip.astype(np.int32),
                       leaf_of_node=leaf_of_node_out, order=order,
                       leaf_start=starts, leaf_count=counts, depth=depth)


def validate_treelets(t: SAHTreelets, prim_min, prim_max) -> None:
    """Structural invariants: permutation covers all prims exactly once;
    every leaf box contains its prims; skip links strictly increase."""
    P = len(prim_min)
    assert np.array_equal(np.sort(t.order), np.arange(P))
    N = t.num_nodes
    assert np.all(t.skip > np.arange(N)) and np.all(t.skip <= N)
    for k in range(t.num_leaves):
        ids = t.order[t.leaf_start[k]:t.leaf_start[k] + t.leaf_count[k]]
        n = np.nonzero(t.leaf_of_node == k)[0][0]
        assert np.all(prim_min[ids] >= t.node_min[n] - 1e-4)
        assert np.all(prim_max[ids] <= t.node_max[n] + 1e-4)
    # internal node boxes contain their left child (preorder: at i+1)
    internal = t.leaf_of_node < 0
    i = np.arange(N)[internal]
    assert np.all(t.node_min[i] <= t.node_min[i + 1] + 1e-6)
    assert np.all(t.node_max[i] >= t.node_max[i + 1] - 1e-6)
