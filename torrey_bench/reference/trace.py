"""Skip-link BVH walk in plain torch ops (large scenes).

Frozen from the PyTorch port's ``ops/trace.py``.  The BVH is
flattened to preorder with skip links (models/bvh.py, packed as 16-lane fat
nodes by models/scenepack.py) and every ray carries one int cursor:

    internal node, box hit   -> cursor + 1     (descend)
    internal node, box miss  -> skip[cursor]   (skip subtree)
    leaf (test its primitive)-> skip[cursor]

Each step advances every walking ray by one node: one row gather, the box,
triangle and sphere tests, and a select by node kind, op for op as in the
JAX package.  Every ``COMPACT_STEPS`` steps the rays whose walk ended
leave the batch, so a step costs about the rays still walking and the host
reads one count a block of steps.  It is the plain integrator's closest hit above
``BRUTE_FORCE_MAX_PRIMS`` primitives and its NEE shadow test, and the
oracle the wavefront path (ops/wavefront.py) is held to.  The walk runs
under ``torch.no_grad``, as the JAX package stop-grads every input of its
own: a hit id carries no gradient.
"""

from __future__ import annotations

import torch

from .scenepack import KIND_INTERNAL, KIND_SPHERE, KIND_TRI
from . import geometry as g
from .vec import Vec3

# steps of the walk between two compactions of the batch: each compaction
# reads the count of ended walks on the host
COMPACT_STEPS = 8

def _flat(v, shape, device):
    return torch.broadcast_to(torch.as_tensor(v, dtype=torch.float32,
                                              device=device),
                              shape).reshape(-1)


def walk_step(nodes: torch.Tensor, ints: torch.Tensor, cur, org: Vec3,
              dirn: Vec3, inv: Vec3, tn, t_max, hit):
    """Advance every walk by one node of the flattened tree ``nodes``
    (``ints`` its int32 view): the box test of an internal node, the
    primitive test of a leaf, the closer hit kept.  A walk whose cursor is
    past the last node has ended and keeps its state.  Returns (cur, t_max,
    hit, kind of the node visited, mask of the walks that visited one)."""
    N = int(nodes.shape[0])
    walking = cur < N
    safe = torch.clamp_max(cur, N - 1)
    row = nodes[safe]                         # [m, 16]
    irow = ints[safe]
    a = Vec3(row[:, 0], row[:, 1], row[:, 2])
    b = Vec3(row[:, 3], row[:, 4], row[:, 5])
    c = Vec3(row[:, 6], row[:, 7], row[:, 8])
    skip, prim, kind = irow[:, 12], irow[:, 13], irow[:, 14]

    is_tri = kind == KIND_TRI
    box_hit = g.slab_test(org, inv, a, b, t_max)
    t_tri, _, _, hit_tri = g.intersect_triangle(a, b, c, org, dirn, tn, t_max)
    t_sph, hit_sph = g.intersect_sphere(a, b.x, org, dirn, tn, t_max)

    prim_hit = (is_tri & hit_tri) | ((kind == KIND_SPHERE) & hit_sph)
    prim_t = torch.where(is_tri, t_tri, t_sph)
    closer = prim_hit & (prim_t < t_max) & walking
    t_max = torch.where(closer, prim_t, t_max)
    hit = torch.where(closer, prim, hit)

    descend = (kind == KIND_INTERNAL) & box_hit
    cur = torch.where(walking, torch.where(descend, cur + 1,
                                           skip.to(torch.int64)), cur)
    return cur, t_max, hit, kind, walking


@torch.no_grad()
def _traverse(bvh_nodes: torch.Tensor, org: Vec3, dirn: Vec3, tnear,
              t_limit, counts=None):
    """(prim [shape] i32, -1 = miss; t [shape] f32) of the closest hit
    closer than ``t_limit`` (None: no limit).  ``counts``, a dict, gets
    the box, triangle and sphere tests the walks made added under "box",
    "tri" and "sphere": one a node a walk visits, until its walk ends."""
    shape = org.x.shape
    dev = org.x.device
    N = int(bvh_nodes.shape[0])
    nodes = bvh_nodes.contiguous()
    ints = nodes.view(torch.int32)
    n = org.x.numel()

    o = Vec3(*(c.reshape(-1) for c in org))
    d = Vec3(*(c.reshape(-1) for c in dirn))
    inv = Vec3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    tn = _flat(tnear, shape, dev)
    t_max = (torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
             if t_limit is None else _flat(t_limit, shape, dev).clone())
    hit = torch.full((n,), -1, dtype=torch.int32, device=dev)
    out_t = t_max.clone()
    out_hit = hit.clone()

    ids = torch.arange(n, device=dev)
    cur = torch.zeros(n, dtype=torch.int64, device=dev)
    tests = torch.zeros(3, dtype=torch.int64, device=dev)
    kinds = torch.tensor([KIND_INTERNAL, KIND_TRI, KIND_SPHERE],
                         dtype=torch.int32, device=dev)
    step = 0
    while ids.numel():
        cur, t_max, hit, kind, walking = walk_step(nodes, ints, cur, o, d,
                                                   inv, tn, t_max, hit)
        if counts is not None:
            tests += ((kind[None] == kinds[:, None])
                      & walking[None]).sum(dim=1)
        step += 1
        if step % COMPACT_STEPS:
            continue
        done = cur >= N
        if not int(done.sum()):             # the one host read a block
            continue
        fin = done.nonzero().squeeze(1)
        out_t.index_copy_(0, ids[fin], t_max[fin])
        out_hit.index_copy_(0, ids[fin], hit[fin])
        keep = (~done).nonzero().squeeze(1)
        ids, cur, t_max, hit, tn = (v.index_select(0, keep)
                                    for v in (ids, cur, t_max, hit, tn))
        o, d, inv = (Vec3(*(c.index_select(0, keep) for c in v))
                     for v in (o, d, inv))
    if counts is not None:
        for key, value in zip(("box", "tri", "sphere"), tests.tolist()):
            counts[key] = counts.get(key, 0) + value
    return out_hit.reshape(shape), out_t.reshape(shape)


def trace_rays(bvh_nodes: torch.Tensor, org: Vec3, dirn: Vec3, tnear):
    """Closest-hit query.  Returns (prim_id i32, -1 on a miss; t), each of
    the rays' shape."""
    return _traverse(bvh_nodes, org, dirn, tnear, None)


def trace_occluded(bvh_nodes: torch.Tensor, org: Vec3, dirn: Vec3, tnear,
                   t_limit, counts=None):
    """Any-hit query for shadow rays: True where a primitive lies on the
    segment (tnear, t_limit).  ``counts``: as in ``_traverse``."""
    hit, _ = _traverse(bvh_nodes, org, dirn, tnear, t_limit, counts)
    return hit >= 0
