"""The brick trace in plain torch ops: the plain version of kernel B2.

The JAX package's slim brick intersector
(``pathtracer_cuda_interactive_tpu/ops/brickkernel.py::
make_brick_intersect(slim=True)``, run per wave by
``ops/wavefront.py::_make_trace_kernel_slim``) finds, for every ray of a
wave, the closest triangle over a ``BrickSet`` (models/bricks.py): a walk
of the skip-link top tree, nearer child first, whose leaves are bricks of
512 triangles behind 16 chunk gates of 32 triangles.  It returns
``(t, slot)``: the hit distance (inf on a miss) and ``slot = brick * 512 +
k``, the row of the winning triangle in the flattened brick records, or -1.
Spheres are left to the caller (ops/wavefront.py::_record_from_slots).

``trace_bricks_plain`` computes the same in torch.  It is the CPU path of
the wavefront (ops/wavefront.py::trace_wave_slim sends CPU tensors here)
and what the CUDA kernel (csrc/brick_trace.cu) is held to on the card.
Both walk per ray, as the reference CUDA design does (scene.h:246-301),
where the TPU walks per packet of 2048 rays:

* each ray keeps its own stack of nodes; a node whose box the ray misses,
  or that starts beyond the ray's best hit, is dropped;
* at an internal node the child whose box center lies nearer along the
  RAY's direction is visited first (the TPU orders by the packet's mean
  direction; the order only decides which of two equal-t hits wins);
* at a leaf, chunk s of the brick is tested only while its sub-AABB gate
  passes against the current best t, and inside a chunk the first
  triangle with the smallest t wins (strict ``t < best``), as in
  ``_tri_slot_body``.

Rays walk in lockstep, one node per step, and a ray whose stack is empty
leaves the batch.  At a leaf all 512 triangle tests run at once, in ray
chunks of ``LEAF_CHUNK`` so memory stays bounded at 640x480; the 16 chunk
gates are then applied in order, which gives what the sequential loop
gives, since a chunk's best t and first-best index do not depend on the
running best.
"""

from __future__ import annotations

import torch

from ..models.bricks import (BRICK_DATA_ROWS, BRICK_PRIMS, BRICK_ROWS,
                             NUM_SUBS, SUB_PRIMS, BrickSet)
from . import geometry as g
from .vec import Vec3

INF = float("inf")
# rays per batch of leaf tests: [LEAF_CHUNK, 512] float temporaries (32 MiB)
LEAF_CHUNK = 16384


def _brick_views(bricks: BrickSet):
    """Views (no copies) of the brick records: triangle p0/e1/e2 as
    [B, 512, 9] and the sub-AABB rows as [B, 16, 8]."""
    B = int(bricks.brick_data.shape[0])
    flat = bricks.brick_data.reshape(B, BRICK_ROWS * 128)
    recs = flat[:, :BRICK_DATA_ROWS * 128].view(B, BRICK_PRIMS, 32)
    sub = flat[:, BRICK_DATA_ROWS * 128:(BRICK_DATA_ROWS + 1) * 128]
    return recs[:, :, 1:10], sub.view(B, NUM_SUBS, 8)


def _leaf(tris, subs, brick, o: Vec3, d: Vec3, inv: Vec3, tnear: float,
          best_t, best_slot):
    """Test rays against one brick each (``brick`` [m] i64); returns the
    updated (best_t, best_slot)."""
    m = int(brick.shape[0])
    sb = subs[brick]                                     # [m, 16, 8]
    col = lambda v: v[:, None]
    oc = Vec3(col(o.x), col(o.y), col(o.z))
    dc = Vec3(col(d.x), col(d.y), col(d.z))
    ic = Vec3(col(inv.x), col(inv.y), col(inv.z))
    tn_s, tf_s = g.slab_interval(oc, ic, Vec3(sb[..., 0], sb[..., 1],
                                              sb[..., 2]),
                                 Vec3(sb[..., 3], sb[..., 4], sb[..., 5]))
    valid_s = sb[..., 6] > 0.0

    tr = tris[brick]                                     # [m, 512, 9]
    p0 = Vec3(tr[..., 0], tr[..., 1], tr[..., 2])
    e1 = Vec3(tr[..., 3], tr[..., 4], tr[..., 5])
    e2 = Vec3(tr[..., 6], tr[..., 7], tr[..., 8])
    t, _u, _v, hit = g.intersect_triangle(p0, e1, e2, oc, dc, tnear, INF)
    t = torch.where(hit, t, INF).view(m, NUM_SUBS, SUB_PRIMS)
    chunk_t = torch.amin(t, dim=-1)                      # [m, 16]
    chunk_k = torch.argmin(t, dim=-1).to(torch.int32)    # first minimum

    base = brick.to(torch.int32) * BRICK_PRIMS
    for s in range(NUM_SUBS):
        gate = valid_s[:, s] & g.slab_hit(tn_s[:, s], tf_s[:, s], best_t)
        take = gate & (chunk_t[:, s] < best_t)
        best_t = torch.where(take, chunk_t[:, s], best_t)
        best_slot = torch.where(take, base + (s * SUB_PRIMS) + chunk_k[:, s],
                                best_slot)
    return best_t, best_slot


def trace_bricks_plain(bricks: BrickSet, org: Vec3, dirn: Vec3,
                       tnear: float, active=None):
    """Closest triangle hit of every ray over the brick set: (t f32, inf on
    a miss; slot i32, -1 on a miss), each of the rays' shape.  Rays where
    ``active`` is False are not traced.  Spheres are not tested."""
    shape = org.x.shape
    dev = org.x.device
    n = org.x.numel()
    out_t = torch.full((n,), INF, dtype=torch.float32, device=dev)
    out_slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    ids = (torch.arange(n, device=dev) if active is None
           else torch.nonzero(active.reshape(-1)).reshape(-1))
    m = int(ids.numel())
    if m == 0:
        return out_t.reshape(shape), out_slot.reshape(shape)

    tris, subs = _brick_views(bricks)
    boxes = bricks.top_boxes.reshape(-1, 8)        # node n -> row n
    links = bricks.top_links.reshape(-1, 2).to(torch.int64)
    o = Vec3(*(c.reshape(-1)[ids] for c in org))
    d = Vec3(*(c.reshape(-1)[ids] for c in dirn))
    inv = Vec3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    best_t = torch.full((m,), INF, dtype=torch.float32, device=dev)
    best_slot = torch.full((m,), -1, dtype=torch.int32, device=dev)
    stack = torch.zeros((m, bricks.top_depth + 2), dtype=torch.int64,
                        device=dev)
    sp = torch.ones(m, dtype=torch.int64, device=dev)

    while ids.numel():
        rows = torch.arange(ids.numel(), device=dev)
        sp = sp - 1
        node = stack[rows, sp]
        box = boxes[node]
        tn, tf = g.slab_interval(o, inv, Vec3(box[:, 0], box[:, 1], box[:, 2]),
                                 Vec3(box[:, 3], box[:, 4], box[:, 5]))
        hit = g.slab_hit(tn, tf, best_t)
        brick = links[node, 1]

        leaf = torch.nonzero(hit & (brick >= 0)).reshape(-1)
        for c0 in range(0, int(leaf.numel()), LEAF_CHUNK):
            li = leaf[c0:c0 + LEAF_CHUNK]
            sel = lambda v, li=li: Vec3(v.x[li], v.y[li], v.z[li])
            bt, bs = _leaf(tris, subs, brick[li], sel(o), sel(d), sel(inv),
                           tnear, best_t[li], best_slot[li])
            best_t[li] = bt
            best_slot[li] = bs

        di = torch.nonzero(hit & (brick < 0)).reshape(-1)
        if di.numel():
            left = node[di] + 1
            right = links[left, 0]
            dd = Vec3(d.x[di], d.y[di], d.z[di])

            def center_key(n):
                b = boxes[n]
                return ((b[:, 0] + b[:, 3]) * dd.x + (b[:, 1] + b[:, 4]) * dd.y
                        + (b[:, 2] + b[:, 5]) * dd.z)

            left_first = center_key(left) <= center_key(right)
            near = torch.where(left_first, left, right)
            far = torch.where(left_first, right, left)
            stack[di, sp[di]] = far
            stack[di, sp[di] + 1] = near      # popped first
            sp[di] += 2

        done = sp == 0
        if bool(done.any()):
            out_t[ids[done]] = best_t[done]
            out_slot[ids[done]] = best_slot[done]
            keep = ~done
            ids, sp, stack = ids[keep], sp[keep], stack[keep]
            best_t, best_slot = best_t[keep], best_slot[keep]
            o = Vec3(*(v[keep] for v in o))
            d = Vec3(*(v[keep] for v in d))
            inv = Vec3(*(v[keep] for v in inv))
    return out_t.reshape(shape), out_slot.reshape(shape)
