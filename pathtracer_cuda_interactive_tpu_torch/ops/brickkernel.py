"""Brick traces and the persistent brick render.

The JAX package's brick intersector (``pathtracer_cuda_interactive_tpu/
ops/brickkernel.py::make_brick_intersect``) finds, for every ray, the
closest hit over a ``BrickSet`` (models/bricks.py): a walk of the skip-link
top tree, nearer child first, whose leaves are bricks of 512 triangles
behind 16 chunk gates of 32 triangles.  Four TPU kernels are built on it,
and this module holds their plain versions in torch:

* ``trace_bricks_plain`` — the slim walk of kernel B2 (``slim=True``):
  ``(t, slot)``, the hit distance (inf on a miss) and ``slot = brick * 512
  + k``, the row of the winning triangle in the flattened brick records,
  or -1.  Spheres are left to the caller (ops/wavefront.py).
* ``trace_bricks_pipelined_plain`` — the same contract through kernel B4's
  walk, which defers every leaf by one (the JAX package's
  ``make_brick_intersect_pipelined``): the same (t, slot), more nodes and
  bricks visited.
* ``trace_bricks_full_plain`` — the full-record walk of kernel B3
  (``slim=False``): the resident spheres first, then the bricks, each with
  a strict ``t < best`` (so a sphere wins an equal-t tie), and the
  16-channel hit record of ``_select16``, position and normal from the
  (u, v) of the winning triangle's own test; optionally per-ray counters
  of nodes popped, bricks entered and chunk gates passed.
* ``render_tiles_bricks_plain`` — kernel B6, the persistent render of whole
  sample passes over a range of 64x32 screen tiles: the path loop of
  ops/integrator.py over the tiles' pixels, each bounce the full-record
  walk and then the wavefront's bounce (ops/wave_step.py::_shade), with no
  sort and no compaction of the path state.

They are the CPU paths (ops/wavefront.py sends CPU waves to the first
three, ``render_tiles_bricks`` CPU renders to the last) and what the CUDA
kernels (csrc/brick_trace.cu, csrc/brick_trace_slim2.cu,
csrc/brick_render.cu) are held to on the card.  Both
walk per ray, as the reference CUDA design does (scene.h:246-301), where
the TPU walks per packet of 2048 rays:

* each ray keeps its own stack of nodes; a node whose box the ray misses,
  or that starts beyond the ray's best hit, is dropped;
* at an internal node the child whose box center lies nearer along the
  RAY's direction is visited first (the TPU orders by the packet's mean
  direction; the order only decides which of two equal-t hits wins);
* at a leaf, chunk s of the brick is tested only while its sub-AABB gate
  passes against the current best t, and inside a chunk the first
  triangle with the smallest t wins (strict ``t < best``), as in
  ``_tri_slot_body`` and ``_tri_record_body``.

On a card the kernels read the set's compact walk table
(models/bricks.py::WalkTable, ``walk_pointers``); the plain walk reads the
set's own tensors or, given ``table=``, that table, with the same result
bit for bit.

Rays walk in lockstep, one node per step, and a ray whose stack is empty
leaves the batch.  At a leaf all 512 triangle tests run at once, in ray
chunks of ``LEAF_CHUNK`` so memory stays bounded at 640x480; the 16 chunk
gates are then applied in order, which gives what the sequential loop
gives, since a chunk's best t and first-best index do not depend on the
running best.

``render_tiles_bricks`` dispatches on the device of the camera: CUDA
tensors launch kernel B6 (``render_bricks_cuda``) and never fall back; CPU
tensors run its plain version.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..models.bricks import (BRICK_DATA_ROWS, BRICK_PRIMS, BRICK_ROWS,
                             NUM_SUBS, STACK_DEPTH, SUB_PRIMS, TRI_FLOATS,
                             BrickSet, WalkTable)
from . import cuda_build, rng
from . import geometry as g
from .camera import generate_primary_rays
from .integrator import MAX_DEPTH, RR_START_DEPTH, SECONDARY_TNEAR
from .megakernel import MEGAKERNEL_MAX_PRIMS
from .vec import Vec3, cross, where

INF = float("inf")
# rays per batch of leaf tests: [LEAF_CHUNK, 512] float temporaries (32 MiB)
LEAF_CHUNK = 16384
# B6's screen tile, the unit a tile range counts (JAX brickkernel.TILE)
TILE = (64, 32)

SOURCE = cuda_build.CSRC_DIR / "brick_render.cu"
BUILD_DIR = cuda_build.BUILD_DIR

_lib = None


def _brick_views(bricks: BrickSet):
    """Views (no copies) of the brick records: triangle p0/e1/e2 as
    [B, 512, 9] and the sub-AABB rows as [B, 16, 8]."""
    B = int(bricks.brick_data.shape[0])
    flat = bricks.brick_data.reshape(B, BRICK_ROWS * 128)
    recs = flat[:, :BRICK_DATA_ROWS * 128].view(B, BRICK_PRIMS, 32)
    sub = flat[:, BRICK_DATA_ROWS * 128:(BRICK_DATA_ROWS + 1) * 128]
    return recs[:, :, 1:10], sub.view(B, NUM_SUBS, 8)


def _leaf(tris, subs, brick, o: Vec3, d: Vec3, inv: Vec3, tnear: float,
          best_t, best_slot, best_uv=None):
    """Test rays against one brick each (``brick`` [m] i64).  Returns the
    updated (best_t, best_slot, best_uv) and the [m, 16] bool mask of the
    chunk gates each ray passed; ``best_uv``, a (u, v) pair or None,
    follows the winner."""
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
    t, u, v, hit = g.intersect_triangle(p0, e1, e2, oc, dc, tnear, INF)
    t = torch.where(hit, t, INF).view(m, NUM_SUBS, SUB_PRIMS)
    chunk_t = torch.amin(t, dim=-1)                      # [m, 16]
    chunk_k = torch.argmin(t, dim=-1)                    # first minimum
    if best_uv is not None:
        at_k = lambda a: torch.gather(a.view(m, NUM_SUBS, SUB_PRIMS), 2,
                                      chunk_k[..., None])[..., 0]
        chunk_u, chunk_v = at_k(u), at_k(v)
    chunk_k = chunk_k.to(torch.int32)

    base = brick.to(torch.int32) * BRICK_PRIMS
    gates = torch.zeros((m, NUM_SUBS), dtype=torch.bool, device=brick.device)
    for s in range(NUM_SUBS):
        gate = valid_s[:, s] & g.slab_hit(tn_s[:, s], tf_s[:, s], best_t)
        gates[:, s] = gate
        take = gate & (chunk_t[:, s] < best_t)
        best_t = torch.where(take, chunk_t[:, s], best_t)
        best_slot = torch.where(take, base + (s * SUB_PRIMS) + chunk_k[:, s],
                                best_slot)
        if best_uv is not None:
            best_uv = (torch.where(take, chunk_u[:, s], best_uv[0]),
                       torch.where(take, chunk_v[:, s], best_uv[1]))
    return best_t, best_slot, best_uv, gates


def _table_views(bricks: BrickSet, table: WalkTable):
    """What ``_walk`` reads, taken from the kernels' walk table instead of
    the set's own tensors: (tris [B, 512, 9], subs [B, 16, 8], boxes
    [Ntop, 6], brick [Ntop] i64, children(node, d) -> (left, right,
    left_first)), the children ordered by the stored centre sums."""
    B = int(bricks.brick_data.shape[0])
    tris = table.tris.view(B, NUM_SUBS, TRI_FLOATS, SUB_PRIMS).permute(
        0, 1, 3, 2).reshape(B, BRICK_PRIMS, TRI_FLOATS)
    nodes = table.nodes
    bits = nodes.view(torch.int32).to(torch.int64)

    def children(node, d: Vec3):
        rec = nodes[node]
        key = lambda j: (rec[:, j] * d.x + rec[:, j + 1] * d.y
                         + rec[:, j + 2] * d.z)
        return bits[node, 11], bits[node, 15], key(8) <= key(12)

    return tris, bricks.sub_boxes, nodes[:, :6], bits[:, 7], children


def _set_views(bricks: BrickSet):
    """The same five from the set's own tensors: the top tree's boxes and
    links and the brick records."""
    tris, subs = _brick_views(bricks)
    boxes = bricks.top_boxes.reshape(-1, 8)        # node n -> row n
    links = bricks.top_links.reshape(-1, 2).to(torch.int64)

    def children(node, d: Vec3):
        left = node + 1
        right = links[left, 0]

        def center_key(n):
            b = boxes[n]
            return ((b[:, 0] + b[:, 3]) * d.x + (b[:, 1] + b[:, 4]) * d.y
                    + (b[:, 2] + b[:, 5]) * d.z)

        return left, right, center_key(left) <= center_key(right)

    return tris, subs, boxes, links[:, 1], children


def _walk(bricks: BrickSet, o: Vec3, d: Vec3, tnear: float, best_t,
          full: bool, pipelined: bool = False, table: WalkTable = None):
    """The per-ray walk of every ray of [m] components ``o``, ``d``, below
    the start distances ``best_t``.  Returns (t, slot, uv, counts): the
    closest triangle's t where one is strictly nearer than ``best_t`` (else
    ``best_t``) and its slot (else -1); with ``full``, its (u, v) (else
    zeros), otherwise None; and the [3, m] int32 counts of nodes popped,
    bricks entered and chunk gates passed.

    ``table``, the set's ``WalkTable``, makes the walk read the top tree
    and the triangles from it, as the kernels do, instead of from the set's
    own tensors; the result is the same bit for bit.

    ``pipelined`` defers every leaf by one (kernel B4's walk): a leaf that
    is found becomes pending, and the pending leaf is tested only when the
    next leaf is found or the stack runs out, so the nodes between two
    leaves are classified against the best t from before the pending
    leaf's tests."""
    dev = o.x.device
    m = int(o.x.numel())
    out_t = best_t.clone()
    out_slot = torch.full((m,), -1, dtype=torch.int32, device=dev)
    out_uv = ((torch.zeros(m, device=dev), torch.zeros(m, device=dev))
              if full else None)
    out_counts = torch.zeros((3, m), dtype=torch.int32, device=dev)
    ids = torch.arange(m, device=dev)
    if m == 0:
        return out_t, out_slot, out_uv, out_counts

    tris, subs, boxes, node_brick, children = (
        _set_views(bricks) if table is None else _table_views(bricks, table))
    inv = Vec3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    best_slot = out_slot.clone()
    uv = (out_uv[0].clone(), out_uv[1].clone()) if full else None
    counts = out_counts.clone()
    stack = torch.zeros((m, bricks.top_depth + 2), dtype=torch.int64,
                        device=dev)
    sp = torch.ones(m, dtype=torch.int64, device=dev)
    # the pending leaf's brick (-1: none); stays -1 unless pipelined
    pend = torch.full((m,), -1, dtype=torch.int64, device=dev)

    while ids.numel():
        rows = torch.arange(ids.numel(), device=dev)
        # a ray whose stack is empty is still here only for its pending leaf
        have = sp > 0
        sp_in = sp
        sp = sp - have.to(torch.int64)
        node = stack[rows, sp]
        box = boxes[node]
        tn, tf = g.slab_interval(o, inv, Vec3(box[:, 0], box[:, 1], box[:, 2]),
                                 Vec3(box[:, 3], box[:, 4], box[:, 5]))
        hit = g.slab_hit(tn, tf, best_t) & have
        brick = node_brick[node]
        counts[0] += have

        found = hit & (brick >= 0)
        if pipelined:
            # (JAX make_brick_intersect_pipelined: do_drain)
            drain = (pend >= 0) & (found | (sp_in <= 1))
            drain_brick = pend
            pend = torch.where(found, brick,
                               torch.where(drain, -1, pend))
        else:
            drain, drain_brick = found, brick
        leaf = torch.nonzero(drain).reshape(-1)
        counts[1, leaf] += 1
        for c0 in range(0, int(leaf.numel()), LEAF_CHUNK):
            li = leaf[c0:c0 + LEAF_CHUNK]
            sel = lambda v, li=li: Vec3(v.x[li], v.y[li], v.z[li])
            bt, bs, buv, gates = _leaf(
                tris, subs, drain_brick[li], sel(o), sel(d), sel(inv), tnear,
                best_t[li], best_slot[li],
                (uv[0][li], uv[1][li]) if full else None)
            best_t[li] = bt
            best_slot[li] = bs
            if full:
                uv[0][li], uv[1][li] = buv
            counts[2, li] += gates.sum(dim=1, dtype=torch.int32)

        di = torch.nonzero(hit & (brick < 0)).reshape(-1)
        if di.numel():
            left, right, left_first = children(
                node[di], Vec3(d.x[di], d.y[di], d.z[di]))
            near = torch.where(left_first, left, right)
            far = torch.where(left_first, right, left)
            stack[di, sp[di]] = far
            stack[di, sp[di] + 1] = near      # popped first
            sp[di] += 2

        done = (sp == 0) & (pend < 0)
        if bool(done.any()):
            fin = ids[done]
            out_t[fin] = best_t[done]
            out_slot[fin] = best_slot[done]
            out_counts[:, fin] = counts[:, done]
            if full:
                out_uv[0][fin] = uv[0][done]
                out_uv[1][fin] = uv[1][done]
            keep = ~done
            ids, sp, stack, pend = ids[keep], sp[keep], stack[keep], pend[keep]
            best_t, best_slot = best_t[keep], best_slot[keep]
            counts = counts[:, keep]
            if full:
                uv = (uv[0][keep], uv[1][keep])
            o = Vec3(*(v[keep] for v in o))
            d = Vec3(*(v[keep] for v in d))
            inv = Vec3(*(v[keep] for v in inv))
    return out_t, out_slot, out_uv, out_counts


def _ray_ids(active, n: int, device):
    return (torch.arange(n, device=device) if active is None
            else torch.nonzero(active.reshape(-1)).reshape(-1))


def _trace_slim_plain(bricks: BrickSet, org: Vec3, dirn: Vec3, tnear: float,
                      active, collect_stats: bool, pipelined: bool,
                      table: WalkTable = None):
    shape = org.x.shape
    dev = org.x.device
    n = org.x.numel()
    out_t = torch.full((n,), INF, dtype=torch.float32, device=dev)
    out_slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    ids = _ray_ids(active, n, dev)
    o = Vec3(*(c.reshape(-1)[ids] for c in org))
    d = Vec3(*(c.reshape(-1)[ids] for c in dirn))
    start = torch.full((int(ids.numel()),), INF, dtype=torch.float32,
                       device=dev)
    t, slot, _, counts = _walk(bricks, o, d, tnear, start, full=False,
                               pipelined=pipelined, table=table)
    out_t[ids] = t
    out_slot[ids] = slot
    if not collect_stats:
        return out_t.reshape(shape), out_slot.reshape(shape)
    out_counts = torch.zeros((3, n), dtype=torch.int32, device=dev)
    out_counts[:, ids] = counts
    return (out_t.reshape(shape), out_slot.reshape(shape),
            out_counts.reshape((3,) + shape))


def trace_bricks_plain(bricks: BrickSet, org: Vec3, dirn: Vec3,
                       tnear: float, active=None,
                       collect_stats: bool = False, table: WalkTable = None):
    """Closest triangle hit of every ray over the brick set: (t f32, inf on
    a miss; slot i32, -1 on a miss), each of the rays' shape.  Rays where
    ``active`` is False are not traced.  Spheres are not tested.  With
    ``collect_stats`` also the int32 [3, *shape] per-ray counts of nodes
    popped, bricks entered and chunk gates passed.  With ``table`` the walk
    reads the set's ``WalkTable`` (``_walk``)."""
    return _trace_slim_plain(bricks, org, dirn, tnear, active, collect_stats,
                             pipelined=False, table=table)


def trace_bricks_pipelined_plain(bricks: BrickSet, org: Vec3, dirn: Vec3,
                                 tnear: float, active=None,
                                 collect_stats: bool = False,
                                 table: WalkTable = None):
    """Kernel B4's plain version: ``trace_bricks_plain``'s contract through
    the walk with the deferred leaf (``_walk(pipelined=True)``).  The best
    t the walk prunes with is one leaf stale, which only admits more nodes
    and leaves: with strict ``t < best`` and leaves tested in the walk's
    own order the winner is the same, so (t, slot) equal
    ``trace_bricks_plain``'s bit for bit, while the counters are at least
    its counters.  With ``table`` the walk reads the set's ``WalkTable``,
    as kernel B4 does (``_walk``)."""
    return _trace_slim_plain(bricks, org, dirn, tnear, active, collect_stats,
                             pipelined=True, table=table)


def slot_rows(bricks: BrickSet, slot) -> torch.Tensor:
    """The 32-float records [m, 32] of triangle slots [m] (-1 reads slot
    0)."""
    flat = bricks.brick_data.reshape(-1)
    s = torch.clamp_min(slot, 0).to(torch.int64)
    base = (s // BRICK_PRIMS) * (BRICK_ROWS * 128) + (s % BRICK_PRIMS) * 32
    return flat[base[:, None] + torch.arange(32, device=flat.device)]


def triangle_record(rows, u, v):
    """Channels 1..15 of the hit record of triangle records ``rows`` [m, 32]
    hit at barycentric (u, v): (ns, pos, mtype, albedo, mparam, emission,
    is_emitter), as ``_tri_record_body`` computes them."""
    gv = lambda j: Vec3(rows[:, j], rows[:, j + 1], rows[:, j + 2])
    p0, e1, e2 = gv(1), gv(4), gv(7)
    w = 1.0 - u - v
    pos = Vec3(p0.x + e1.x * u + e2.x * v,
               p0.y + e1.y * u + e2.y * v,
               p0.z + e1.z * u + e2.z * v)
    n0, n1, n2 = gv(10), gv(13), gv(16)
    ni = Vec3(n0.x * w + n1.x * u + n2.x * v,
              n0.y * w + n1.y * u + n2.y * v,
              n0.z * w + n1.z * u + n2.z * v)
    ns = where(rows[:, 28] > 0.5, ni, cross(e1, e2))
    return (ns, pos, rows[:, 19], gv(20), rows[:, 23], gv(24), rows[:, 27])


def trace_bricks_full_plain(bricks: BrickSet, org: Vec3, dirn: Vec3,
                            tnear: float, active=None,
                            collect_stats: bool = False,
                            table: WalkTable = None):
    """The 16-channel closest hit of every ray over the resident spheres and
    the bricks: a tuple (t, ns x/y/z, pos x/y/z, mtype, albedo r/g/b,
    mparam, emission r/g/b, is_emitter) of f32 tensors of the rays' shape;
    t is inf and the rest 0 on a miss.  Rays where ``active`` is False are
    not traced (a miss).  With ``collect_stats`` returns (record, counts),
    counts the int32 [3, *shape] nodes popped, bricks entered and chunk
    gates passed per ray (0 where not traced).  With ``table`` the walk
    reads the set's ``WalkTable`` (``_walk``)."""
    shape = org.x.shape
    dev = org.x.device
    n = org.x.numel()
    ids = _ray_ids(active, n, dev)
    m = int(ids.numel())
    o = Vec3(*(c.reshape(-1)[ids] for c in org))
    d = Vec3(*(c.reshape(-1)[ids] for c in dirn))

    # the resident spheres first, strict t < best: a sphere wins a tie
    best_t = torch.full((m,), INF, dtype=torch.float32, device=dev)
    sph_k = torch.full((m,), -1, dtype=torch.int64, device=dev)
    sph = bricks.sph_rows
    for j in range(bricks.num_spheres):
        c = Vec3(sph[j, 1], sph[j, 2], sph[j, 3])
        ts, hit = g.intersect_sphere(c, sph[j, 4], o, d, tnear, best_t)
        closer = hit & (ts < best_t)
        best_t = torch.where(closer, ts, best_t)
        sph_k = torch.where(closer, j, sph_k)

    t, slot, (u, v), counts = _walk(bricks, o, d, tnear, best_t, full=True,
                                    table=table)
    tri = slot >= 0
    on_sph = ~tri & (sph_k >= 0)
    ns, pos, mt, alb, mp, em, emit = triangle_record(slot_rows(bricks, slot),
                                                     u, v)
    srow = sph[torch.clamp_min(sph_k, 0)]
    spos = Vec3(o.x + d.x * t, o.y + d.y * t, o.z + d.z * t)
    sns = Vec3(spos.x - srow[:, 1], spos.y - srow[:, 2], spos.z - srow[:, 3])
    pick = lambda a, b: torch.where(tri, a, torch.where(on_sph, b, 0.0))
    record = (torch.where(tri | on_sph, t, INF),
              pick(ns.x, sns.x), pick(ns.y, sns.y), pick(ns.z, sns.z),
              pick(pos.x, spos.x), pick(pos.y, spos.y), pick(pos.z, spos.z),
              pick(mt, srow[:, 19]),
              pick(alb.x, srow[:, 20]), pick(alb.y, srow[:, 21]),
              pick(alb.z, srow[:, 22]), pick(mp, srow[:, 23]),
              pick(em.x, srow[:, 24]), pick(em.y, srow[:, 25]),
              pick(em.z, srow[:, 26]), pick(emit, srow[:, 27]))

    out = []
    for k, channel in enumerate(record):
        dense = torch.full((n,), INF if k == 0 else 0.0, dtype=torch.float32,
                           device=dev)
        dense[ids] = channel
        out.append(dense.reshape(shape))
    if not collect_stats:
        return tuple(out)
    out_counts = torch.zeros((3, n), dtype=torch.int32, device=dev)
    out_counts[:, ids] = counts
    return tuple(out), out_counts.reshape((3,) + shape)


# -- kernel B6: the persistent render over screen tiles -----------------------

def tile_grid(width: int, height: int, tile=TILE) -> int:
    """Number of screen tiles covering the image (JAX ops/megakernel.py)."""
    tw, th = tile
    return (-(-width // tw)) * (-(-height // th))


def tile_pixels(width: int, height: int, tile0: int, n_tiles: int,
                device="cpu") -> torch.Tensor:
    """Flat pixel indices (int64) of TILE screen tiles [tile0, tile0 +
    n_tiles), tiles in row-major order of the tile grid, pixels row-major
    inside a tile; off-image pixels of edge tiles are left out."""
    tw, th = TILE
    tiles_x = -(-width // tw)
    tile = torch.arange(tile0, tile0 + n_tiles, device=device)[:, None]
    k = torch.arange(tw * th, device=device)[None, :]
    ii = (tile % tiles_x) * tw + k % tw
    jj = (tile // tiles_x) * th + k // tw
    valid = (ii < width) & (jj < height)
    return (jj * width + ii)[valid]


def _check_tiles(width: int, height: int, tile0: int, n_tiles: int) -> None:
    total = tile_grid(width, height)
    if not (0 <= tile0 and n_tiles >= 0 and tile0 + n_tiles <= total):
        raise ValueError(f"tile range [{tile0}, {tile0 + n_tiles}) outside "
                         f"the {total} tiles of {width}x{height}")


def _path_sums(bricks: BrickSet, cam_data, pix, width: int, height: int,
               sample_start: int, n_pass: int, seed: int, max_depth: int,
               rr_start_depth: int):
    """Radiance sums [m, 3] of passes sample_start .. + n_pass of pixels
    ``pix`` [m]: the integrator's path loop over every pixel, each bounce
    the full-record walk and the wavefront's bounce."""
    # ops/wave_step.py imports this module for its record
    from .wave_step import _shade
    dev = cam_data.device
    m = int(pix.numel())
    i = (pix % width).to(torch.float32)
    j = (pix // width).to(torch.float32)
    bg = Vec3(bricks.bg_r, bricks.bg_g, bricks.bg_b)
    acc = torch.zeros((m, 3), dtype=torch.float32, device=dev)
    for k in range(n_pass):
        state = rng.seed_rays(pix, sample_start + k, seed)
        state, u1 = rng.next_uniform(state)
        state, u2 = rng.next_uniform(state)
        org, dirn = generate_primary_rays(cam_data, (i + u1) / width,
                                          (j + u2) / height)
        T = Vec3.full((m,), (1.0, 1.0, 1.0), device=dev)
        L = Vec3.zeros((m,), device=dev)
        active = torch.ones(m, dtype=torch.bool, device=dev)
        for depth in range(max_depth):
            if not bool(active.any()):
                break
            tnear = 0.0 if depth == 0 else SECONDARY_TNEAR
            rec = trace_bricks_full_plain(bricks, org, dirn, tnear, active)
            org, dirn, T, L_next, alive, state = _shade(
                rec, org, dirn, T, L, state, depth, bg, rr_start_depth,
                max_depth)
            # ended paths keep their radiance (their rays are not traced)
            L = where(active, L_next, L)
            active = active & alive
        acc = acc + L.to_array()
    return acc


def render_tiles_bricks_plain(bricks: BrickSet, cam_data: torch.Tensor,
                              width: int, height: int, tile0: int,
                              n_tiles: int, sample_start: int,
                              num_samples: int = 1, seed: int = 1984,
                              max_depth: int = MAX_DEPTH,
                              rr_start_depth: int = RR_START_DEPTH,
                              num_real=None) -> torch.Tensor:
    """Kernel B6's plain version: a fresh [H, W, 3] image holding, on the
    pixels of TILE screen tiles [tile0, tile0 + n_tiles), the radiance sum
    of the first ``num_real`` (None: all) of ``num_samples`` passes from
    ``sample_start``, and 0 elsewhere.  Runs on ``cam_data``'s device."""
    _check_tiles(width, height, tile0, n_tiles)
    dev = cam_data.device
    pix = tile_pixels(width, height, tile0, n_tiles, dev)
    n_pass = num_samples if num_real is None else min(num_real, num_samples)
    img = torch.zeros((width * height, 3), dtype=torch.float32, device=dev)
    img[pix] = _path_sums(bricks, cam_data, pix, width, height, sample_start,
                          n_pass, seed, max_depth, rr_start_depth)
    return img.reshape(height, width, 3)


def walk_pointers(bricks: BrickSet):
    """(nodes, tris, gates) device pointers of what the brick kernels' walk
    reads (csrc/brick_walk.cuh): the set's walk table, built on the first
    call and kept with the set, and its ``sub_boxes``.  Raises on a layout
    the kernels' 16-byte loads do not take."""
    table = bricks.walk_table()
    for name, t in (("walk table nodes", table.nodes),
                    ("walk table tris", table.tris),
                    ("sub_boxes", bricks.sub_boxes)):
        if (t.device != bricks.device or t.dtype != torch.float32
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"bricks {name}: need a contiguous, 16-byte "
                             f"aligned float32 tensor on {bricks.device}")
    if (int(table.nodes.shape[0]) != bricks.num_top
            or int(table.tris.shape[0]) != bricks.num_bricks * NUM_SUBS
            or tuple(bricks.sub_boxes.shape) != (bricks.num_bricks,
                                                 NUM_SUBS, 8)):
        raise ValueError("the walk table does not belong to this brick set")
    return (table.nodes.data_ptr(), table.tris.data_ptr(),
            bricks.sub_boxes.data_ptr())


def build() -> Path:
    """Compile csrc/brick_render.cu into a shared library under BUILD_DIR
    unless it is there; returns its path.  Raises if nvcc is missing or the
    build fails."""
    return cuda_build.build(SOURCE, BUILD_DIR)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(SOURCE, BUILD_DIR)
        fn = lib.pt_brick_render_launch
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, i32,                  # sph_rows, S
                       ptr, ptr, ptr, ptr,        # nodes, tris, gates, bricks
                       ptr, ptr, ptr,             # cam, bg, out
                       i32, i32, i32, i32,        # width, height, tile0, n
                       ctypes.c_uint, i32, i32,   # sample_start, n, n_real
                       ctypes.c_uint, i32, i32,   # seed, max_depth, rr_start
                       ptr]                       # stream
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def render_bricks_cuda(bricks: BrickSet, cam: torch.Tensor, bg: torch.Tensor,
                       width: int, height: int, tile0: int, n_tiles: int,
                       sample_start: int, num_samples: int, num_real: int,
                       seed: int, max_depth: int,
                       rr_start_depth: int) -> torch.Tensor:
    """Launch kernel B6 on the current stream: ``bricks`` on a card, ``cam``
    [12] and ``bg`` [3] float32 on it.  Returns a FRESH [H, W, 3] image
    holding, on the pixels of tiles [tile0, tile0 + n_tiles), the radiance
    sum of the first ``num_real`` (-1: all) of ``num_samples`` passes from
    ``sample_start``, and 0 elsewhere.  Adds one to
    ``render_bricks_cuda.launches`` per launch."""
    device = cam.device
    if device.type != "cuda":
        raise ValueError(f"render_bricks_cuda needs CUDA tensors, got "
                         f"{device}")
    for name, t, dtype in (("cam", cam, torch.float32),
                           ("bg", bg, torch.float32),
                           ("bricks.sph_rows", bricks.sph_rows, torch.float32),
                           ("bricks.brick_data", bricks.brick_data,
                            torch.float32)):
        if t.device != device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dtype} tensor on "
                             f"{device}, got {t.dtype} on {t.device}")
    if cam.numel() != 12 or bg.numel() != 3:
        raise ValueError("cam must hold 12 floats and bg 3")
    if tuple(bricks.brick_data.shape[1:]) != (BRICK_ROWS, 128):
        raise ValueError("bricks.brick_data: need [B, 136, 128]")
    if bricks.top_depth + 2 > STACK_DEPTH:
        raise ValueError(f"top tree of depth {bricks.top_depth} is too deep "
                         f"for the kernel's stack of {STACK_DEPTH} slots")
    if bricks.num_spheres > MEGAKERNEL_MAX_PRIMS:
        raise ValueError(f"{bricks.num_spheres} spheres exceed the "
                         f"kernel's resident table of {MEGAKERNEL_MAX_PRIMS}")
    if max_depth < 1 or num_samples < 0:
        raise ValueError("need max_depth >= 1 and num_samples >= 0")
    _check_tiles(width, height, tile0, n_tiles)

    lib = load_library()
    nodes, tris, gates = walk_pointers(bricks)
    out = torch.zeros((height, width, 3), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.pt_brick_render_launch(
            bricks.sph_rows.data_ptr(), bricks.num_spheres, nodes, tris,
            gates, bricks.brick_data.data_ptr(), cam.data_ptr(), bg.data_ptr(),
            out.data_ptr(), width, height, tile0, n_tiles,
            sample_start & 0xFFFFFFFF, num_samples, num_real,
            seed & 0xFFFFFFFF, max_depth, rr_start_depth, stream)
    if err != 0:
        raise RuntimeError(f"brick_render launch failed: CUDA error {err}")
    render_bricks_cuda.launches += 1
    return out


render_bricks_cuda.launches = 0


def render_tiles_bricks(bricks: BrickSet, cam_data: torch.Tensor, width: int,
                        height: int, tile0: int, n_tiles: int,
                        sample_start: int, num_samples: int = 1,
                        seed: int = 1984, max_depth: int = MAX_DEPTH,
                        rr_start_depth: int = RR_START_DEPTH,
                        num_real=None) -> torch.Tensor:
    """Radiance sums of the pixels of TILE screen tiles [tile0, tile0 +
    n_tiles) over the first ``num_real`` (None: all) of ``num_samples``
    passes, in a fresh [H, W, 3] image that is 0 elsewhere — the unit a
    tile and sample split across devices partitions (the JAX package's
    render_blocks_bricks).  CUDA tensors launch kernel B6; CPU tensors run
    its plain version."""
    device = cam_data.device
    if bricks.device != device:
        raise ValueError(f"bricks on {bricks.device}, camera on {device}")
    if device.type == "cpu":
        return render_tiles_bricks_plain(bricks, cam_data, width, height,
                                         tile0, n_tiles, sample_start,
                                         num_samples, seed, max_depth,
                                         rr_start_depth, num_real)
    if device.type != "cuda":
        raise ValueError(f"no brick render for device {device}")
    bg = torch.stack([bricks.bg_r, bricks.bg_g, bricks.bg_b])
    return render_bricks_cuda(
        bricks, cam_data.reshape(12).contiguous(), bg, width, height, tile0,
        n_tiles, sample_start, num_samples,
        -1 if num_real is None else num_real, seed, max_depth,
        rr_start_depth)


def render_samples_bricks(brickset: BrickSet, cam_data: torch.Tensor,
                          width: int, height: int, sample_start: int,
                          num_samples: int = 1, seed: int = 1984,
                          max_depth: int = MAX_DEPTH,
                          rr_start_depth: int = RR_START_DEPTH
                          ) -> torch.Tensor:
    """Large-scene drop-in for ops.integrator.render_samples: the radiance
    SUM of ``num_samples`` passes, [H, W, 3], one launch of kernel B6 on a
    card.  There is no NEE (B6 has no NEE hook; the renderer sends NEE to
    the wavefront)."""
    return render_tiles_bricks(brickset, cam_data, width, height, 0,
                               tile_grid(width, height), sample_start,
                               num_samples, seed, max_depth, rr_start_depth)
