"""Pair-list brick tracer: traversal decisions in torch ops, the
intersection work in one kernel launch per wave.

The port of ``pathtracer_cuda_interactive_tpu/ops/pairtrace.py``, the
wavefront's opt-in engine ``trace="pairs[N]"``.  The closest-hit query of a
wave is split in two:

1. torch ops compute each packet's brick visit list.  A packet is
   ``packet_rows * 128`` consecutive rays of the wave.  ``_interval_cull``
   bounds, by interval arithmetic over the packet's origin box and direction
   bounds, the entry distance of any of its rays into every brick's box at
   once ([P, B] elementwise, no tree); ``_pack_pairs`` orders each packet's
   surviving bricks near first.
2. kernel B5 (csrc/pair_trace.cu, ``trace_pairs_cuda``) runs each packet's
   list in order, a warp of 32 rays at a time: a ray takes a brick whose
   entry bound lies below its best t, the brick's 16 chunk gates against
   its own best t, and behind each passing gate 32 triangle tests with a
   strict ``t < best``.  A warp stops at the first bound none of its rays
   is beyond, and a visit ends at the brick's own box when none of its rays
   meets that (``BrickSet.visit_boxes``).  No stack, no tree.

Results are the ``(t, slot)`` contract of ``wavefront.trace_wave_slim``: the
same t on every ray (a packet's list is a conservative superset of the
bricks the ray's own walk enters), and the same slot except where two
triangles tie at an equal t, which the visit order decides.  Spheres are
left to the caller's epilogue.

What differs from the JAX package.  Its waves are fixed [rows, 128] tables
with an active mask; the port's waves are compacted, [N] with any N, so a
packet is a run of consecutive rays and the last one may be partial (masked
in the cull's min/max).  Its kernel runs one grid step per pair in sequence,
in launches of ``PAIR_CAP`` = 4096 pairs inside a while loop; CUDA blocks
run at once, so B5 is one launch per wave in which each warp walks its
packet's whole list, and ``PAIR_CAP`` has no counterpart.  The pair list is
kept as the [P, B] matrix with each row sorted (``_pack_pairs``), not
flattened, so nothing about it has to be read back by the host.

``trace_wave_pairs`` dispatches on the device of the rays: CUDA tensors
launch the kernel and never fall back; CPU tensors run its plain version
``trace_pairs_plain``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..models.bricks import NUM_SUBS, BrickSet
from . import cuda_build
from . import geometry as g
from .brickkernel import LEAF_CHUNK, _brick_views, _leaf, walk_pointers
from .vec import Vec3

INF = float("inf")
LANES = 128
# Rays per packet: PACKET_ROWS x 128 rays share one visit list.  A smaller
# packet culls tighter (fewer bricks per packet), a larger one amortizes
# the cull and sort over more rays.
PACKET_ROWS = 32
# Rays that walk a list together in kernel B5: one warp.  The walk's
# counters are per warp, and its plain version counts the same way.
PAIR_GROUP = 32

SOURCE = cuda_build.CSRC_DIR / "pair_trace.cu"
BUILD_DIR = cuda_build.BUILD_DIR

_lib = None


# -- stage 1 (torch ops): the packets' visit lists ------------------------------

def _minmax_masked(a, active, lo_fill=INF, hi_fill=-INF):
    lo = torch.amin(torch.where(active, a, lo_fill), dim=1)
    hi = torch.amax(torch.where(active, a, hi_fill), dim=1)
    return lo, hi


def _interval_cull(org: Vec3, dirn: Vec3, active, brick_lo, brick_hi,
                   tnear: float):
    """Conservative entry-distance lower bounds [M, B]; inf = certainly no
    ray of packet m hits brick b.  Packets are the rows of the [M, K] ray
    components (K = rays per packet); ``active`` [M, K] masks padding.
    Interval arithmetic over the packet's origin box and direction bounds;
    axes whose direction interval spans zero contribute no constraint.
    ``torch.minimum`` / ``torch.maximum`` propagate NaN as jnp's do, so a
    0 * inf in the plane times drops the pair on both sides."""
    LB = None
    UB = None
    pk_live = active.any(dim=1)
    for o, d, ax in ((org.x, dirn.x, 0), (org.y, dirn.y, 1),
                     (org.z, dirn.z, 2)):
        olo, ohi = _minmax_masked(o, active)
        dlo, dhi = _minmax_masked(d, active)
        olo, ohi = olo[:, None], ohi[:, None]          # [M, 1]
        definite = dlo * dhi > 0.0
        same = definite[:, None]
        # 1/d is monotone on a sign-definite interval: r in [1/dhi, 1/dlo]
        rlo = (1.0 / torch.where(definite, dhi, 1.0))[:, None]
        rhi = (1.0 / torch.where(definite, dlo, 1.0))[:, None]
        blo = brick_lo[None, :, ax]                    # [1, B]
        bhi = brick_hi[None, :, ax]

        def pint(nlo, nhi):
            p0, p1, p2, p3 = nlo * rlo, nlo * rhi, nhi * rlo, nhi * rhi
            return (torch.minimum(torch.minimum(p0, p1),
                                  torch.minimum(p2, p3)),
                    torch.maximum(torch.maximum(p0, p1),
                                  torch.maximum(p2, p3)))

        l0, h0 = pint(blo - ohi, blo - olo)            # near-plane times
        l1, h1 = pint(bhi - ohi, bhi - olo)            # far-plane times
        axlo = torch.minimum(l0, l1)    # <= every ray's slab entry
        axhi = torch.maximum(h0, h1)    # >= every ray's slab exit
        axlo = torch.where(same, axlo, -INF)
        axhi = torch.where(same, axhi, INF)
        LB = axlo if LB is None else torch.maximum(LB, axlo)
        UB = axhi if UB is None else torch.minimum(UB, axhi)
    ok = ((torch.clamp_min(LB, tnear) <= UB) & (UB >= 0.0)
          & pk_live[:, None])
    return torch.where(ok, torch.clamp_min(LB, 0.0), INF)


def _pack_pairs(lb):
    """Order the [P, B] entry-bound matrix into each packet's near-first
    visit list.  Returns (brk [P, B] i32, ent [P, B] f32, cnt [P] i32):
    the first cnt[p] entries of row p are packet p's bricks by ascending
    entry bound (equal bounds keep ascending brick order: the sort is
    stable) and their bounds; the rest of the row is padding (inf).  The
    rows' valid prefixes, one after the other, are the JAX package's flat
    packet-major pair list."""
    ent, brk = torch.sort(lb, dim=1, stable=True)
    cnt = torch.isfinite(ent).sum(dim=1, dtype=torch.int32)
    return brk.to(torch.int32).contiguous(), ent.contiguous(), cnt


def visit_lists(bricks: BrickSet, org: Vec3, dirn: Vec3, tnear: float,
                packet_rows: int = PACKET_ROWS):
    """(brk, ent, cnt) of ``_pack_pairs`` for one wave of rays ([N]
    components, N > 0) in packets of ``packet_rows * 128`` consecutive rays;
    the last packet may be partial."""
    n = int(org.x.numel())
    packet_rays = packet_rows * LANES
    P = -(-n // packet_rays)
    pad = P * packet_rays - n
    rp = lambda a: torch.nn.functional.pad(a, (0, pad)).view(P, packet_rays)
    active = rp(torch.ones(n, dtype=torch.bool, device=org.x.device))
    lb = _interval_cull(Vec3(*(rp(c) for c in org)),
                        Vec3(*(rp(c) for c in dirn)), active,
                        bricks.brick_lo, bricks.brick_hi, tnear)
    return _pack_pairs(lb)


# -- stage 2: kernel B5 and its plain version --------------------------------

def trace_pairs_plain(bricks: BrickSet, org: Vec3, dirn: Vec3, tnear: float,
                      brk, ent, cnt, packet_rays: int,
                      collect_stats: bool = False, early_votes: bool = False):
    """Kernel B5's plain version: (t f32 [N], slot i32 [N]) of the rays
    ([N] components) over their packets' visit lists (``_pack_pairs``; ray i
    is in packet i // packet_rays).  Step r handles the r-th pair of every
    packet that has one, for the rays whose best t lies beyond the pair's
    entry bound and that pass one of the brick's chunk gates (in batches of
    ``LEAF_CHUNK`` rays, as the plain walk); the leaf test is the walk's
    (``brickkernel._leaf``: gates against the current best t in order,
    first triangle with the smallest t, strict ``t < best``), which is the
    kernel's arithmetic in the kernel's order.  Every decision is the ray's
    own, so the result does not depend on how the kernel groups rays.

    With ``collect_stats`` also an int64 tensor of the kernel's counters,
    per warp (``PAIR_GROUP`` consecutive rays of a packet) that holds a
    ray, summed: pairs listed, pairs skipped by the entry bound (a warp
    stops at the first pair none of its rays takes: bounds ascend and best
    t only falls, so none takes a later one either) and chunks tested (a
    chunk whose gate some ray of the warp passes).
    ``early_votes`` takes the kernel's vote on the brick's own box
    (``BrickSet.visit_boxes``, ``geometry.slab_maybe`` at the ray's best
    t): a ray that fails it passes no gate of the brick, so (t, slot) and
    the three counters stay the same, and a fourth counts the visits that
    ended there, no ray of the warp passing."""
    dev = org.x.device
    n = int(org.x.numel())
    best_t = torch.full((n,), INF, dtype=torch.float32, device=dev)
    best_slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    ray = torch.arange(n, device=dev)
    packet = ray // packet_rays
    per_packet = -(-packet_rays // PAIR_GROUP)
    grp = packet * per_packet + (ray % packet_rays) // PAIR_GROUP
    num_groups = int(cnt.numel()) * per_packet
    listed = cnt.to(torch.int64).repeat_interleave(per_packet)
    has_ray = torch.bincount(grp, minlength=num_groups) > 0
    visited = torch.zeros(num_groups, dtype=torch.int64, device=dev)
    tested = boxed_out = 0
    tris, subs = _brick_views(bricks)
    boxes = bricks.visit_boxes() if early_votes else None
    inv = Vec3(1.0 / dirn.x, 1.0 / dirn.y, 1.0 / dirn.z)
    pairs = cnt.to(torch.int64)[packet]
    col = lambda v: v[:, None]
    sel = lambda v, i: Vec3(v.x[i], v.y[i], v.z[i])
    flag = lambda i: torch.zeros(num_groups, dtype=torch.bool,
                                 device=dev).index_fill_(0, grp[i], True)
    for r in range(int(cnt.max()) if n else 0):
        brick = brk[packet, r].to(torch.int64)
        idx = torch.nonzero((pairs > r)
                            & (best_t > ent[packet, r])).reshape(-1)
        going = flag(idx)
        visited += going
        if early_votes:
            box = boxes[brick[idx]]
            tn, tf = g.slab_interval(sel(org, idx), sel(inv, idx),
                                     Vec3(box[:, 0], box[:, 1], box[:, 2]),
                                     Vec3(box[:, 3], box[:, 4], box[:, 5]))
            idx = idx[g.slab_maybe(tn, tf, best_t[idx])]
            boxed_out += int((going & ~flag(idx)).sum())
        # only the rays that pass a gate at their best t on entry can take
        # a hit from the brick
        sb = subs[brick[idx]]
        tn, tf = g.slab_interval(
            Vec3(*(col(c[idx]) for c in org)),
            Vec3(*(col(c[idx]) for c in inv)),
            Vec3(sb[..., 0], sb[..., 1], sb[..., 2]),
            Vec3(sb[..., 3], sb[..., 4], sb[..., 5]))
        gate = (sb[..., 6] > 0.0) & g.slab_hit(tn, tf, col(best_t[idx]))
        idx = idx[gate.any(dim=1)]
        held = []
        for c0 in range(0, int(idx.numel()), LEAF_CHUNK):
            li = idx[c0:c0 + LEAF_CHUNK]
            bt, bs, _, passed = _leaf(tris, subs, brick[li], sel(org, li),
                                      sel(dirn, li), sel(inv, li), tnear,
                                      best_t[li], best_slot[li])
            best_t[li] = bt
            best_slot[li] = bs
            if collect_stats:
                chunk = col(grp[li]) * NUM_SUBS + torch.arange(NUM_SUBS,
                                                               device=dev)
                held.append(chunk[passed])
        if held:
            tested += int(torch.unique(torch.cat(held)).numel())
    if not collect_stats:
        return best_t, best_slot
    seen = int(listed[has_ray].sum())
    counters = [seen, seen - int(visited.sum()), tested]
    return best_t, best_slot, torch.tensor(
        counters + [boxed_out] * early_votes, dtype=torch.int64, device=dev)


def build() -> Path:
    """Compile csrc/pair_trace.cu (kernel B5) into a shared library under
    BUILD_DIR unless it is there; returns its path.  Raises if nvcc is
    missing or the build fails."""
    return cuda_build.build(SOURCE, BUILD_DIR)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(SOURCE, BUILD_DIR)
        fn = lib.pt_pair_trace_launch
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,   # ox oy oz dx dy dz
                       i32, ctypes.c_float,            # n, tnear
                       i32, i32,                       # packet_rays, P
                       ptr, ptr, ptr, i32,             # brk, ent, cnt, B
                       ptr, ptr, ptr,                  # visit boxes, tris, gates
                       ptr, ptr,                       # out_t, out_slot
                       ptr, ptr]                       # stats, stream
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def trace_pairs_cuda(bricks: BrickSet, ox: torch.Tensor, oy: torch.Tensor,
                     oz: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
                     dz: torch.Tensor, tnear: float, brk: torch.Tensor,
                     ent: torch.Tensor, cnt: torch.Tensor, packet_rays: int,
                     collect_stats: bool = False):
    """Launch kernel B5 on the current stream: the closest triangle of each
    of the N rays (contiguous float32 [N] CUDA tensors) over its packet's
    visit list (``_pack_pairs``; ray i is in packet i // packet_rays, a
    multiple of 32).  Returns fresh (t [N] f32, inf on a miss; slot [N]
    i32, -1 on a miss), and with ``collect_stats`` also an int64 [4] tensor
    of pairs listed, pairs skipped by the entry bound, chunks tested and
    visits that ended at the brick's own box, summed over the warps (the
    counters of ``trace_pairs_plain`` with ``early_votes``).  Adds one to
    ``trace_pairs_cuda.launches`` per launch; an empty wave launches
    nothing."""
    device = ox.device
    if device.type != "cuda":
        raise ValueError(f"trace_pairs_cuda needs CUDA tensors, got {device}")
    if bricks.device != device:
        raise ValueError(f"bricks on {bricks.device}, rays on {device}")
    n = int(ox.numel())
    B = bricks.num_bricks
    if packet_rays < 1 or packet_rays % PAIR_GROUP:
        raise ValueError(f"need packet_rays a positive multiple of "
                         f"{PAIR_GROUP}, got {packet_rays}")
    P = -(-n // packet_rays)
    checks = [(label, t, torch.float32, (n,))
              for label, t in zip(("ox", "oy", "oz", "dx", "dy", "dz"),
                                  (ox, oy, oz, dx, dy, dz))]
    checks += [("brk", brk, torch.int32, (P, B)),
               ("ent", ent, torch.float32, (P, B)),
               ("cnt", cnt, torch.int32, (P,)),
               ("visit boxes", bricks.visit_boxes(), torch.float32, (B, 8))]
    for label, t, dtype, shape in checks:
        if (t.device != device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{label}: need a contiguous {dtype} "
                             f"{list(shape)} tensor on {device}, got "
                             f"{t.dtype} {list(t.shape)} on {t.device}")
    out_t = torch.empty(n, dtype=torch.float32, device=device)
    out_slot = torch.empty(n, dtype=torch.int32, device=device)
    stats = (torch.zeros(4, dtype=torch.int64, device=device)
             if collect_stats else None)
    if n:
        lib = load_library()
        _, tris, gates = walk_pointers(bricks)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.pt_pair_trace_launch(
                ox.data_ptr(), oy.data_ptr(), oz.data_ptr(), dx.data_ptr(),
                dy.data_ptr(), dz.data_ptr(), n, float(tnear), packet_rays,
                P, brk.data_ptr(), ent.data_ptr(), cnt.data_ptr(), B,
                bricks.visit_boxes().data_ptr(), tris, gates,
                out_t.data_ptr(), out_slot.data_ptr(),
                stats.data_ptr() if collect_stats else None, stream)
        if err != 0:
            raise RuntimeError(f"pair_trace launch failed: CUDA error {err}")
        trace_pairs_cuda.launches += 1
    return (out_t, out_slot, stats) if collect_stats else (out_t, out_slot)


trace_pairs_cuda.launches = 0


def trace_wave_pairs(bricks: BrickSet, org: Vec3, dirn: Vec3, tnear: float,
                     packet_rows: int = PACKET_ROWS):
    """(t, slot) closest triangle hit of one wave of rays ([N] components)
    through the packets' visit lists: drop-in for
    ``wavefront.trace_wave_slim``.  CUDA tensors launch kernel B5; CPU
    tensors run its plain version."""
    device = org.x.device
    if bricks.device != device:
        raise ValueError(f"bricks on {bricks.device}, rays on {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no pair trace for device {device}")
    if packet_rows < 1:
        raise ValueError("need packet_rows >= 1")
    if org.x.numel() == 0:
        return (torch.empty(0, dtype=torch.float32, device=device),
                torch.empty(0, dtype=torch.int32, device=device))
    brk, ent, cnt = visit_lists(bricks, org, dirn, tnear, packet_rows)
    if device.type == "cpu":
        return trace_pairs_plain(bricks, org, dirn, tnear, brk, ent, cnt,
                                 packet_rows * LANES)
    return trace_pairs_cuda(bricks, *org, *dirn, tnear, brk, ent, cnt,
                            packet_rows * LANES)
