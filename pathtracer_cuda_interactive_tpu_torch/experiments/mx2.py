"""The "mx2" large-scene path: the superbrick packet tracer, kernel B7.

The port of ``pathtracer_cuda_interactive_tpu/experiments/mx2.py``.  A
packet is 128 consecutive rays of a wave.  Per wave:

1. torch ops compute each packet's superbrick visit list: the interval cull
   of every packet against every superbrick box and a stable near-first
   sort (ops/pairtrace.py::visit_lists, packets of one row).
2. kernel B7 (csrc/mx2_trace.cu, ``trace_mx2_cuda``) walks each packet's
   list in order.  Per superbrick it tests each of the 16 sub-bricks' boxes
   against every ray (a slab test against the ray's best t), and for a sub
   that any ray of the packet may hit it intersects all 128 rays with the
   sub's 32 triangles by the product of the sub's coefficients
   (mx2set.py) with the rays' features [o - shift, d, (o - shift) x d, 1],
   computed in the kernel's body in float32; a sign-corrected validity test
   and a min over the triangles update each ray's (t, slot).  The walk ends
   when no ray's best t lies beyond the next superbrick's entry bound.
3. the record: one gather of the winning slot's 32-float row, (u, v) by one
   Moller-Trumbore solve, the resident spheres folded in with a strict
   ``ts < t`` (ops/wave_step.py::_record_from_rows), which is the
   wavefront's record; the wave loop is the wavefront's (``render_waves``).

What differs from the JAX package.  Its waves are fixed [M, 128] tables
with an active mask, ``M % 8 == 0`` and lists padded to a multiple of 128
bricks (shapes of the TPU's tiles and scalar memory); the port's waves are
compacted, [N] with any N, the last packet may be partial, and a list's
length is passed per packet (``cnt``), as for kernel B5.  The TPU kernel
decides to fetch visit r + 1 from the best t before visit r, so that no
copy is left in flight; B7 and its plain version decide with the best t
after visit r.  They visit no more superbricks, and a visit that the later
test skips could not have changed (t, slot).

``trace_wave_mx2`` dispatches on the device of the rays: CUDA tensors
launch the kernel and never fall back; CPU tensors run its plain version
``trace_mx2_plain``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..ops import cuda_build
from ..ops.integrator import MAX_DEPTH, RR_START_DEPTH
from ..ops.pairtrace import LANES, visit_lists
from ..ops.vec import Vec3
from ..ops.wave_step import _record_from_rows, _solve_uv
from ..ops.wavefront import MAX_RAYS_PER_WAVE, render_waves
from .mx2set import MX2Set, NUM_SUBS, SB_PRIMS, SLAB_ROWS, SUB_PRIMS

INF = float("inf")
PACKET = LANES           # rays per packet: one block of kernel B7
FEATURES = 10            # the rows of a sub's 16 that carry coefficients

SOURCE = cuda_build.CSRC_DIR / "mx2_trace.cu"
BUILD_DIR = cuda_build.BUILD_DIR

_lib = None


# -- kernel B7's plain version ---------------------------------------------------

def _ray_features(mx: MX2Set, org: Vec3, dirn: Vec3):
    """The ten Plucker features of each ray about the set's shift, in the
    kernel's order: [o - shift, d, (o - shift) x d, 1]."""
    osx = org.x - mx.shift[0]
    osy = org.y - mx.shift[1]
    osz = org.z - mx.shift[2]
    return (osx, osy, osz, dirn.x, dirn.y, dirn.z,
            osy * dirn.z - osz * dirn.y,
            osz * dirn.x - osx * dirn.z,
            osx * dirn.y - osy * dirn.x,
            torch.ones_like(org.x))


def _slab_interval(box, po: Vec3, pinv: Vec3):
    """(tn, tf) of ops/geometry.py::slab_interval for boxes [m, >= 6] (min
    xyz, max xyz) against rays [m, 128]; NaN propagates."""
    col = lambda f: box[:, f:f + 1]
    tx0 = (col(0) - po.x) * pinv.x
    tx1 = (col(3) - po.x) * pinv.x
    ty0 = (col(1) - po.y) * pinv.y
    ty1 = (col(4) - po.y) * pinv.y
    tz0 = (col(2) - po.z) * pinv.z
    tz1 = (col(5) - po.z) * pinv.z
    tn = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                     torch.minimum(ty0, ty1)),
                       torch.minimum(tz0, tz1))
    tf = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                     torch.maximum(ty0, ty1)),
                       torch.maximum(tz0, tz1))
    return tn, tf


def box_hit(box, po: Vec3, pinv: Vec3, t_max):
    """The exact slab test of a sub's box: the ray meets it at or after 0 and
    no later than ``t_max``; a NaN (0 * inf on a box plane) is a miss."""
    tn, tf = _slab_interval(box, po, pinv)
    return (tf >= torch.maximum(tn, torch.zeros_like(tn))) & (tn <= t_max)


def box_maybe(box, po: Vec3, pinv: Vec3, t_max):
    """The same test with a NaN counted as a hit: what kernel B7 asks of a
    superbrick's own box before its 16 subs.  For a box that contains other
    boxes it is true wherever ``box_hit`` is true for one of them."""
    tn, tf = _slab_interval(box, po, pinv)
    return ~(tf < torch.maximum(tn, torch.zeros_like(tn))) & ~(tn > t_max)


def trace_mx2_plain(mx: MX2Set, org: Vec3, dirn: Vec3, tnear: float,
                    brk, ent, cnt, collect_stats: bool = False,
                    early_votes: bool = False):
    """Kernel B7's plain version: (t f32 [N], slot i32 [N]) of the rays ([N]
    components; ray i is in packet i // 128) over their packets' visit lists
    (``visit_lists``: brk, ent [P, B], cnt [P]), vectorised over packets.

    Step r handles the r-th superbrick of every packet that has one and in
    which some ray's best t lies beyond its entry bound; a packet that
    fails this once is done (bounds ascend, best t only falls).  Within a
    step the 16 subs go in order: the packet votes a sub in when its valid
    flag is set and some ray's slab test against its box passes at the
    ray's current best t (NaN is a miss), and then ALL rays of the packet
    take the sub's product: for each of the 128 rows (det | u*det | v*det |
    t*det of 32 triangles) the sum over the ten features k = 0..9, in that
    order, of coefficient times feature, which is the kernel's sum.  The
    lowest triangle among equal minima wins inside a sub; across subs and
    superbricks a strict ``t < best``.  With ``collect_stats`` also an
    int64 [4] tensor: superbricks listed, visited, subs voted in, and subs
    slab-tested (the valid subs of the superbricks visited), summed over
    packets.

    ``early_votes`` switches on the two votes the kernel takes in front of
    the exact ones, which can only say no: a visit ends at once when no ray
    passes ``box_maybe`` on the superbrick's own box (``MX2Set.visit_boxes``)
    at its best t, and otherwise a sub gets its exact vote only if some ray
    passed its box at the best t on entry to the visit.  (t, slot) and the
    four counters are the same either way; the counters then carry a fifth,
    the visits that ended at the superbrick's box."""
    dev = org.x.device
    n = int(org.x.numel())
    P = int(cnt.numel())
    pad = P * PACKET - n
    rp = lambda a, fill=0.0: torch.nn.functional.pad(
        a, (0, pad), value=fill).view(P, PACKET)
    live = rp(torch.ones(n, dtype=torch.bool, device=dev), False)
    o = Vec3(*(rp(c) for c in org))
    # a padding ray has direction 1 (a finite reciprocal), as in the kernel
    d = Vec3(*(rp(c, 1.0) for c in dirn))
    inv = Vec3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    feats = torch.stack(_ray_features(mx, o, d), dim=1)       # [P, 10, 128]
    best_t = torch.full((P, PACKET), INF, dtype=torch.float32, device=dev)
    best_slot = torch.full((P, PACKET), -1, dtype=torch.int32, device=dev)
    subbox = mx.subbox.view(-1, NUM_SUBS, 8)
    coeff = mx.coeff.view(-1, NUM_SUBS, 16, 4, SUB_PRIMS)
    tri = torch.arange(SUB_PRIMS, dtype=torch.int32, device=dev)
    visit_boxes = mx.visit_boxes() if early_votes else None
    visited = voted = tested = boxed_out = 0
    going = cnt > 0
    for r in range(int(cnt.max()) if P else 0):
        # past a packet's list the bound is inf, which no best t exceeds
        going = going & (live & (best_t > ent[:, r:r + 1])).any(dim=1)
        pk = torch.nonzero(going).reshape(-1)
        if pk.numel() == 0:
            break
        visited += int(pk.numel())
        brick = brk[pk, r].to(torch.int64)
        tested += int((subbox[brick, :, 6] > 0.0).sum())
        if early_votes:
            keep = (box_maybe(visit_boxes[brick], Vec3(*(c[pk] for c in o)),
                              Vec3(*(c[pk] for c in inv)), best_t[pk])
                    & live[pk]).any(dim=1)
            boxed_out += int((~keep).sum())
            pk, brick = pk[keep], brick[keep]
            if pk.numel() == 0:
                continue
        po = Vec3(*(c[pk] for c in o))
        pinv = Vec3(*(c[pk] for c in inv))
        plive = live[pk]
        bt, bs = best_t[pk], best_slot[pk]
        if early_votes:
            on_entry = torch.stack(
                [(box_hit(subbox[brick, s], po, pinv, bt) & plive).any(dim=1)
                 for s in range(NUM_SUBS)], dim=1)
        for s in range(NUM_SUBS):
            box = subbox[brick, s]                            # [m, 8]
            hitm = box_hit(box, po, pinv, bt) & plive
            vote = hitm.any(dim=1) & (box[:, 6] > 0.0)
            if early_votes:
                vote = vote & on_entry[:, s]
            vi = torch.nonzero(vote).reshape(-1)
            if vi.numel() == 0:
                continue
            voted += int(vi.numel())
            C = coeff[brick[vi], s]                    # [v, 16, 4, 32]
            F = feats[pk[vi]]                          # [v, 10, 128]
            # out[v, q, j, ray]: the ordered sum over the ten features
            out = C[:, 0, :, :, None] * F[:, 0, None, None, :]
            for k in range(1, FEATURES):
                out = out + C[:, k, :, :, None] * F[:, k, None, None, :]
            det, U, V, Tt = out.unbind(1)              # [v, 32, 128]
            sg = torch.sign(det)
            su, sv, sd = U * sg, V * sg, det * sg
            tt = Tt / torch.where(det == 0.0, 1.0, det)
            b0 = bt[vi]
            valid = ((det != 0.0) & (su >= 0.0) & (sv >= 0.0)
                     & (su + sv <= sd) & (tt > tnear) & (tt < b0[:, None, :])
                     & plive[vi][:, None, :])
            tv = torch.where(valid, tt, INF)
            tmin = tv.amin(dim=1)                      # [v, 128]
            better = tmin < b0
            jsel = torch.where(tv == tmin[:, None, :], tri[None, :, None],
                               SUB_PRIMS).amin(dim=1)
            slot = ((brick[vi] * SB_PRIMS + s * SUB_PRIMS)[:, None]
                    + jsel).to(torch.int32)
            bt[vi] = torch.where(better, tmin, b0)
            bs[vi] = torch.where(better, slot, bs[vi])
        best_t[pk], best_slot[pk] = bt, bs
    t, slot = best_t.reshape(-1)[:n], best_slot.reshape(-1)[:n]
    if collect_stats:
        seen = [int(cnt.sum()), visited, voted, tested]
        return t, slot, torch.tensor(seen + [boxed_out] * early_votes,
                                     dtype=torch.int64, device=dev)
    return t, slot


# -- kernel B7 on the card -----------------------------------------------------

def build() -> Path:
    """Compile csrc/mx2_trace.cu (kernel B7) into a shared library under
    BUILD_DIR unless it is there; returns its path.  Raises if nvcc is
    missing or the build fails."""
    return cuda_build.build(SOURCE, BUILD_DIR)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(SOURCE, BUILD_DIR)
        fn = lib.pt_mx2_trace_launch
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,   # ox oy oz dx dy dz
                       i32, ctypes.c_float, ptr,       # n, tnear, shift
                       i32, ptr, ptr, ptr, i32,        # P, brk, ent, cnt, B
                       ptr, ptr, ptr,                  # boxes, subbox, coeff
                       ptr, ptr,                       # out_t, out_slot
                       ptr, ptr]                       # stats, stream
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def trace_mx2_cuda(mx: MX2Set, ox: torch.Tensor, oy: torch.Tensor,
                   oz: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
                   dz: torch.Tensor, tnear: float, brk: torch.Tensor,
                   ent: torch.Tensor, cnt: torch.Tensor,
                   collect_stats: bool = False):
    """Launch kernel B7 on the current stream: the closest triangle of each
    of the N rays (contiguous float32 [N] CUDA tensors; ray i is in packet
    i // 128) over its packet's visit list (``visit_lists``).  Returns fresh
    (t [N] f32, inf on a miss; slot [N] i32, -1 on a miss), and with
    ``collect_stats`` also an int64 [5] tensor of superbricks listed,
    visited, subs voted in, subs slab-tested and visits that ended at the
    superbrick's own box, summed over the packets (the counters of
    ``trace_mx2_plain`` with ``early_votes``).  Adds one to
    ``trace_mx2_cuda.launches`` per launch; an empty wave launches
    nothing."""
    device = ox.device
    if device.type != "cuda":
        raise ValueError(f"trace_mx2_cuda needs CUDA tensors, got {device}")
    n = int(ox.numel())
    B = int(mx.coeff.shape[0])
    P = -(-n // PACKET)
    checks = [(label, t, torch.float32, (n,))
              for label, t in zip(("ox", "oy", "oz", "dx", "dy", "dz"),
                                  (ox, oy, oz, dx, dy, dz))]
    checks += [("brk", brk, torch.int32, (P, B)),
               ("ent", ent, torch.float32, (P, B)),
               ("cnt", cnt, torch.int32, (P,)),
               ("mx.coeff", mx.coeff, torch.float32, (B, SLAB_ROWS, 128)),
               ("mx.subbox", mx.subbox, torch.float32, (B, 128)),
               ("mx.shift", mx.shift, torch.float32, (3,))]
    for label, t, dtype, shape in checks:
        if (t.device != device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{label}: need a contiguous {dtype} "
                             f"{list(shape)} tensor on {device}, got "
                             f"{t.dtype} {list(t.shape)} on {t.device}")
    out_t = torch.empty(n, dtype=torch.float32, device=device)
    out_slot = torch.empty(n, dtype=torch.int32, device=device)
    stats = (torch.zeros(5, dtype=torch.int64, device=device)
             if collect_stats else None)
    if n:
        lib = load_library()
        boxes = mx.visit_boxes()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.pt_mx2_trace_launch(
                ox.data_ptr(), oy.data_ptr(), oz.data_ptr(), dx.data_ptr(),
                dy.data_ptr(), dz.data_ptr(), n, float(tnear),
                mx.shift.data_ptr(), P, brk.data_ptr(), ent.data_ptr(),
                cnt.data_ptr(), B, boxes.data_ptr(), mx.subbox.data_ptr(),
                mx.coeff.data_ptr(),
                out_t.data_ptr(), out_slot.data_ptr(),
                stats.data_ptr() if collect_stats else None, stream)
        if err != 0:
            raise RuntimeError(f"mx2_trace launch failed: CUDA error {err}")
        trace_mx2_cuda.launches += 1
    return (out_t, out_slot, stats) if collect_stats else (out_t, out_slot)


trace_mx2_cuda.launches = 0


def trace_wave_mx2(mx: MX2Set, org: Vec3, dirn: Vec3, tnear: float):
    """(t, slot) closest triangle hit of one wave of rays ([N] components,
    any N): the visit lists, then kernel B7 for CUDA tensors or its plain
    version for CPU tensors."""
    device = org.x.device
    if mx.device != device:
        raise ValueError(f"MX2 set on {mx.device}, rays on {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no mx2 trace for device {device}")
    if org.x.numel() == 0:
        return (torch.empty(0, dtype=torch.float32, device=device),
                torch.empty(0, dtype=torch.int32, device=device))
    brk, ent, cnt = visit_lists(mx, org, dirn, tnear, 1)
    if device.type == "cpu":
        return trace_mx2_plain(mx, org, dirn, tnear, brk, ent, cnt)
    return trace_mx2_cuda(mx, *org, *dirn, tnear, brk, ent, cnt)


def trace_wave_mx2_plain(mx: MX2Set, org: Vec3, dirn: Vec3, tnear: float):
    """``trace_wave_mx2`` through the plain version on any device (what the
    chip smoke and the card's tests hold the kernel to)."""
    brk, ent, cnt = visit_lists(mx, org, dirn, tnear, 1)
    return trace_mx2_plain(mx, org, dirn, tnear, brk, ent, cnt)


# -- the record and the render ---------------------------------------------------

def _record_mx2(mx: MX2Set, t, slot, org: Vec3, dirn: Vec3, tnear: float):
    """The wave's 16-channel record from B7's (t, slot): the winner's row,
    (u, v) by one Moller-Trumbore solve, then the resident spheres."""
    rows = mx.tri_rows[torch.clamp_min(slot, 0).to(torch.int64)]
    u, v = _solve_uv(rows, org, dirn)
    return _record_from_rows(rows, u, v, t, slot, mx.sph_rows,
                             mx.num_spheres, org, dirn, tnear)


def render_samples_mx2(mx: MX2Set, cam_data: torch.Tensor, width: int,
                       height: int, sample_start: int, num_samples: int = 1,
                       seed: int = 1984, max_depth: int = MAX_DEPTH,
                       rr_start_depth: int = RR_START_DEPTH,
                       sort_mode: str = "mort_oct", nee: bool = False,
                       tracer=None, stats=None, pix_slots=None,
                       num_real=None) -> torch.Tensor:
    """"mx2" drop-in for ops.wavefront.render_samples_wavefront: the
    [H, W, 3] radiance SUM of ``num_samples`` passes on ``cam_data``'s
    device.  ``sort_mode`` is "mort_oct" or "none" ("sig_mort" needs a
    BrickSet).  ``tracer(mx, org, dirn, tnear) -> (t, slot)`` replaces
    ``trace_wave_mx2`` (the chip smoke passes the plain version).
    ``stats``, a dict, gets the traced waves and rays added to it.
    ``pix_slots`` and ``num_real`` pick the slots and the passes that count
    (ops/wavefront.py::render_waves)."""
    return render_waves(mx, cam_data, width, height, sample_start,
                        num_samples, seed, max_depth, rr_start_depth,
                        sort_mode, nee, mx.scene_lo, mx.scene_hi,
                        (tracer or trace_wave_mx2,) * max_depth, _record_mx2,
                        stats, max_rays=MAX_RAYS_PER_WAVE,
                        pix_slots=pix_slots, num_real=num_real)
