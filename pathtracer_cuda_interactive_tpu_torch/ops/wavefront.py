"""Sorted-wavefront path tracing for large triangle scenes.

The port of ``pathtracer_cuda_interactive_tpu/ops/wavefront.py``.  Bounces
are synchronous WAVES over all rays of a frame:

  wave 0   camera rays, ordered by compact screen tiles (``_wave_layout``);
  wave b   the live rays sorted by a coherence key (default "sig_mort": a
           16-bit target signature of which coarse scene regions the ray's
           line can touch, ``_sig_key``, above an origin Morton code), so
           that neighbouring rays walk the same part of the tree;
  each     one closest-triangle trace by the chosen engine (``parse_engine``;
           kernel B2, ``trace_wave_slim``, unless asked otherwise), the
           winner's record gathered and the resident spheres folded in
           (``_record_from_slots``), optional point-light NEE with shadow
           waves (``_nee_term``), and one bounce of shading, BSDF sampling
           and Russian roulette (``_shade``) in torch ops (ops/brdf.py, the
           same code the plain integrator uses).

Where the JAX package keeps a static [rows, 128] ray table with an active
mask, a ``lax.while_loop`` and a compaction ladder, this loop drops the
dead rays from the table after every wave, stable-sorts the live ones by
their key and stops when none is live or the depth cap is reached: the same
rays reach the same depths with the same RNG streams (2 camera jitter
draws, then 3 BSDF draws and 1 RR draw per bounce, as in
ops/integrator.py).  A ray's radiance is written when it dies, into a
[num_samples, H*W, 3] buffer at its (sample, pixel), which is unique per
ray, and the image is that buffer's sum over samples: no float atomics, so
renders are bit-reproducible on the card.

``trace_wave_slim`` dispatches on the device of the rays: CUDA tensors
launch the hand-written kernel (``trace_bricks_cuda``, csrc/brick_trace.cu)
and never fall back; CPU tensors run its plain version
(ops/brickkernel.py::trace_bricks_plain).  ``trace_wave_slim2`` does the
same for kernel B4, the walk with the deferred leaf
(``trace_bricks_slim2_cuda``, csrc/brick_trace_slim2.cu; plain version
``trace_bricks_pipelined_plain``), ops/pairtrace.py::trace_wave_pairs for
kernel B5, and ``trace_wave_full`` for kernel B3 (``trace_bricks_full_cuda``,
B2's source), the 16-channel record with optional per-ray traversal
counters, which the JAX package's tools and the port's
render/kernel_stats.py call.
"""

from __future__ import annotations

import ctypes
import functools
import re
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

from ..models.bricks import BRICK_ROWS, STACK_DEPTH, BrickSet
from . import brdf, cuda_build, rng
from .brickkernel import (slot_rows, tile_grid, trace_bricks_full_plain,
                          trace_bricks_pipelined_plain, trace_bricks_plain,
                          triangle_record, walk_pointers)
from .camera import generate_primary_rays
from .geometry import intersect_sphere
from .integrator import MAX_DEPTH, RR_START_DEPTH, SECONDARY_TNEAR
from .pairtrace import PACKET_ROWS, trace_wave_pairs
from .vec import Vec3, cross, dot, max_elem, normalize, where

LANES = 128
# rays per [WAVE_ROWS, 128] packet of the JAX package's layout; the primary
# wave keeps its screen-tile order (one TILE per packet)
WAVE_ROWS = 16
TILE = (64, WAVE_ROWS * LANES // 64)
INF = float("inf")
# Cap on rays per wave; sample batches beyond it render in chunks of whole
# samples, as in the JAX package.
MAX_RAYS_PER_WAVE = 1 << 21
SORT_MODES = ("sig_mort", "mort_oct", "none")

SOURCE = cuda_build.CSRC_DIR / "brick_trace.cu"
SLIM2_SOURCE = cuda_build.CSRC_DIR / "brick_trace_slim2.cu"
BUILD_DIR = cuda_build.BUILD_DIR

_lib = None
_slim2_lib = None


# -- engines -----------------------------------------------------------------

def parse_engine(trace: str):
    """(engine, number) of a per-wave trace engine name, as the JAX
    package's ``trace_tri`` reads it:
      "slim2"     -> ("slim2", 0): kernel B4, the walk with the deferred leaf;
      "pairs[N]"  -> ("pairs", N): kernel B5 with N rows of 128 rays per
                     packet (default ``pairtrace.PACKET_ROWS``);
      "slimg[N]"  -> ("slimg", N): kernel B2 (N defaults to 8);
      "slim[N]"   -> ("slim", N): kernel B2 (N defaults to 0).
    A given N must be a positive integer.  "slim[N]" and "slimg[N]" size
    the packets and row groups of the TPU's packet walk; kernel B2 walks
    per ray and has neither, so every N runs the same kernel.  Raises
    ValueError for any other name."""
    if trace == "slim2":
        return "slim2", 0
    match = re.fullmatch(r"(pairs|slimg|slim)(\d*)", trace)
    if match is None:
        raise ValueError(f"unknown wavefront trace engine {trace!r}")
    engine, digits = match.groups()
    if digits and int(digits) < 1:
        raise ValueError(f"wavefront trace engine {trace!r}: the number "
                         "must be a positive integer")
    default = {"pairs": PACKET_ROWS, "slimg": 8, "slim": 0}[engine]
    return engine, int(digits) if digits else default


def engine_tracer(trace: str):
    """The per-wave trace ``tracer(bricks, org, dirn, tnear) -> (t, slot)``
    of engine name ``trace`` (``parse_engine``)."""
    engine, number = parse_engine(trace)
    if engine == "pairs":
        return functools.partial(trace_wave_pairs, packet_rows=number)
    if engine == "slim2":
        return trace_wave_slim2
    return trace_wave_slim


# -- kernel B2 on the card (the library holds B3 too) -------------------------

def build() -> Path:
    """Compile csrc/brick_trace.cu (kernels B2 and B3) into a shared
    library under BUILD_DIR unless it is there; returns its path.  Raises
    if nvcc is missing or the build fails."""
    return cuda_build.build(SOURCE, BUILD_DIR)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.pt_brick_trace_launch
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,   # ox oy oz dx dy dz
                       i32, ctypes.c_float,            # n, tnear
                       ptr, ptr, ptr,                  # nodes, tris, gates
                       ptr, ptr,                       # out_t, out_slot
                       ptr]                            # stream
        fn.restype = ctypes.c_int
        fn = lib.pt_brick_trace_full_launch
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,   # ox oy oz dx dy dz
                       i32, ctypes.c_float, ptr,       # n, tnear, active
                       ptr, i32,                       # sph_rows, S
                       ptr, ptr, ptr, ptr,             # nodes, tris, gates, bricks
                       ptr, ptr,                       # out, stats
                       ptr]                            # stream
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_wave(bricks: BrickSet, rays, name: str) -> int:
    """Check a wave's ray components (contiguous float32 [N] tensors on one
    card) and the brick set against what the brick kernels take (B4 and B5
    read the set's own tensors; B2 and B3 its walk table, which
    ``walk_pointers`` checks, and B3 its records); returns N."""
    if bricks.top_depth + 2 > STACK_DEPTH:
        raise ValueError(f"top tree of depth {bricks.top_depth} is too deep "
                         f"for the kernel's stack of {STACK_DEPTH} slots")
    device = rays[0].device
    if device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {device}")
    n = int(rays[0].numel())
    for label, t in zip(("ox", "oy", "oz", "dx", "dy", "dz"), rays):
        if (t.device != device or t.dtype != torch.float32 or t.ndim != 1
                or t.numel() != n or not t.is_contiguous()):
            raise ValueError(f"{label}: need a contiguous float32 [{n}] "
                             f"tensor on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    for label, t, dtype in (("brick_data", bricks.brick_data, torch.float32),
                            ("top_boxes", bricks.top_boxes, torch.float32),
                            ("top_links", bricks.top_links, torch.int32),
                            ("sph_rows", bricks.sph_rows, torch.float32)):
        if t.device != device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"bricks.{label}: need a contiguous {dtype} "
                             f"tensor on {device}, got {t.dtype} on "
                             f"{t.device}")
    if tuple(bricks.brick_data.shape[1:]) != (BRICK_ROWS, 128):
        raise ValueError("bricks.brick_data: need [B, 136, 128]")
    return n


def trace_bricks_cuda(bricks: BrickSet, ox: torch.Tensor, oy: torch.Tensor,
                      oz: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
                      dz: torch.Tensor, tnear: float):
    """Launch kernel B2 on the current stream: the closest triangle hit of
    each of the N rays given as contiguous float32 [N] CUDA tensors.
    Returns fresh (t [N] f32, inf on a miss; slot [N] i32, -1 on a miss).
    Adds one to ``trace_bricks_cuda.launches`` per launch; an empty wave
    launches nothing."""
    n = _check_wave(bricks, (ox, oy, oz, dx, dy, dz), "trace_bricks_cuda")
    device = ox.device
    out_t = torch.empty(n, dtype=torch.float32, device=device)
    out_slot = torch.empty(n, dtype=torch.int32, device=device)
    if n == 0:
        return out_t, out_slot
    lib = load_library()
    nodes, tris, gates = walk_pointers(bricks)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.pt_brick_trace_launch(
            ox.data_ptr(), oy.data_ptr(), oz.data_ptr(), dx.data_ptr(),
            dy.data_ptr(), dz.data_ptr(), n, float(tnear), nodes, tris,
            gates, out_t.data_ptr(), out_slot.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"brick_trace launch failed: CUDA error {err}")
    trace_bricks_cuda.launches += 1
    return out_t, out_slot


trace_bricks_cuda.launches = 0


def trace_wave_slim(bricks: BrickSet, org: Vec3, dirn: Vec3, tnear: float):
    """(t, slot) closest triangle hit of one wave of rays ([N] components).
    CUDA tensors launch kernel B2; CPU tensors run its plain version."""
    device = org.x.device
    if bricks.device != device:
        raise ValueError(f"bricks on {bricks.device}, rays on {device}")
    if device.type == "cpu":
        return trace_bricks_plain(bricks, org, dirn, tnear)
    if device.type != "cuda":
        raise ValueError(f"no brick trace for device {device}")
    return trace_bricks_cuda(bricks, *org, *dirn, tnear)


# -- kernel B4 on the card ----------------------------------------------------

def load_slim2_library() -> ctypes.CDLL:
    """Build (if needed) csrc/brick_trace_slim2.cu (kernel B4) and load it,
    once per process.  Raises if nvcc is missing or the build fails."""
    global _slim2_lib
    if _slim2_lib is None:
        lib = ctypes.CDLL(str(cuda_build.build(SLIM2_SOURCE, BUILD_DIR)))
        fn = lib.pt_brick_trace_slim2_launch
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,   # ox oy oz dx dy dz
                       i32, ctypes.c_float,            # n, tnear
                       ptr, ptr, ptr,                  # boxes, links, bricks
                       ptr, ptr,                       # out_t, out_slot
                       i32, ptr]                       # staged, stream
        fn.restype = ctypes.c_int
        _slim2_lib = lib
    return _slim2_lib


def trace_bricks_slim2_cuda(bricks: BrickSet, ox: torch.Tensor,
                            oy: torch.Tensor, oz: torch.Tensor,
                            dx: torch.Tensor, dy: torch.Tensor,
                            dz: torch.Tensor, tnear: float,
                            staged: bool = True):
    """Launch kernel B4 on the current stream: ``trace_bricks_cuda``'s
    contract and output, through the walk that starts the next leaf's
    chunk-gate row on its way before it tests the pending leaf.  ``staged``
    picks how: True, the engine's way, copies the row with cp.async into
    the thread's shared-memory slots; False only prefetches it toward L2
    (render/kernel_stats.py times both).  Adds one to
    ``trace_bricks_slim2_cuda.launches`` per launch; an empty wave launches
    nothing."""
    n = _check_wave(bricks, (ox, oy, oz, dx, dy, dz),
                    "trace_bricks_slim2_cuda")
    device = ox.device
    out_t = torch.empty(n, dtype=torch.float32, device=device)
    out_slot = torch.empty(n, dtype=torch.int32, device=device)
    if n == 0:
        return out_t, out_slot
    lib = load_slim2_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.pt_brick_trace_slim2_launch(
            ox.data_ptr(), oy.data_ptr(), oz.data_ptr(), dx.data_ptr(),
            dy.data_ptr(), dz.data_ptr(), n, float(tnear),
            bricks.top_boxes.data_ptr(), bricks.top_links.data_ptr(),
            bricks.brick_data.data_ptr(), out_t.data_ptr(),
            out_slot.data_ptr(), int(staged), stream)
    if err != 0:
        raise RuntimeError(f"brick_trace_slim2 launch failed: CUDA error "
                           f"{err}")
    trace_bricks_slim2_cuda.launches += 1
    return out_t, out_slot


trace_bricks_slim2_cuda.launches = 0


def trace_wave_slim2(bricks: BrickSet, org: Vec3, dirn: Vec3, tnear: float):
    """(t, slot) closest triangle hit of one wave of rays ([N] components)
    through the walk with the deferred leaf.  CUDA tensors launch kernel
    B4; CPU tensors run its plain version."""
    device = org.x.device
    if bricks.device != device:
        raise ValueError(f"bricks on {bricks.device}, rays on {device}")
    if device.type == "cpu":
        return trace_bricks_pipelined_plain(bricks, org, dirn, tnear)
    if device.type != "cuda":
        raise ValueError(f"no brick trace for device {device}")
    return trace_bricks_slim2_cuda(bricks, *org, *dirn, tnear)


# -- kernel B3 on the card -----------------------------------------------------

def trace_bricks_full_cuda(bricks: BrickSet, ox: torch.Tensor,
                           oy: torch.Tensor, oz: torch.Tensor,
                           dx: torch.Tensor, dy: torch.Tensor,
                           dz: torch.Tensor, tnear: float, active=None,
                           collect_stats: bool = False):
    """Launch kernel B3 on the current stream: the 16-channel closest hit
    (resident spheres first, then the bricks) of each of the N rays given
    as contiguous float32 [N] CUDA tensors; ``active``, a bool [N] tensor or
    None, leaves the rays where it is False untraced (a miss).  Returns
    (record, counts): the record a tuple of 16 fresh [N] f32 views of one
    [16, N] buffer (t is inf and the rest 0 on a miss), counts a fresh
    int32 [3, N] of nodes popped, bricks entered and chunk gates passed
    per ray with ``collect_stats``, else None.  Adds one to
    ``trace_bricks_full_cuda.launches`` per launch; an empty wave launches
    nothing."""
    n = _check_wave(bricks, (ox, oy, oz, dx, dy, dz),
                    "trace_bricks_full_cuda")
    device = ox.device
    if active is not None and (active.device != device
                               or active.dtype != torch.bool
                               or active.numel() != n
                               or not active.is_contiguous()):
        raise ValueError(f"active: need a contiguous bool [{n}] tensor on "
                         f"{device}")
    out = torch.empty((16, n), dtype=torch.float32, device=device)
    counts = (torch.empty((3, n), dtype=torch.int32, device=device)
              if collect_stats else None)
    if n:
        lib = load_library()
        nodes, tris, gates = walk_pointers(bricks)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.pt_brick_trace_full_launch(
                ox.data_ptr(), oy.data_ptr(), oz.data_ptr(), dx.data_ptr(),
                dy.data_ptr(), dz.data_ptr(), n, float(tnear),
                active.data_ptr() if active is not None else None,
                bricks.sph_rows.data_ptr(), bricks.num_spheres, nodes, tris,
                gates, bricks.brick_data.data_ptr(), out.data_ptr(),
                counts.data_ptr() if collect_stats else None, stream)
        if err != 0:
            raise RuntimeError(f"brick_trace_full launch failed: CUDA error "
                               f"{err}")
        trace_bricks_full_cuda.launches += 1
    return tuple(out.unbind(0)), counts


trace_bricks_full_cuda.launches = 0


def trace_wave_full(bricks: BrickSet, org: Vec3, dirn: Vec3, tnear: float,
                    active=None, collect_stats: bool = False):
    """The 16-channel closest hit of one wave of rays ([N] components): the
    JAX package's _trace_wave.  Returns the record (a tuple of 16 [N] f32
    tensors), and with ``collect_stats`` (record, counts), counts the int32
    [3, N] per-ray nodes popped, bricks entered and chunk gates passed.
    CUDA tensors launch kernel B3; CPU tensors run its plain version
    (ops/brickkernel.py::trace_bricks_full_plain)."""
    device = org.x.device
    if bricks.device != device:
        raise ValueError(f"bricks on {bricks.device}, rays on {device}")
    if device.type == "cpu":
        return trace_bricks_full_plain(bricks, org, dirn, tnear, active,
                                       collect_stats)
    if device.type != "cuda":
        raise ValueError(f"no brick trace for device {device}")
    record, counts = trace_bricks_full_cuda(bricks, *org, *dirn, tnear,
                                            active, collect_stats)
    return (record, counts) if collect_stats else record


# -- ray layout and sort keys --------------------------------------------------

def _wave_layout(width: int, height: int):
    """Static slot -> pixel map: each [WAVE_ROWS, 128] packet covers one
    compact TILE screen tile.  Padding slots (off-image) get pixel id
    R = width * height."""
    tw, th = TILE
    n_blocks = tile_grid(width, height, TILE)
    tiles_x = -(-width // tw)
    blk = np.arange(n_blocks)[:, None, None]
    rowid = np.arange(WAVE_ROWS)[None, :, None]
    laneid = np.arange(LANES)[None, None, :]
    ii = (blk % tiles_x) * tw + laneid % tw
    jj = (blk // tiles_x) * th + rowid * (LANES // tw) + laneid // tw
    valid = (ii < width) & (jj < height)
    pix = np.where(valid, jj * width + ii, width * height)
    return pix.reshape(-1).astype(np.int32), n_blocks


def _spread3(x):
    """Interleave the low 10 bits of int32 x with two zero bits each."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _octant(dirn: Vec3):
    i32 = torch.int32
    return ((dirn.x > 0).to(i32) * 4 + (dirn.y > 0).to(i32) * 2
            + (dirn.z > 0).to(i32))


def _morton(org: Vec3, lo, inv_extent, top: float):
    def q(c, l, s):
        return torch.clamp((c - l) * s * top, 0.0, top).to(torch.int32)

    mx = _spread3(q(org.x, lo[0], inv_extent[0]))
    my = _spread3(q(org.y, lo[1], inv_extent[1]))
    mz = _spread3(q(org.z, lo[2], inv_extent[2]))
    return (mx << 2) | (my << 1) | mz


def _sort_key(org: Vec3, dirn: Vec3, lo, inv_extent):
    """"mort_oct": 21-bit Morton code of the origin (scene-box normalized)
    above the direction octant.  Every ray of the table is live, so there
    is no dead-ray sentinel."""
    return (_morton(org, lo, inv_extent, 127.0) << 3) | _octant(dirn)


def _sig_key(org: Vec3, dirn: Vec3, lo, inv_extent, coarse):
    """"sig_mort": the high K = len(coarse) bits say which coarse scene
    regions (models/bricks.py::_coarse_cut) the ray's forward line can
    touch, the low 3 * mb bits (mb = min(7, (30 - K) // 3)) are the origin
    Morton code.  Every ray of the table is live, so there is no dead-ray
    sentinel."""
    inv = Vec3(1.0 / dirn.x, 1.0 / dirn.y, 1.0 / dirn.z)
    col = lambda v: v.reshape(-1)[:, None]
    o = Vec3(col(org.x), col(org.y), col(org.z))
    iv = Vec3(col(inv.x), col(inv.y), col(inv.z))
    # all K boxes at once, [N, K]; same elementwise arithmetic as the JAX
    # per-box loop
    tx0 = (coarse[:, 0] - o.x) * iv.x
    tx1 = (coarse[:, 3] - o.x) * iv.x
    ty0 = (coarse[:, 1] - o.y) * iv.y
    ty1 = (coarse[:, 4] - o.y) * iv.y
    tz0 = (coarse[:, 2] - o.z) * iv.z
    tz1 = (coarse[:, 5] - o.z) * iv.z
    tn = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                     torch.minimum(ty0, ty1)),
                       torch.minimum(tz0, tz1))
    tf = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                     torch.maximum(ty0, ty1)),
                       torch.maximum(tz0, tz1))
    hit = (tf >= torch.maximum(tn, torch.zeros_like(tn))) & (coarse[:, 6] > 0.0)
    K = int(coarse.shape[0])
    bits = torch.tensor([1 << k for k in range(K)], dtype=torch.int32,
                        device=tn.device)
    sig = (hit.to(torch.int32) * bits).sum(dim=1, dtype=torch.int32)
    sig = sig.reshape(org.x.shape)

    # Morton bits shrink as the signature widens so the key stays in int32
    mb = min(7, (30 - K) // 3)
    return (sig << (3 * mb)) | _morton(org, lo, inv_extent, float(2 ** mb - 1))


# -- the epilogue and the bounce ----------------------------------------------

def _sphere_tmin(sph_rows, S: int, org: Vec3, dirn: Vec3, tnear: float, t):
    """Fold the resident sphere table into a best t (shadow rays)."""
    for j in range(S):
        c = Vec3(sph_rows[j, 1], sph_rows[j, 2], sph_rows[j, 3])
        ts, hit = intersect_sphere(c, sph_rows[j, 4], org, dirn, tnear, t)
        t = torch.where(hit & (ts < t), ts, t)
    return t


def _solve_uv(rows, org: Vec3, dirn: Vec3):
    """Barycentric (u, v) of each ray on the triangle of its 32-float record
    ``rows`` [m, 32]: one Moller-Trumbore solve (0 / 1 where the ray is
    parallel to the triangle)."""
    gv = lambda j: Vec3(rows[:, j], rows[:, j + 1], rows[:, j + 2])
    p0, e1, e2 = gv(1), gv(4), gv(7)
    pv = cross(dirn, e2)
    det = dot(e1, pv)
    det_s = torch.where(det == 0.0, 1.0, det)
    tvec = org - p0
    u = dot(tvec, pv) / det_s
    qv = cross(tvec, e1)
    v = dot(dirn, qv) / det_s
    return u, v


def _record_from_rows(rows, u, v, t, slot, sph, S: int, org: Vec3,
                      dirn: Vec3, tnear: float):
    """The 16-channel hit record of a wave from each ray's winning triangle
    (its record ``rows`` [m, 32], barycentrics, t and slot, -1 = miss), with
    the ``S`` resident spheres of table ``sph`` folded in after the
    triangles by a strict ``ts < t``, so a triangle wins an equal-t tie.
    Every ray of the table is live, so there is no active mask."""
    ns, pos, mt, alb, mp, em, emit = triangle_record(rows, u, v)
    t = torch.where(slot >= 0, t, INF)

    for j in range(S):
        c = Vec3(sph[j, 1], sph[j, 2], sph[j, 3])
        ts, hit = intersect_sphere(c, sph[j, 4], org, dirn, tnear, t)
        closer = hit & (ts < t)
        spos = Vec3(org.x + dirn.x * ts, org.y + dirn.y * ts,
                    org.z + dirn.z * ts)
        sns = Vec3(spos.x - c.x, spos.y - c.y, spos.z - c.z)
        t = torch.where(closer, ts, t)
        pos = where(closer, spos, pos)
        ns = where(closer, sns, ns)
        mt = torch.where(closer, sph[j, 19], mt)
        mp = torch.where(closer, sph[j, 23], mp)
        alb = where(closer, Vec3(sph[j, 20], sph[j, 21], sph[j, 22]), alb)
        em = where(closer, Vec3(sph[j, 24], sph[j, 25], sph[j, 26]), em)
        emit = torch.where(closer, sph[j, 27], emit)
    return (t, ns.x, ns.y, ns.z, pos.x, pos.y, pos.z, mt,
            alb.x, alb.y, alb.z, mp, em.x, em.y, em.z, emit)


def _record_from_slots(bricks: BrickSet, t, slot, org: Vec3, dirn: Vec3,
                       tnear: float):
    """The 16-channel hit record of the JAX package's full trace kernel from
    B2's (t, slot): one 32-float gather per ray of the winning triangle's
    record, a Moller-Trumbore re-solve for (u, v), then the resident
    spheres."""
    rows = slot_rows(bricks, slot)
    u, v = _solve_uv(rows, org, dirn)
    return _record_from_rows(rows, u, v, t, slot, bricks.sph_rows,
                             bricks.num_spheres, org, dirn, tnear)


def _material(rec) -> brdf.MatLookup:
    mt, ar, ag, ab, mp = rec[7], rec[8], rec[9], rec[10], rec[11]
    return brdf.MatLookup(mtype=mt.to(torch.int32), color=Vec3(ar, ag, ab),
                          param=mp)


def _nee_term(rec, dirn: Vec3, T: Vec3, light_rows, shadow_t) -> Vec3:
    """Point-light next-event estimation for one wave: the direct light to
    add at each hit (ops/integrator.py::_direct_point_lights semantics; no
    RNG draws).  ``shadow_t(org, wo, mask) -> t`` traces a shadow wave of
    the masked rays and returns the closest-hit distance (inf = clear)."""
    t, nsx, nsy, nsz, px, py, pz = rec[:7]
    zero = Vec3.zeros(t.shape, device=t.device)
    hit = t < INF
    ns = normalize(Vec3(nsx, nsy, nsz))
    wi = -dirn
    cos_view = dot(wi, ns)
    n = where(cos_view < 0.0, -ns, ns)
    mat = _material(rec)
    pos = Vec3(px, py, pz)
    out = zero
    for l in range(int(light_rows.shape[0])):
        d = Vec3(light_rows[l, 0] - pos.x, light_rows[l, 1] - pos.y,
                 light_rows[l, 2] - pos.z)
        dist2 = dot(d, d)
        dist = torch.sqrt(dist2)
        wo = d * (1.0 / torch.clamp_min(dist, 1e-20))
        ev_value, _ = brdf.eval_brdf(mat, n, wi, wo)
        ts = shadow_t(pos, wo, hit)
        occ = ts < dist * (1.0 - 1e-3)
        inten = Vec3(light_rows[l, 3], light_rows[l, 4], light_rows[l, 5])
        contrib = T * ev_value * inten * (1.0 / torch.clamp_min(dist2, 1e-20))
        out = out + where(hit & ~occ, contrib, zero)
    return out


def _shade(rec, org: Vec3, dirn: Vec3, T: Vec3, L: Vec3, state, depth: int,
           bg: Vec3, rr_start_depth: int, max_depth: int):
    """One bounce of the radiance.cuh:21-79 state machine for every ray of
    the table, given its hit record.  Returns (org, dirn, T, L, active,
    state); ``active`` False marks rays whose path ended."""
    (t, nsx, nsy, nsz, px, py, pz, _mt, _ar, _ag, _ab, _mp,
     er, eg, eb, em) = rec
    zero = Vec3.zeros(t.shape, device=t.device)
    miss = t == INF
    L = L + where(miss, T * bg, zero)
    active = ~miss

    ns = normalize(Vec3(nsx, nsy, nsz))
    wi = -dirn
    cos_view = dot(wi, ns)

    front_emit = active & (em > 0.0) & (cos_view > 0.0)
    L = L + where(front_emit, T * Vec3(er, eg, eb), zero)

    n = where(cos_view < 0.0, -ns, ns)

    state, u1 = rng.next_uniform(state)
    state, u2 = rng.next_uniform(state)
    state, u3 = rng.next_uniform(state)
    mat = _material(rec)
    wo, is_spec, weight = brdf.sample_brdf_from_uniforms(mat, n, wi,
                                                         u1, u2, u3)
    ev_value, ev_pdf = brdf.eval_brdf(mat, n, wi, wo)

    ok_spec = max_elem(weight) > 0.0
    ok_scatter = (max_elem(ev_value) > 0.0) & (ev_pdf > 0.0)
    pdf_safe = torch.where(ev_pdf > 0.0, ev_pdf, 1.0)
    contrib = where(is_spec, weight, ev_value * (1.0 / pdf_safe))
    ok = torch.where(is_spec, ok_spec, ok_scatter)

    T = where(active & ok, T * contrib, T)
    active = active & ok

    org = where(active, Vec3(px, py, pz), org)
    dirn = where(active, wo, dirn)

    state, ru = rng.next_uniform(state)
    if depth > rr_start_depth:
        p = torch.clamp_min(1.0 - max_elem(T), 0.5)
        kill = ru < p
        scale = 1.0 / torch.where(~kill & (p < 1.0), 1.0 - p, 1.0)
        T = where(active & ~kill, T * scale, T)
        active = active & ~kill

    if depth + 1 >= max_depth:
        active = torch.zeros_like(active)
    return org, dirn, T, L, active, state


# -- the wave loop -----------------------------------------------------------

def _sample_index(sample_start: int, samp: torch.Tensor) -> torch.Tensor:
    """sample_start + samp modulo 2^32, as int32 bits (the JAX uint32)."""
    s = (samp.to(torch.int64) + (sample_start & 0xFFFFFFFF)) & 0xFFFFFFFF
    return torch.where(s >= 2 ** 31, s - 2 ** 32, s).to(torch.int32)


def _render_chunk(scene, cam_data, width: int, height: int,
                  pix_slots, sample_start: int, num_samples: int, seed: int,
                  max_depth: int, rr_start_depth: int, sort_mode: str,
                  light_rows, lo, inv_extent, tracer, record, stats: dict):
    """Radiance sum [H, W, 3] of samples sample_start .. + num_samples.
    ``scene`` is a BrickSet or one of the experiments' sets: anything with
    the background, ``sph_rows`` and ``num_spheres`` (and ``coarse_boxes``
    for the "sig_mort" key).  ``tracer(scene, org, dirn, tnear)`` returns a
    wave's closest triangle hits as a tuple whose first entry is t, and
    ``record(scene, *hit, org, dirn, tnear)`` makes the 16-channel record
    of them."""
    dev = cam_data.device
    R = width * height
    n_slots = int(pix_slots.numel())
    pix = pix_slots.repeat(num_samples)
    samp = torch.arange(num_samples, dtype=torch.int32,
                        device=dev).repeat_interleave(n_slots)
    keep = pix < R                       # padding slots never become rays
    pix, samp = pix[keep], samp[keep]

    state = rng.seed_rays(pix, _sample_index(sample_start, samp), seed)
    state, u1 = rng.next_uniform(state)
    state, u2 = rng.next_uniform(state)
    i = (pix % width).to(torch.float32)
    j = (pix // width).to(torch.float32)
    org, dirn = generate_primary_rays(cam_data, (i + u1) / width,
                                      (j + u2) / height)
    n = int(pix.numel())
    T = Vec3.full((n,), (1.0, 1.0, 1.0), device=dev)
    L = Vec3.zeros((n,), device=dev)
    bg = Vec3(scene.bg_r, scene.bg_g, scene.bg_b)
    out = torch.zeros((num_samples, R, 3), dtype=torch.float32, device=dev)

    def trace(o, d, tnear):
        stats["waves"] = stats.get("waves", 0) + 1
        stats["rays"] = stats.get("rays", 0) + int(o.x.numel())
        return tracer(scene, o, d, tnear)

    def shadow_t(sorg, sdir, mask):
        ts = torch.full(mask.shape, INF, dtype=torch.float32, device=dev)
        idx = torch.nonzero(mask).reshape(-1)
        if idx.numel():
            so = Vec3(*(c[idx] for c in sorg))
            sd = Vec3(*(c[idx] for c in sdir))
            st = trace(so, sd, SECONDARY_TNEAR)[0]
            ts[idx] = _sphere_tmin(scene.sph_rows, scene.num_spheres, so,
                                   sd, SECONDARY_TNEAR, st)
        return ts

    depth = 0
    while n:
        if depth and sort_mode != "none":
            with record_function("wavefront.sort"):
                if sort_mode == "mort_oct":
                    key = _sort_key(org, dirn, lo, inv_extent)
                else:
                    key = _sig_key(org, dirn, lo, inv_extent,
                                   scene.coarse_boxes)
                perm = torch.sort(key, stable=True).indices
                org = Vec3(*(c[perm] for c in org))
                dirn = Vec3(*(c[perm] for c in dirn))
                T = Vec3(*(c[perm] for c in T))
                L = Vec3(*(c[perm] for c in L))
                state, pix, samp = state[perm], pix[perm], samp[perm]
        tnear = 0.0 if depth == 0 else SECONDARY_TNEAR
        with record_function("wavefront.trace"):
            hit = trace(org, dirn, tnear)
        with record_function("wavefront.shade"):
            rec = record(scene, *hit, org, dirn, tnear)
            if light_rows is not None:
                L = L + _nee_term(rec, dirn, T, light_rows, shadow_t)
            org, dirn, T, L, active, state = _shade(
                rec, org, dirn, T, L, state, depth, bg, rr_start_depth,
                max_depth)
        depth += 1

        with record_function("wavefront.scatter"):
            dead = ~active
            out[samp[dead].long(), pix[dead].long()] = L.to_array()[dead]
        with record_function("wavefront.compact"):
            live = torch.nonzero(active).reshape(-1)
            n = int(live.numel())
            org = Vec3(*(c[live] for c in org))
            dirn = Vec3(*(c[live] for c in dirn))
            T = Vec3(*(c[live] for c in T))
            L = Vec3(*(c[live] for c in L))
            state, pix, samp = state[live], pix[live], samp[live]
    return out.sum(dim=0).reshape(height, width, 3)


def render_waves(scene, cam_data: torch.Tensor, width: int, height: int,
                 sample_start: int, num_samples: int, seed: int,
                 max_depth: int, rr_start_depth: int, sort_mode: str,
                 nee: bool, lo, hi, tracer, record, stats=None,
                 max_rays: int = MAX_RAYS_PER_WAVE) -> torch.Tensor:
    """The wave loop under ``render_samples_wavefront`` and the experiments'
    ``render_samples_mx`` / ``render_samples_mx2``: the radiance SUM of
    ``num_samples`` passes, [H, W, 3], over a scene whose box is ``lo`` ..
    ``hi`` (the sort keys' normalization), traced by ``tracer`` and recorded
    by ``record`` (see ``_render_chunk``).

    At most ``max_rays`` rays go into a wave: sample batches beyond it
    render in chunks of whole samples, and a frame whose single-sample wave
    already exceeds the cap is also cut along its slots, in runs of whole
    32 x 128-slot blocks, whose images add (each pixel lies in one slice).
    ``stats``, a dict, gets the count of traced
    waves ("waves") and rays ("rays") added to it."""
    if sort_mode not in SORT_MODES:
        raise ValueError(f"unknown sort_mode {sort_mode!r}")
    if sort_mode == "sig_mort" and not hasattr(scene, "coarse_boxes"):
        raise ValueError('sort_mode "sig_mort" needs a BrickSet\'s coarse '
                         f"boxes; {type(scene).__name__} has none")
    if max_depth < 1:
        raise ValueError("need max_depth >= 1")
    dev = cam_data.device
    if scene.device != dev:
        raise ValueError(f"scene on {scene.device}, camera on {dev}")
    stats = {} if stats is None else stats
    light_rows = None
    if nee and int(scene.light_pos.shape[0]) > 0:
        light_rows = torch.cat([scene.light_pos, scene.light_intensity],
                               dim=1)
    inv_extent = 1.0 / torch.clamp_min(hi - lo, 1e-12)
    pix_np, _ = _wave_layout(width, height)
    pix_slots = torch.from_numpy(pix_np).to(dev)
    n_slots = int(pix_np.shape[0])
    gran = 32 * LANES
    slice_len = n_slots
    if n_slots > max_rays:
        slice_len = max(gran, max_rays // gran * gran)

    acc = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
    for s0 in range(0, n_slots, slice_len):
        slots = pix_slots[s0:s0 + slice_len]
        chunk = max(1, max_rays // int(slots.numel()))
        done = 0
        while done < num_samples:
            ns = min(chunk, num_samples - done)
            acc += _render_chunk(scene, cam_data, width, height, slots,
                                 sample_start + done, ns, seed, max_depth,
                                 rr_start_depth, sort_mode, light_rows, lo,
                                 inv_extent, tracer, record, stats)
            done += ns
    return acc


def render_samples_wavefront(brickset: BrickSet, cam_data: torch.Tensor,
                             width: int, height: int, sample_start: int,
                             num_samples: int = 1, seed: int = 1984,
                             max_depth: int = MAX_DEPTH,
                             rr_start_depth: int = RR_START_DEPTH,
                             sort_mode: str = "sig_mort", nee: bool = False,
                             trace: str = "slim", tracer=None,
                             stats=None) -> torch.Tensor:
    """Large-scene drop-in for ops.integrator.render_samples: the radiance
    SUM of ``num_samples`` passes, [H, W, 3], on ``cam_data``'s device.

    ``trace`` names the per-wave engine of the closest-hit and the shadow
    waves ("slim", kernel B2, "slim2", kernel B4, "pairs[N]", kernel B5;
    see ``parse_engine``).  The JAX package's ``compact_tail`` and
    ``tail_trace`` shaped its compaction ladder; the per-wave compaction
    here does what the ladder did, so they have no counterpart.
    ``sort_mode`` picks the inter-wave key ("sig_mort", "mort_oct" or
    "none").  ``tracer(bricks, org,
    dirn, tnear) -> (t, slot)`` replaces the engine's per-wave trace (the
    chip smoke passes a plain version to hold a kernel to it).  ``stats``, a dict, gets the count of traced waves
    ("waves") and rays ("rays") added to it."""
    engine = engine_tracer(trace)
    # scene box = the top tree's root node
    root = brickset.top_boxes[0, :6]
    return render_waves(brickset, cam_data, width, height, sample_start,
                        num_samples, seed, max_depth, rr_start_depth,
                        sort_mode, nee, root[:3], root[3:], tracer or engine,
                        _record_from_slots, stats)
