"""Sorted-wavefront path tracing for large triangle scenes.

The port of ``pathtracer_cuda_interactive_tpu/ops/wavefront.py``.  Bounces
are synchronous WAVES over all rays of a frame:

  wave 0   camera rays, ordered by compact screen tiles (``_wave_layout``);
  wave b   the live rays sorted by a coherence key (default "sig_mort": a
           16-bit target signature of which coarse scene regions the ray's
           line can touch, above an origin Morton code), so that
           neighbouring rays walk the same part of the tree;
  each     one closest-triangle trace by the chosen engine (``parse_engine``;
           kernel B2, ``trace_wave_slim``, unless asked otherwise), then the
           bounce step of ops/wave_step.py: the winner's record with the
           resident spheres folded in (kernel W1), optional point-light NEE
           with shadow waves, and one bounce of shading, BSDF sampling and
           Russian roulette (kernel W2), then the next wave's key (W3).

A wave's rays are one ray table, [16, N] (ops/wave_step.py).  Where the JAX
package keeps a static [rows, 128] table with an active mask, a
``lax.while_loop`` and a compaction ladder, this loop keys a ray whose
path ended to INT32_MAX, so one stable sort orders the next wave and sinks
the ended rays, as the JAX package's sort does.  A frame's chunks
(``_ChunkWaves``) run the waves uncounted (the live rays gathered, one
host read a wave) or counted (fixed capacity, the live count on the
device, CUDA graphs, one read a group of waves, the tail in one drain
launch), as ``wave_engine`` picks: the same rays reach the same depths
with the same RNG streams (2 camera jitter draws, then 3 BSDF draws and 1
RR draw per bounce, as in ops/integrator.py).  A ray's radiance is written
when it dies, into a [num_samples, H*W, 3] buffer at its (sample, pixel),
unique per ray, and the image is that buffer's sum over samples: no float
atomics, so renders are bit-reproducible on the card.

The trace engines (``trace_wave_slim``, kernel B2; ``trace_wave_slim2``, B4;
ops/pairtrace.py::trace_wave_pairs, B5; ``trace_wave_full``, B3, the
16-channel record with per-ray counters that render/kernel_stats.py reads)
and the bounce step's kernels dispatch on the device of the rays: CUDA
tensors launch the hand-written kernel and never fall back, CPU tensors
run its plain version.
"""

from __future__ import annotations

import ctypes
import functools
import re
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..models.bricks import BRICK_ROWS, STACK_DEPTH, BrickSet
from ..utils.trace import NOOP, count, span
from . import cuda_build, rng, wave_step
from .brickkernel import (tile_grid, trace_bricks_full_plain,
                          trace_bricks_pipelined_plain, trace_bricks_plain,
                          walk_pointers)
from .camera import generate_primary_rays
from .integrator import MAX_DEPTH, RR_START_DEPTH, SECONDARY_TNEAR
from .pairtrace import PACKET_ROWS, trace_wave_pairs
from .vec import Vec3
from .wave_step import INF, SORT_MODES, STEPS, WaveSteps

LANES = 128
# rays per [WAVE_ROWS, 128] packet of the JAX package's layout; the primary
# wave keeps its screen-tile order (one TILE per packet)
WAVE_ROWS = 16
TILE = (64, WAVE_ROWS * LANES // 64)
# Cap on rays per wave; sample batches beyond it render in chunks of whole
# samples, as in the JAX package.
MAX_RAYS_PER_WAVE = 1 << 21

SOURCE = cuda_build.CSRC_DIR / "brick_trace.cu"
SLIM2_SOURCE = cuda_build.CSRC_DIR / "brick_trace_slim2.cu"
BUILD_DIR = cuda_build.BUILD_DIR

_lib = None
_slim2_lib = None
_PAIRS = {}             # packet rows -> kernel B5's tracer (engine_tracer)


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
    of engine name ``trace`` (``parse_engine``): one object a name, as a
    kept ``WaveCache`` compares engines frame to frame."""
    engine, number = parse_engine(trace)
    if engine == "pairs":
        return _PAIRS.setdefault(
            number, functools.partial(trace_wave_pairs, packet_rows=number))
    if engine == "slim2":
        return trace_wave_slim2
    return trace_wave_slim


def trace_kernels(trace: str, tail_trace: str = "") -> set:
    """The kernels ("B2", "B4", "B5") that the waves of engines ``trace``
    and ``tail_trace`` ("": none) launch on a card (``parse_engine``)."""
    names = (trace, tail_trace) if tail_trace else (trace,)
    kernels = {"slim": "B2", "slimg": "B2", "slim2": "B4", "pairs": "B5"}
    return {kernels[parse_engine(name)[0]] for name in names}


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
        lib = cuda_build.load(SOURCE, BUILD_DIR)
        fn = lib.pt_brick_trace_launch
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,   # ox oy oz dx dy dz
                       i32, ctypes.c_float,            # n, tnear
                       ptr, ptr, ptr,                  # nodes, tris, gates
                       ptr, ptr, ptr,                  # out_t, out_slot, ctl
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
    card) and the brick set against what the brick kernels take (B2, B3 and
    B4 read its walk table, which ``walk_pointers`` checks, and B3 its
    records); returns N."""
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
                      dz: torch.Tensor, tnear: float, ctl=None):
    """Launch kernel B2 on the current stream: the closest triangle hit of
    each of the N rays given as contiguous float32 [N] CUDA tensors.
    Returns fresh (t [N] f32, inf on a miss; slot [N] i32, -1 on a miss).
    Adds one to ``trace_bricks_cuda.launches`` per launch; an empty wave
    launches nothing.  With the counted schedule's control block ``ctl``
    (ops/wave_step.py) only its ``COUNT`` first rays are traced (t and slot
    past them are left unwritten)."""
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
            gates, out_t.data_ptr(), out_slot.data_ptr(),
            wave_step._control(ctl, device), stream)
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


def trace_wave_counted(bricks: BrickSet, org: Vec3, dirn: Vec3, tnear: float,
                       ctl):
    """``trace_wave_slim`` over the first ``ctl[COUNT]`` of a wave's N
    columns (the counted schedule's control block, ops/wave_step.py):
    (t, slot) [N], unwritten past them on a card, a miss on the CPU."""
    device = org.x.device
    if bricks.device != device:
        raise ValueError(f"bricks on {bricks.device}, rays on {device}")
    if device.type == "cuda":
        return trace_bricks_cuda(bricks, *org, *dirn, tnear, ctl)
    if device.type != "cpu":
        raise ValueError(f"no brick trace for device {device}")
    n = int(org.x.numel())
    m = min(int(ctl[wave_step.COUNT]), n)
    t = torch.full((n,), INF, dtype=torch.float32)
    slot = torch.full((n,), -1, dtype=torch.int32)
    head = lambda v: Vec3(*(c[:m] for c in v))
    t[:m], slot[:m] = trace_bricks_plain(bricks, head(org), head(dirn), tnear)
    return t, slot


# -- kernel B4 on the card ----------------------------------------------------

def load_slim2_library() -> ctypes.CDLL:
    """Build (if needed) csrc/brick_trace_slim2.cu (kernel B4) and load it,
    once per process.  Raises if nvcc is missing or the build fails."""
    global _slim2_lib
    if _slim2_lib is None:
        lib = cuda_build.load(SLIM2_SOURCE, BUILD_DIR)
        fn = lib.pt_brick_trace_slim2_launch
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,   # ox oy oz dx dy dz
                       i32, ctypes.c_float,            # n, tnear
                       ptr, ptr, ptr,                  # nodes, tris, gates
                       ptr, ptr,                       # out_t, out_slot
                       ptr]                            # stream
        fn.restype = ctypes.c_int
        _slim2_lib = lib
    return _slim2_lib


def trace_bricks_slim2_cuda(bricks: BrickSet, ox: torch.Tensor,
                            oy: torch.Tensor, oz: torch.Tensor,
                            dx: torch.Tensor, dy: torch.Tensor,
                            dz: torch.Tensor, tnear: float):
    """Launch kernel B4 on the current stream: ``trace_bricks_cuda``'s
    contract and output, through B2's walk over the set's walk table with
    every leaf deferred by one, the found leaf's gates put on their way
    before the pending leaf is tested.  Adds one to
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
    nodes, tris, gates = walk_pointers(bricks)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.pt_brick_trace_slim2_launch(
            ox.data_ptr(), oy.data_ptr(), oz.data_ptr(), dx.data_ptr(),
            dy.data_ptr(), dz.data_ptr(), n, float(tnear), nodes, tris,
            gates, out_t.data_ptr(), out_slot.data_ptr(), stream)
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


# -- the primary wave's layout ---------------------------------------------------

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


# -- the wave loop -----------------------------------------------------------

# one block of 32 x 128 slots: the granule a slot map is cut in and the
# smallest capacity class of the counted schedule
BLOCK_SLOTS = 32 * LANES
# secondary waves a captured group runs between two host reads
GROUP_WAVES = 4
# the wrappers whose launches a counted graph holds: B2, W1-W3, the drain
GRAPH_KERNELS = (trace_bricks_cuda, wave_step.wave_record_cuda,
                 wave_step.wave_shade_cuda, wave_step.wave_sort_key_cuda,
                 wave_step.wave_drain_cuda)


def _drains(live: int, depth: int, lanes: int, rr_start_depth: int) -> bool:
    """Whether a read of the counted schedule that finds ``live`` paths
    before the wave at depth ``depth`` replays the drain rather than the
    next group, on a card that holds ``lanes`` of the drain's threads at
    once (0: no drain), under a roulette from past ``rr_start_depth``.

    A group replays GROUP_WAVES waves over a class at least as wide as
    ``live``: each a walk level of every path, a sort, a gather and a
    class-wide launch of B2.  The drain carries the paths in rounds of its
    resident lanes, refilled as paths end, each round a walk level as each
    wave is.  It drains where

    * ``live`` fits GROUP_WAVES rounds of the lanes: the drain does a
      group's work without the class's launches, sorts and gathers, and
      without the reads after it; or
    * the group would run a wave past ``rr_start_depth``: from there each
      bounce ends a path with probability at least a half, so the group's
      later waves run at the class's width with at most a half, a quarter,
      an eighth of its first wave's rays."""
    return lanes > 0 and (live <= GROUP_WAVES * lanes
                          or depth + GROUP_WAVES - 1 > rr_start_depth)


class WaveEngine(NamedTuple):
    """What a chunk's waves run, and in which schedule (``wave_engine``)."""
    tracers: tuple      # the trace of the waves at depth 0 .. max_depth - 1
    record: Callable    # (scene, *hit, org, dirn, tnear) -> [16, N]
    steps: WaveSteps
    lights: bool        # a point light is sampled: NEE's shadow waves
    counted: bool       # the counted schedule, else the uncounted one
    graphed: bool       # the counted schedule replayed from CUDA graphs


def wave_engine(kept: bool, tracers, record, steps: WaveSteps, lights: bool,
                device) -> WaveEngine:
    """The engine of a frame's waves and its schedule, chosen from what the
    loop sees: counted where the caller keeps the chunks from frame to
    frame (``kept``), every depth's trace is kernel B2 (``trace_wave_slim``),
    the bounce step is ``STEPS`` and no light is sampled, and then graphed
    on a card; uncounted everywhere else."""
    tracers = tuple(tracers)
    counted = (kept and steps is STEPS and not lights
               and all(t is trace_wave_slim for t in tracers))
    return WaveEngine(tracers, record, steps, lights, counted,
                      counted and torch.device(device).type == "cuda")


def _classes(capacity: int) -> list:
    """The capacity classes of a chunk of ``capacity`` camera rays: halvings
    from it down to BLOCK_SLOTS."""
    out = [capacity]
    while out[-1] > BLOCK_SLOTS:
        out.append(max(BLOCK_SLOTS, -(-out[-1] // 2)))
    return out


def _chunks(n_slots: int, num_samples: int, max_rays: int):
    """(first slot, slots, first sample, samples) of each chunk of a frame:
    at most ``max_rays`` slots a wave, whole samples, and a slot map longer
    than the cap cut in runs of whole 32 x 128-slot blocks."""
    slice_len = max(n_slots, 1)
    if n_slots > max_rays:
        slice_len = max(BLOCK_SLOTS, max_rays // BLOCK_SLOTS * BLOCK_SLOTS)
    for s0 in range(0, n_slots, slice_len):
        n = min(slice_len, n_slots - s0)
        chunk = max(1, max_rays // n)
        done = 0
        while done < num_samples:
            ns = min(chunk, num_samples - done)
            yield s0, n, done, ns
            done += ns


class _ChunkWaves:
    """One chunk shape of a frame and its wave loop: the kept (pixel,
    sample) columns of its C camera rays, the camera and first sample they
    read (``_camera_rays``), the radiance buffer, the scene's constants and
    the waves' engine (``WaveEngine``), on the scene's device.  The waves
    run in one of two schedules, the same rays at the same depths with the
    same RNG streams, so images, waves and rays are the same bit for bit:

    * uncounted: each wave is the live rays alone.  W3 keys the last wave's
      table (INT32_MAX for an ended ray), one stable sort orders the live
      rays ahead of the rest and one gather keeps them, their count the one
      host read a wave.  Any engine at each depth, and NEE's shadow waves.
    * counted: B2 and W1-W3 over the first ``COUNT`` columns of a table of
      C columns (``carry``), with its keys and the control block
      (ops/wave_step.py) at fixed addresses; the tally moves the counts on
      from wave to wave.  A group of GROUP_WAVES waves runs at the smallest
      capacity class (``_classes``) that holds the columns the last wave
      wrote, sorted as the uncounted schedule sorts, and the host reads the
      control block once a group.  At a read where ``_drains`` says so
      the drain (ops/wave_step.py::drain_counted) carries every live path
      to its end in one launch instead.  On a card ``drain_lanes`` is the
      drain's resident lanes, and the primary wave, the group of each
      class some read that does not drain can pick and the drain are CUDA
      graphs captured at build (``_capture``); on the CPU the steps run
      eagerly and ``drain_lanes`` is 0, so nothing drains, unless a caller
      sets it.  ``replays`` counts the replays of the primary wave, of
      groups and of the drain (on the CPU, the runs of their steps),
      ``drained`` the waves and rays the drain took over."""

    def __init__(self, slots, num_samples: int, engine: WaveEngine, scene,
                 cam_data, width: int, height: int, seed: int,
                 max_depth: int, rr_start_depth: int, sort_mode: str, lo, hi,
                 pool=None):
        dev = cam_data.device
        R = width * height
        # an upload from host memory, and a boolean gather's count, wait
        # for the card's queue
        read = span("frame.read") if dev.type != "cpu" else NOOP
        with read:
            slots = slots.to(dev)
        cols = torch.stack((slots.repeat(num_samples), torch.arange(
            num_samples, dtype=torch.int32,
            device=dev).repeat_interleave(slots.numel())))
        with read:                       # padding slots never become rays
            self.pix, self.samp = cols[:, cols[0] < R]
        self.engine, self.scene = engine, scene
        self.width, self.height = width, height
        self.seed, self.max_depth = seed, max_depth
        self.rr_start_depth, self.sort_mode = rr_start_depth, sort_mode
        self.capacity = C = int(self.pix.numel())
        self.cam = cam_data.clone()
        self.first_sample = torch.zeros(1, dtype=torch.int32, device=dev)
        self.out = torch.zeros((num_samples, R, 3), dtype=torch.float32,
                               device=dev)
        self.bg = torch.stack([scene.bg_r, scene.bg_g,
                               scene.bg_b]).to(torch.float32)
        self.lo = lo.to(torch.float32).contiguous()
        self.inv_extent = 1.0 / torch.clamp_min(hi - lo, 1e-12)
        self.coarse = getattr(scene, "coarse_boxes", None)
        self.light_rows = (torch.cat([scene.light_pos, scene.light_intensity],
                                     dim=1) if engine.lights else None)
        self.graphs = None
        self.launches = {}
        self.replays = {"primary": 0, "group": 0, "drain": 0}
        self.drained = {"waves": 0, "rays": 0}
        if engine.counted:
            self.classes = _classes(C)
            self.ctl = wave_step.new_control(dev)
            self.ctl_start = wave_step.new_control(dev)
            self.ctl_start[wave_step.COUNT] = C
            self.carry = torch.zeros((wave_step.TABLE_ROWS, C),
                                     dtype=torch.float32, device=dev)
            self.key = torch.empty(C, dtype=torch.int32, device=dev)
            self.drain_lanes = (wave_step.drain_lanes(dev)
                                if dev.type == "cuda" else 0)
        if engine.graphed and C:
            self._capture(pool)

    def _camera_rays(self) -> torch.Tensor:
        """The ray table of the camera rays of ``cam`` from sample
        ``first_sample`` on: the sample index modulo 2^32 as int32 bits (the
        JAX uint32), two jitter draws, the primary rays."""
        state = rng.seed_rays(self.pix, self.samp + self.first_sample,
                              self.seed)
        state, u1 = rng.next_uniform(state)
        state, u2 = rng.next_uniform(state)
        i = (self.pix % self.width).to(torch.float32)
        j = (self.pix // self.width).to(torch.float32)
        org, dirn = generate_primary_rays(self.cam, (i + u1) / self.width,
                                          (j + u2) / self.height)
        return wave_step.make_table(org, dirn, state, self.pix, self.samp)

    def render(self, cam_data: torch.Tensor, sample_start: int,
               stats: dict) -> torch.Tensor:
        """Radiance [num_samples, H*W, 3] of samples sample_start .. +
        num_samples, each (sample, pixel) written once; adds the waves and
        rays traced (shadow waves too) to ``stats`` and the counters."""
        if not self.capacity:
            return self.out
        schedule = self._counted if self.engine.counted else self._uncounted
        waves, rays = schedule(cam_data, sample_start)
        for name, n in (("waves", waves), ("rays", rays)):
            stats[name] = stats.get(name, 0) + n
            count(name, n)
        return self.out

    # -- the uncounted schedule ----------------------------------------------

    def _uncounted(self, cam_data, sample_start: int) -> tuple:
        """The waves, each exactly the live rays: (waves, rays) traced."""
        engine, steps = self.engine, self.engine.steps
        with span("frame.rays"):
            self.cam.copy_(cam_data)
            self.first_sample.fill_(rng._as_i32(sample_start))
            self.out.zero_()
            table = self._camera_rays()
        traced = [0, 0]

        def trace(o, d, tnear):
            traced[0] += 1
            traced[1] += int(o.x.numel())
            return tracer(self.scene, o, d, tnear)

        n, depth = self.capacity, 0
        while n:
            if depth:
                with span("wavefront.sort"):
                    key = steps.key(table, self.sort_mode, self.lo,
                                    self.inv_extent, self.coarse)
                    perm = torch.sort(key, stable=True).indices[:n]
                    table = table.index_select(1, perm)
            tracer = engine.tracers[depth]
            tnear = 0.0 if depth == 0 else SECONDARY_TNEAR
            org = wave_step.rows3(table, wave_step.ORG)
            dirn = wave_step.rows3(table, wave_step.DIR)
            with span("wavefront.trace"):
                hit = trace(org, dirn, tnear)
            with span("wavefront.shade"):
                rec = engine.record(self.scene, *hit, org, dirn, tnear)
                if isinstance(rec, tuple):
                    rec = torch.stack(rec)
                shadow_t = (self._shadow_waves(rec, trace)
                            if engine.lights else None)
                table = steps.shade(table, rec, depth, self.bg,
                                    self.rr_start_depth, self.max_depth,
                                    self.out, self.light_rows, shadow_t,
                                    self.scene.sph_rows,
                                    self.scene.num_spheres)
            depth += 1
            with span("wavefront.count"):
                live = torch.count_nonzero(table[wave_step.LIVE])
                with span("frame.read"):
                    # the one explicit host read a wave: the next wave's size
                    n = int(live)
        return tuple(traced)

    def _shadow_waves(self, rec: torch.Tensor, trace) -> torch.Tensor:
        """The [L, N] closest triangle hit of each ray's shadow ray toward
        each light (inf where the ray hit nothing, and so cast none): one
        shadow wave per light through ``trace(org, dirn, tnear)``, over the
        rays that hit, gathered by ``torch.nonzero``."""
        n_lights, n = int(self.light_rows.shape[0]), int(rec.shape[1])
        sdir = self.engine.steps.shadow_rays(rec, self.light_rows)
        ts = torch.full((n_lights, n), INF, dtype=torch.float32,
                        device=rec.device)
        with span("frame.read"):
            idx = torch.nonzero(rec[0] < INF).reshape(-1)
        if idx.numel():
            so = Vec3(rec[4][idx], rec[5][idx], rec[6][idx])
            for l in range(n_lights):
                sd = Vec3(*(sdir[l, k][idx] for k in range(3)))
                ts[l, idx] = trace(so, sd, SECONDARY_TNEAR)[0]
        return ts

    # -- the counted schedule ------------------------------------------------

    def _wave(self, table: torch.Tensor, tnear: float) -> None:
        c = int(table.shape[1])
        org = wave_step.rows3(table, wave_step.ORG)
        dirn = wave_step.rows3(table, wave_step.DIR)
        t, slot = trace_wave_counted(self.scene, org, dirn, tnear, self.ctl)
        rec = wave_step.record_counted(self.scene, t, slot, org, dirn, tnear,
                                       self.ctl)
        carry = self.carry[:, :c]
        wave_step.shade_counted(table, carry, rec, self.ctl, self.bg,
                                self.rr_start_depth, self.max_depth, self.out)
        wave_step.key_counted(carry, self.sort_mode, self.lo, self.inv_extent,
                              self.coarse, self.ctl, self.key[:c])
        wave_step.tally(self.ctl)

    def _primary(self) -> None:
        """The camera rays and their wave (depth 0)."""
        self.ctl.copy_(self.ctl_start)
        self.out.zero_()
        self._wave(self._camera_rays(), 0.0)

    def _group(self, c: int) -> None:
        """GROUP_WAVES secondary waves at capacity class ``c``."""
        for _ in range(GROUP_WAVES):
            perm = torch.sort(self.key[:c], stable=True).indices
            self._wave(self.carry[:, :c].index_select(1, perm),
                       SECONDARY_TNEAR)

    def _drain(self) -> None:
        """Every live path of ``carry`` carried to its end."""
        wave_step.drain_counted(self.scene, self.carry, self.ctl, self.bg,
                                self.rr_start_depth, self.max_depth,
                                self.out, self.drain_lanes)

    def _steps(self) -> dict:
        """The steps of each graph by name: the primary wave, the group of
        each class some read that does not drain can pick, and the drain.
        A read picks the smallest class that holds the columns the last
        wave wrote, at least its live paths: the first read (depth 1) all
        C columns of the primary wave, a later one (depth 1 + GROUP_WAVES
        on, where ``_drains`` drains at least as often) those of a wave.
        So a class of c columns is picked only where c live paths would
        not drain at the first depth that can pick it."""
        lanes, rr = self.drain_lanes, self.rr_start_depth
        return {"primary": self._primary,
                **{c: functools.partial(self._group, c)
                   for i, c in enumerate(self.classes)
                   if not _drains(c, 1 if i == 0 else 1 + GROUP_WAVES,
                                  lanes, rr)},
                "drain": self._drain}

    def _capture(self, pool) -> None:
        """Run every step once on a side stream (kernel libraries, lazy
        module loads, the sort's scratch), then capture each into a CUDA
        graph sharing ``pool``.  Every tensor a graph hands to another is
        one of the fixed buffers above, so the graphs may replay in any
        order.  A capture launches nothing: what GRAPH_KERNELS' wrappers
        count during it becomes the graph's own (``launches``, {graph: [B2,
        W1, W2, W3, drain]}), added to theirs at each replay."""
        dev = self.carry.device
        fns = self._steps()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graphs = {}
        with torch.cuda.device(dev), torch.cuda.stream(side):
            for fn in fns.values():
                fn()
            for name, fn in fns.items():
                before = [w.launches for w in GRAPH_KERNELS]
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    fn()
                finally:
                    graph.capture_end()
                graphs[name] = graph
                self.launches[name] = [w.launches - b for w, b in
                                       zip(GRAPH_KERNELS, before)]
                for w, b in zip(GRAPH_KERNELS, before):
                    w.launches = b
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graphs = graphs

    def _run(self, name) -> None:
        """Replay graph ``name`` ("primary", a class or "drain"), or on the
        CPU run its steps."""
        with span("wavefront.replay"):
            if self.graphs is not None:
                self.graphs[name].replay()
                for w, n in zip(GRAPH_KERNELS, self.launches[name]):
                    w.launches += n
            else:
                self._steps()[name]()
        self.replays[name if name in ("primary", "drain") else "group"] += 1

    def _counted(self, cam_data, sample_start: int) -> tuple:
        """The primary wave, then a group or the drain after each read of
        the control block until no ray is live: (waves, rays) traced; adds
        the port's counters "drain_rays" (the rays the drain traced) and
        "graph_waves"."""
        with span("frame.rays"):
            self.cam.copy_(cam_data)
            self.first_sample.fill_(rng._as_i32(sample_start))
        self._run("primary")
        before_drain = None
        while True:
            with span("frame.read"):
                ctl = self.ctl.tolist()
            live = ctl[wave_step.COUNT]
            if not live:
                break
            if _drains(live, ctl[wave_step.DEPTH], self.drain_lanes,
                       self.rr_start_depth):
                before_drain = ctl
                self._run("drain")
                continue
            valid = ctl[wave_step.VALID]
            self._run(min(c for c in self.classes if c >= valid))
        waves, rays = ctl[wave_step.WAVES], ctl[wave_step.RAYS]
        before = before_drain or ctl            # no drain: nothing drained
        self.drained["waves"] += waves - before[wave_step.WAVES]
        self.drained["rays"] += rays - before[wave_step.RAYS]
        count("drain_rays", rays - before[wave_step.RAYS])
        if self.graphs is not None:
            count("graph_waves", waves)
        return waves, rays


class WaveCache:
    """The chunks of a frame's wave loop (``_ChunkWaves``, one a chunk
    shape), kept from frame to frame by the caller that owns the scene
    (``ProgressiveRenderer``).  A frame with another key (scene, size, slot
    map, samples, seed, depths, sort mode or engine) drops every chunk and
    builds anew; a camera move only rewrites a chunk's camera tensor."""

    def __init__(self):
        self._key = None
        self._slots = None
        self._chunks = {}
        self._pool = None

    def begin(self, scene, width: int, height: int, pix_slots,
              num_samples: int, seed: int, max_depth: int,
              rr_start_depth: int, sort_mode: str,
              engine: WaveEngine) -> torch.Tensor:
        """Start a frame: keep the chunks if its key is the last one's,
        else drop them.  Returns the frame's slot map, int32 on the CPU."""
        if pix_slots is not None:
            pix_slots = torch.as_tensor(pix_slots)
            on_card = pix_slots.device.type != "cpu"
            with span("frame.read") if on_card else NOOP:
                pix_slots = pix_slots.to("cpu", torch.int32)
        key = (width, height, num_samples, seed, max_depth, rr_start_depth,
               sort_mode, engine)
        if not self._same(scene, key, pix_slots):
            self._key = (scene, key, pix_slots)
            self._chunks = {}
            self._pool = None
            self._slots = (pix_slots if pix_slots is not None else
                           torch.from_numpy(_wave_layout(width, height)[0]))
        return self._slots

    def _same(self, scene, key: tuple, pix_slots) -> bool:
        if self._key is None:
            return False
        old_scene, old_key, old_slots = self._key
        if old_scene is not scene or old_key != key:
            return False
        if pix_slots is None or old_slots is None:
            return pix_slots is old_slots
        return torch.equal(pix_slots, old_slots)

    def replays(self) -> dict:
        """{"primary": n, "group": m, "drain": k}: the graphs replayed by
        the chunks built since the frame key last changed."""
        return {kind: sum(c.replays[kind] for c in self._chunks.values())
                for kind in ("primary", "group", "drain")}

    def drained(self) -> dict:
        """{"waves": n, "rays": m}: what the drains of those chunks took
        over from the groups."""
        return {kind: sum(c.drained[kind] for c in self._chunks.values())
                for kind in ("waves", "rays")}

    def chunk(self, slots, s0: int, num_samples: int, engine: WaveEngine,
              *args) -> _ChunkWaves:
        """The chunk of ``slots`` (from slot ``s0`` of ``begin``'s slot map)
        and ``num_samples`` samples, built (and captured) at its first use
        from ``_ChunkWaves``' other arguments ``engine`` and ``args``."""
        name = (s0, int(slots.numel()), num_samples)
        if name not in self._chunks:
            if self._pool is None and engine.graphed:
                self._pool = torch.cuda.graph_pool_handle()
            self._chunks[name] = _ChunkWaves(slots, num_samples, engine,
                                             *args, pool=self._pool)
        return self._chunks[name]


def render_waves(scene, cam_data: torch.Tensor, width: int, height: int,
                 sample_start: int, num_samples: int, seed: int,
                 max_depth: int, rr_start_depth: int, sort_mode: str,
                 nee: bool, lo, hi, tracers, record, stats=None,
                 max_rays: int = MAX_RAYS_PER_WAVE, pix_slots=None,
                 num_real=None, steps: WaveSteps = STEPS,
                 cache: WaveCache | None = None) -> torch.Tensor:
    """The wave loop under ``render_samples_wavefront`` and the experiments'
    ``render_samples_mx`` / ``render_samples_mx2``: the radiance SUM of
    ``num_samples`` passes, [H, W, 3], over ``scene`` (a BrickSet or one of
    the experiments' sets: anything with ``sph_rows``, ``num_spheres`` and
    the lights, and ``coarse_boxes`` for the "sig_mort" key), whose box
    ``lo`` .. ``hi`` normalizes the sort keys.  ``tracers[depth]``, the
    engine of the waves at each depth below ``max_depth``, is
    ``tracer(scene, org, dirn, tnear)`` and returns a wave's closest hits
    as a tuple whose first entry is t; ``record(scene, *hit, org, dirn,
    tnear)`` makes their 16-channel record ([16, N] or 16 [N] tensors), and
    ``steps`` (ops/wave_step.py) shade the rays into a new table, write the
    radiance of the paths that ended and key the next wave.

    Each chunk of the frame is a ``_ChunkWaves`` of ``cache``, a
    ``WaveCache`` that a caller rendering frame after frame keeps; its
    waves run in the schedule ``wave_engine`` picks.  A call without a
    ``cache`` builds its chunks for itself alone, and runs them uncounted.

    ``pix_slots`` (int32, any device) is the slot -> pixel map to render,
    padding slots holding pixel id ``width*height``; None renders the whole
    frame's map (``_wave_layout``), and a tile split across devices passes
    each its own slice.  ``num_real`` (None: all) renders only the first
    ``min(num_real, num_samples)`` passes from ``sample_start``, which gives
    each ray the result of the JAX package's masked passes.  At most
    ``max_rays`` rays go into a wave: sample batches beyond it render in
    chunks of whole samples, and a frame whose single-sample wave already
    exceeds the cap is also cut along its slots, in runs of whole 32 x
    128-slot blocks, whose images add.  ``stats``, a dict, gets the waves
    ("waves") and rays ("rays") traced added to it."""
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
    if num_real is not None:
        num_samples = max(0, min(num_real, num_samples))
    engine = wave_engine(cache is not None, tracers, record, steps,
                         nee and int(scene.light_pos.shape[0]) > 0, dev)
    cache = cache or WaveCache()
    with span("frame.layout"):
        pix_slots = cache.begin(scene, width, height, pix_slots, num_samples,
                                seed, max_depth, rr_start_depth, sort_mode,
                                engine)
        acc = torch.zeros((height, width, 3), dtype=torch.float32,
                          device=dev)

    for s0, n, done, ns in _chunks(int(pix_slots.numel()), num_samples,
                                   max_rays):
        out = cache.chunk(
            pix_slots[s0:s0 + n], s0, ns, engine, scene, cam_data, width,
            height, seed, max_depth, rr_start_depth, sort_mode, lo, hi,
        ).render(cam_data, sample_start + done, stats)
        with span("frame.sum"):
            acc += out.sum(dim=0).reshape(height, width, 3)
    return acc


def _depth_tracers(trace: str, tail_trace: str, compact_tail: int,
                   sort_mode: str, max_depth: int, tracer=None) -> tuple:
    """The trace of the waves at each depth below ``max_depth``: ``tracer``
    or engine ``trace``'s, from depth 2 on engine ``tail_trace``'s ("":
    the same) while the ladder is on (``compact_tail > 0``, a sort)."""
    engine = engine_tracer(trace)
    if compact_tail < 0:
        raise ValueError("need compact_tail >= 0")
    first = tracer or engine
    tail = engine_tracer(tail_trace) if tail_trace else first
    ladder = compact_tail > 0 and sort_mode != "none"
    return tuple(tail if ladder and depth >= 2 else first
                 for depth in range(max_depth))


def render_samples_wavefront(brickset: BrickSet, cam_data: torch.Tensor,
                             width: int, height: int, sample_start: int,
                             num_samples: int = 1, seed: int = 1984,
                             max_depth: int = MAX_DEPTH,
                             rr_start_depth: int = RR_START_DEPTH,
                             sort_mode: str = "sig_mort", nee: bool = False,
                             trace: str = "slim", tracer=None,
                             stats=None, pix_slots=None,
                             num_real=None, compact_tail: int = 8,
                             tail_trace: str = "",
                             steps: WaveSteps = STEPS,
                             wave_cache: WaveCache | None = None
                             ) -> torch.Tensor:
    """Large-scene drop-in for ops.integrator.render_samples: the radiance
    SUM of ``num_samples`` passes, [H, W, 3], on ``cam_data``'s device.

    ``trace`` names the engine of the closest-hit and shadow waves
    (``parse_engine``: "slim", kernel B2, "slim2", B4, "pairs[N]", B5) and
    ``tail_trace`` that of the waves from depth 2 on while the JAX
    package's compaction ladder is on (``_depth_tracers``; any
    ``compact_tail > 0`` gives the same image).  ``sort_mode`` picks the
    inter-wave key ("sig_mort", "mort_oct" or "none").  ``tracer(bricks,
    org, dirn, tnear) -> (t, slot)`` replaces ``trace``'s per-wave trace,
    and ``steps`` the bounce step's kernels (the chip smoke passes plain
    versions to hold the kernels to them); ``stats``, ``pix_slots`` and
    ``num_real`` are ``render_waves``'.  ``wave_cache``, the wave loop's
    state that a caller rendering frame after frame keeps
    (``ProgressiveRenderer`` does), runs the waves counted where
    ``wave_engine`` says so, the same image bit for bit."""
    tracers = _depth_tracers(trace, tail_trace, compact_tail, sort_mode,
                             max_depth, tracer)
    # scene box = the top tree's root node
    root = brickset.top_boxes[0, :6]
    return render_waves(brickset, cam_data, width, height, sample_start,
                        num_samples, seed, max_depth, rr_start_depth,
                        sort_mode, nee, root[:3], root[3:], tracers,
                        steps.record, stats, pix_slots=pix_slots,
                        num_real=num_real, steps=steps, cache=wave_cache)
