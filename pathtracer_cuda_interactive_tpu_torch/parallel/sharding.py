"""The tile and sample split of a render across devices, over
``torch.distributed``.

The port of ``pathtracer_cuda_interactive_tpu/parallel/sharding.py``.  The
JAX package lays its devices out as a ``(samples, tiles)`` mesh and renders
under ``shard_map``; here every device is one process (a rank of the
default process group) and the mesh is a plain description of where this
rank sits in that grid:

  * ``tiles``   — ranks of one sample shard split the image's pixels, each
                  renders its own part and nothing else;
  * ``samples`` — ranks of one tile split the sample passes; their partial
                  sums add up.

Every rank holds the whole scene (``replicate_scene``).  A rank renders on
the device of the ``cam_data`` it is given: a card of its own under
``nccl``, a card under ``gloo`` with CUDA tensors (several ranks may share
one), the CPU under ``gloo``.  It writes its part into a zero ``[H, W, 3]``
image, and one ``all_reduce(SUM)`` over the world gives every rank the
whole image: the sample shards' sums add, and the tile shards' parts are
disjoint.  The image stays on the rank's device; only ``gloo`` itself
stages a CUDA tensor through host memory inside the collective.

The sample rule is the JAX package's: each sample shard runs
``ceil(S / n_s)`` passes from ``sample_start + s_idx * ceil(S / n_s)``
(modulo 2^32, the JAX uint32), of which only the first
``clip(S - s_idx * ceil(S / n_s), 0, ceil(S / n_s))`` count, so the sum
holds exactly ``S`` passes.  The port renders only the passes that count;
each ray's result is that of the JAX package's masked passes.

A process group is the caller's: ``torchrun --nproc_per_node N`` (or
``init_process_group`` with an address, a world size and a rank) before
``make_mesh``.  Without one, ``make_mesh()`` is a mesh of one rank.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..experiments.mx2 import render_samples_mx2
from ..experiments.mxtrace import render_samples_mx
from ..ops.brickkernel import render_tiles_bricks, tile_grid
from ..ops.integrator import MAX_DEPTH, RR_START_DEPTH, render_pixel_sums
from ..ops.megakernel import render_pixels_megakernel
from ..ops.wavefront import (WAVE_ROWS, WaveCache, _wave_layout,
                             render_samples_wavefront)

TILE_AXIS = "tiles"
SAMPLE_AXIS = "samples"
LANES = 128
MODES = ("xla", "plain", "megakernel", "bricks", "wavefront", "mx", "mx2")


@dataclass(frozen=True)
class Mesh:
    """Where this rank sits in the ``(samples, tiles)`` grid of ranks.

    Rank ``r`` is sample shard ``r // n_tiles`` and tile shard
    ``r % n_tiles``: the JAX ``reshape(sample_parallel, n //
    sample_parallel)`` of the device list.  ``collective`` is True when the
    mesh spans the default process group (its results are all-reduced over
    it); a mesh of one rank outside a group does no collective.  ``device``
    is where ``replicate_scene`` and ``shard_grid_inputs`` put tensors."""

    world_size: int
    rank: int
    n_samples: int
    n_tiles: int
    device: torch.device
    collective: bool

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as the JAX ``Mesh.shape``."""
        return {SAMPLE_AXIS: self.n_samples, TILE_AXIS: self.n_tiles}

    @property
    def s_idx(self) -> int:
        return self.rank // self.n_tiles

    @property
    def t_idx(self) -> int:
        return self.rank % self.n_tiles

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` in place over every rank of the mesh and return it."""
        if self.collective:
            dist.all_reduce(x, op=dist.ReduceOp.SUM)
        elif self.world_size > 1:
            raise RuntimeError(f"a mesh of {self.world_size} ranks needs an "
                               "initialised process group")
        return x


def _default_device(rank: int) -> torch.device:
    """A rank's card: ``cuda:<rank mod cards>``.  Raises without CUDA: an
    entry point runs on the CPU only when asked to."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to render on "
                           "the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_mesh(world_size=None, sample_parallel: int = 1,
              device=None) -> Mesh:
    """The ``(samples, tiles)`` mesh: ``sample_parallel`` ranks share each
    tile and split its samples, the rest split the tiles.  ``world_size``
    defaults to the default process group's size (1 without a group).  A
    ``world_size`` of 1 inside a larger group is a mesh of this rank alone,
    with no collective.  ``device`` defaults to this rank's card.  Raises
    ValueError when ``sample_parallel`` does not divide the world size, and
    when ``world_size`` is neither 1 nor the group's size (a mesh of
    several ranks needs a process group of that size)."""
    initialised = dist.is_available() and dist.is_initialized()
    group_size = dist.get_world_size() if initialised else 1
    n = group_size if world_size is None else int(world_size)
    if sample_parallel < 1 or n % sample_parallel:
        raise ValueError(f"{n} ranks not divisible by "
                         f"sample_parallel={sample_parallel}")
    if initialised and n == group_size:
        rank, collective = dist.get_rank(), True
    elif n == 1:
        rank, collective = 0, False
    else:
        raise ValueError(f"a mesh of {n} ranks in a process group of "
                         f"{group_size if initialised else 'none'}")
    device = _default_device(rank) if device is None \
        else torch.device(device)
    return Mesh(n, rank, sample_parallel, n // sample_parallel, device,
                collective)


def replicate_scene(scene, mesh: Mesh):
    """The whole scene on this rank's device — the analog of the
    reference's GPUScene::copyFrom (scene.h:73-142) on every rank.  Any of
    the package's sets (DeviceScene, BrickSet, MXSet, MX2Set)."""
    return scene.to(mesh.device)


def _padded_grid(width: int, height: int, n_tiles: int):
    """Flat pixel grid [rows, LANES] (numpy int32) padded so that the rows
    divide ``n_tiles``; pixel ids from ``width*height`` on are padding."""
    R = width * height
    rows = -(-R // LANES)
    rows = -(-rows // n_tiles) * n_tiles
    pix = np.arange(rows * LANES, dtype=np.int32).reshape(rows, LANES)
    return pix, rows


def _sample_shard(mesh: Mesh, sample_start: int, num_samples: int):
    """(local_start, ns_local, num_real) of this rank's sample shard."""
    ns_local = -(-num_samples // mesh.n_samples)
    local_start = (sample_start + mesh.s_idx * ns_local) & 0xFFFFFFFF
    num_real = min(max(num_samples - mesh.s_idx * ns_local, 0), ns_local)
    return local_start, ns_local, num_real


def _split(total: int, mesh: Mesh):
    """(first, count) of this rank's run of ``total`` items split in
    ``n_tiles`` runs of ``ceil(total / n_tiles)``, the last ones short or
    empty."""
    per = -(-total // mesh.n_tiles)
    first = min(mesh.t_idx * per, total)
    return first, min(per, total - first)


def _tile_slots(width: int, height: int, mesh: Mesh) -> torch.Tensor:
    """This rank's part of the wave paths' slot map: whole blocks of
    WAVE_ROWS x 128 slots, the map padded with pixel id ``width*height``
    to a multiple of ``n_tiles`` blocks (the JAX package's padding)."""
    slots, n_blocks = _wave_layout(width, height)
    per = -(-n_blocks // mesh.n_tiles)
    block = WAVE_ROWS * LANES
    mine = slots[mesh.t_idx * per * block:(mesh.t_idx + 1) * per * block]
    pad = np.full(per * block - mine.size, width * height, np.int32)
    return torch.from_numpy(np.concatenate([mine, pad]))


def render_samples_sharded(scene, cam_data: torch.Tensor, width: int,
                           height: int, sample_start: int, num_samples: int,
                           mesh: Mesh, seed: int = 1984,
                           max_depth: int = MAX_DEPTH, mode: str = "xla",
                           rr_start_depth: int = RR_START_DEPTH,
                           sort_mode=None, nee: bool = False,
                           trace: str = "slim", compact_tail: int = 8,
                           tail_trace: str = "",
                           wave_cache: WaveCache | None = None
                           ) -> torch.Tensor:
    """The [H, W, 3] radiance sum of EXACTLY ``num_samples`` passes from
    ``sample_start``, computed across the mesh; every rank returns the
    whole image, on ``cam_data``'s device.

    ``mode`` picks the per-rank compute path, the JAX package's names:
      * "xla" (or the renderer's "plain") — the plain integrator
        (DeviceScene) on this rank's rows of ``_padded_grid``;
      * "megakernel" — kernel B1 (DeviceScene, small) on a pixel range;
      * "bricks"     — kernel B6 (BrickSet) on a range of 64x32 tiles;
        with ``nee`` it takes "wavefront" (B6 has no NEE);
      * "wavefront"  — the sorted wavefront (BrickSet), engine ``trace``
        (B2 "slim", B4 "slim2", B5 "pairs[N]"), and from depth 2 on
        ``tail_trace`` while ``compact_tail > 0`` (the JAX package's
        compaction ladder, ops/wavefront.py::render_waves);
      * "mx"         — the Plucker-matmul rounds (MXSet; torch ops);
      * "mx2"        — kernel B7 (MX2Set).
    The wave paths ("wavefront", "mx", "mx2") render this rank's blocks of
    the slot map.  ``sort_mode`` None takes each path's default
    ("sig_mort" for the wavefront, "mort_oct" for "mx" and "mx2", whose sets
    have no signature boxes; there "sig_mort" also sorts by "mort_oct", as
    the JAX package's "mx" paths do).  CUDA tensors launch the kernels, CPU
    tensors run their plain versions.  ``wave_cache`` is the wave loop's
    state kept from frame to frame (``render_samples_wavefront``), which a
    caller that renders frame after frame keeps, one a rank."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    if mode == "bricks" and nee:
        mode = "wavefront"   # the persistent brick kernel has no NEE hook
    dev = cam_data.device
    if scene.device != dev:
        raise ValueError(f"scene on {scene.device}, camera on {dev}")
    local_start, ns_local, num_real = _sample_shard(mesh, sample_start,
                                                    num_samples)
    R = width * height
    out = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
    if mode in ("wavefront", "mx", "mx2"):
        slots = _tile_slots(width, height, mesh)
        if num_real:
            out = _render_wave_mode(scene, cam_data, width, height,
                                    local_start, ns_local, num_real, seed,
                                    max_depth, mode, rr_start_depth,
                                    sort_mode, nee, trace, slots,
                                    compact_tail, tail_trace, wave_cache)
    elif mode == "megakernel":
        pix0, count = _split(R, mesh)
        if count and num_real:
            part = render_pixels_megakernel(
                scene, cam_data, width, height, pix0, count, local_start,
                ns_local, seed, max_depth, rr_start_depth, nee, num_real)
            out.view(R, 3)[pix0:pix0 + count] = part
    elif mode == "bricks":
        tile0, n_tiles = _split(tile_grid(width, height), mesh)
        if n_tiles and num_real:
            out = render_tiles_bricks(scene, cam_data, width, height, tile0,
                                      n_tiles, local_start, ns_local, seed,
                                      max_depth, rr_start_depth, num_real)
    else:
        pix, rows = _padded_grid(width, height, mesh.n_tiles)
        per = rows // mesh.n_tiles
        mine = pix[mesh.t_idx * per:(mesh.t_idx + 1) * per].reshape(-1)
        mine = torch.from_numpy(mine[mine < R]).to(dev)
        if mine.numel() and num_real:
            acc = render_pixel_sums(scene, cam_data, mine, width, height,
                                    local_start, ns_local, seed, max_depth,
                                    nee, rr_start_depth, num_real)
            out.view(R, 3)[mine.long()] = acc
    return mesh.all_reduce(out)


def _render_wave_mode(scene, cam_data, width, height, local_start, ns_local,
                      num_real, seed, max_depth, mode, rr_start_depth,
                      sort_mode, nee, trace, slots, compact_tail,
                      tail_trace, wave_cache):
    """One rank's part of a wave path: its slots, its passes."""
    common = dict(pix_slots=slots, num_real=num_real)
    if mode == "wavefront":
        return render_samples_wavefront(
            scene, cam_data, width, height, local_start, ns_local, seed,
            max_depth, rr_start_depth, sort_mode or "sig_mort", nee, trace,
            compact_tail=compact_tail, tail_trace=tail_trace,
            wave_cache=wave_cache, **common)
    sort_mode = "mort_oct" if sort_mode in (None, "sig_mort") else sort_mode
    render = render_samples_mx if mode == "mx" else render_samples_mx2
    return render(scene, cam_data, width, height, local_start, ns_local,
                  seed, max_depth, rr_start_depth, sort_mode, nee, **common)


def effective_samples(num_samples: int, mesh: Mesh) -> int:
    """Samples in the sum render_samples_sharded returns: always
    ``num_samples`` (only the passes that count are rendered)."""
    del mesh
    return num_samples


def _sync(x: torch.Tensor) -> None:
    """Wait for ``x`` by reading it back (a device sync on a card)."""
    float(x.sum())


def scaling_report(scene, cam_data: torch.Tensor, mesh: Mesh,
                   width: int = 640, height: int = 480,
                   num_samples: int = 8, repeats: int = 3,
                   mode: str = "xla", **render_kwargs) -> dict:
    """Renders per second on one rank against the whole mesh, for any
    ``mode`` of render_samples_sharded.  Every rank must call it; every
    rank gets the same dict (each time is the slowest rank's):
    {n_devices, mode, speedup, efficiency, per_shard_overhead, one_ms,
    mesh_ms, shard_ms}, one device per rank.

    ``speedup`` is (renders/s of the mesh) / (renders/s of one rank
    rendering the whole frame alone); ``efficiency`` is it over the rank
    count.  ``per_shard_overhead`` is (renders/s of one rank rendering ONE
    shard's work alone: ``height / n_tiles`` rows at ``ceil(S / n_s)``
    samples) / (renders/s of the mesh): what the mesh costs above the work
    of a shard — the split, the zero image and the collective.  The three
    ``*_ms`` are the milliseconds per render behind them (the whole frame
    on one rank, the mesh, one shard's work on one rank).

    READING THE NUMBERS.  With one card per rank, each rank owns its
    device and ``per_shard_overhead`` reads directly as per-rank overhead.
    With ``gloo`` processes sharing one host's cores (the CPU tests), the N
    ranks time-slice the cores while the one-rank controls run alone, and
    torch's own threads already use every core for one render: there
    ``speedup`` near or below 1 and ``per_shard_overhead`` near N / cores
    or above are what contention gives, not what the split costs.  One
    card shared by several ``gloo`` ranks likewise time-slices them."""
    local = make_mesh(world_size=1, device=cam_data.device)

    def seconds(m, ns, h=height):
        """Seconds per render after one warm-up (which builds the
        wavefront's static state); a shard's rows render through the
        frame's camera (the same work, a squeezed view)."""
        kw = dict(render_kwargs, mode=mode, wave_cache=WaveCache())
        out = render_samples_sharded(scene, cam_data, width, h, 0, ns, m,
                                     **kw)
        _sync(out)
        t0 = time.perf_counter()
        acc = None
        for k in range(repeats):
            out = render_samples_sharded(scene, cam_data, width, h, k + 1,
                                         ns, m, **kw)
            acc = out if acc is None else acc + out
        _sync(acc)
        return (time.perf_counter() - t0) / repeats

    t1 = seconds(local, num_samples)
    t_n = seconds(mesh, num_samples)
    t_shard = seconds(local, max(1, -(-num_samples // mesh.n_samples)),
                   h=max(1, -(-height // mesh.n_tiles)))
    times = torch.tensor([t1, t_n, t_shard], dtype=torch.float64,
                         device=cam_data.device)
    if mesh.collective:
        dist.all_reduce(times, op=dist.ReduceOp.MAX)
    t1, t_n, t_shard = (float(t) for t in times.cpu())
    n = mesh.world_size
    return {"n_devices": n, "mode": mode, "speedup": t1 / t_n,
            "efficiency": t1 / t_n / n,
            "per_shard_overhead": t_n / t_shard, "one_ms": t1 * 1e3,
            "mesh_ms": t_n * 1e3, "shard_ms": t_shard * 1e3}
