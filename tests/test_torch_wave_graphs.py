"""The wave loop's two schedules (ops/wavefront.py::_ChunkWaves): the
counted one, which a kept ``WaveCache`` runs, against the uncounted one,
which a call without a cache runs, and the choice between them
(``wave_engine``).

On the CPU the counted schedule runs eagerly with the plain versions of
its counted steps (ops/wave_step.py::record_counted, ``shade_counted``,
``key_counted``, ``tally``; ``wavefront.trace_wave_counted``): the same
image bit for bit and the same waves and rays, through ``render_waves``
with and without a kept cache, in every sort mode and on a slice of the
slot map; a column at or past the live count keys to INT32_MAX whatever it
holds.  The choice: counted exactly where the cache is kept, kernel B2
traces every depth, the steps are ``STEPS`` and no light is sampled, and
graphed where, besides, the tensors are on a card.

The cases marked ``cuda`` skip without a card and import no jax, so on the
card this file runs with ``python -m pytest --noconftest -m cuda
tests/test_torch_wave_graphs.py``: the graph path against the uncounted
schedule bit for bit at 640x480 with 2 and 10 samples a frame (two
chunks), the drain engaged, in every sort mode and on a tile slice; each
kernel's launches against the graphs replayed (one wave a primary graph,
GROUP_WAVES a group, the drain's own launch a drain), and the waves traced
within them and the drain's; a renderer's state kept over camera moves and
rebuilt by ``set_samples_per_frame``, and no capture after a chunk shape's
first frame; the share of waves replayed from graphs, and none with NEE or
``slim2``; W3's counted keys and live count.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pathtracer_cuda_interactive_tpu_torch import SCENES_DIR
from pathtracer_cuda_interactive_tpu_torch.models.bricks import BrickSet
from pathtracer_cuda_interactive_tpu_torch.models.scenepack import load_scene
from pathtracer_cuda_interactive_tpu_torch.ops import wave_step, wavefront
from pathtracer_cuda_interactive_tpu_torch.ops.camera import (
    Camera, camera_ray_data)
from pathtracer_cuda_interactive_tpu_torch.render.renderer import (
    ProgressiveRenderer)
from pathtracer_cuda_interactive_tpu_torch.utils import trace
from pathtracer_cuda_interactive_tpu_torch.utils.config import RenderConfig

# several test workers at once: one intra-op thread per process
torch.set_num_threads(1)

BLOB_BOX = str(SCENES_DIR / "blob_box.xml")
INT32_MAX = wave_step.INT32_MAX


def _load(width, height, device="cpu"):
    pack, parsed = load_scene(BLOB_BOX)
    cam = Camera.from_parsed(parsed.camera)
    cd = torch.from_numpy(camera_ray_data(cam, width, height))
    return BrickSet.from_pack(pack).to(device), cam, cd.to(device)


def _fixed(bricks, cd, width, height, start, spp, sort_mode, stats,
           pix_slots=None, cache=None):
    """The frame through ``render_waves``, kernel B2 at every depth: with a
    kept ``cache`` the counted schedule (on the CPU the eager loop over the
    plain counted steps), without one the uncounted schedule."""
    root = bricks.top_boxes[0, :6]
    return wavefront.render_waves(
        bricks, cd, width, height, start, spp, 1984, 50, 5, sort_mode, False,
        root[:3], root[3:], (wavefront.trace_wave_slim,) * 50,
        wave_step.STEPS.record, stats=stats, pix_slots=pix_slots,
        cache=cache)


@pytest.fixture(scope="module")
def blob_cpu():
    return _load(128, 96)


# 128x96 (24,576 camera rays: classes 24,576 .. 4,096) for the default
# sort; the other sorts and a slot slice at 64x48 (6,144: two classes),
# the plain walk being some 30 s a 128x96 frame on one CPU thread
@pytest.mark.parametrize("width,height,sort_mode,half", [
    (128, 96, "sig_mort", False), (64, 48, "sig_mort", True),
    (64, 48, "mort_oct", False), (64, 48, "none", False)])
def test_fixed_capacity_matches_the_live_prefix_loop(blob_cpu, width, height,
                                                     sort_mode, half):
    bricks, cam, _ = blob_cpu
    cd = torch.from_numpy(camera_ray_data(cam, width, height))
    slots = torch.from_numpy(wavefront._wave_layout(width, height)[0])
    pix_slots = slots[:slots.numel() // 2] if half else None
    ref_stats, stats = {}, {}
    ref = _fixed(bricks, cd, width, height, 3, 2, sort_mode, ref_stats,
                 pix_slots)
    cache = wavefront.WaveCache()
    got = _fixed(bricks, cd, width, height, 3, 2, sort_mode, stats,
                 pix_slots, cache)
    assert [c.engine.counted for c in cache._chunks.values()] == [True]
    assert torch.equal(got, ref)
    assert stats == ref_stats and ref_stats["waves"] > 10
    assert ref.abs().sum() > 0


def test_fixed_capacity_slots_without_a_ray(blob_cpu):
    """A slot map of padding alone (a tile split's empty rank) renders
    nothing, in both schedules."""
    bricks, cam, _ = blob_cpu
    cd = torch.from_numpy(camera_ray_data(cam, 64, 48))
    slots = torch.full((wavefront.BLOCK_SLOTS,), 64 * 48, dtype=torch.int32)
    stats = {}
    got = _fixed(bricks, cd, 64, 48, 0, 2, "sig_mort", stats, slots,
                 wavefront.WaveCache())
    ref = wavefront.render_samples_wavefront(bricks, cd, 64, 48, 0, 2,
                                             stats=stats, pix_slots=slots)
    assert not got.any() and not ref.any() and stats == {}


def _custom_tracer(scene, org, dirn, tnear):
    return wavefront.trace_wave_slim(scene, org, dirn, tnear)


@pytest.mark.parametrize("tail_trace", ["", "slim2"])
@pytest.mark.parametrize("compact_tail", [0, 8])
@pytest.mark.parametrize("kept", [False, True])
@pytest.mark.parametrize("lights", [False, True])
@pytest.mark.parametrize("steps", ["STEPS", "PLAIN_STEPS"])
@pytest.mark.parametrize("engine", ["slim", "slimg8", "slim2", "pairs",
                                    "custom"])
def test_the_schedule_is_chosen_from_what_the_loop_sees(
        engine, steps, lights, kept, compact_tail, tail_trace):
    """Counted exactly where the cache is kept, kernel B2 traces every
    depth (a custom tracer does not, even one that calls B2; the tail
    engine only while the ladder runs it), the steps are ``STEPS`` and no
    light is sampled; graphed where, besides, the tensors are on a card."""
    custom = engine == "custom"
    tracers = wavefront._depth_tracers(
        "slim" if custom else engine, tail_trace, compact_tail, "sig_mort",
        50, _custom_tracer if custom else None)
    steps = getattr(wave_step, steps)
    b2 = engine in ("slim", "slimg8") and not (tail_trace and compact_tail)
    counted = kept and b2 and steps is wave_step.STEPS and not lights
    for device, graphed in (("cpu", False), ("cuda", counted)):
        chosen = wavefront.wave_engine(kept, tracers, steps.record, steps,
                                       lights, torch.device(device))
        assert (chosen.counted, chosen.graphed) == (counted, graphed)


def test_counted_keys_past_the_count_are_the_sentinel(blob_cpu):
    """Columns at or past ``COUNT`` key to INT32_MAX whatever their rows
    hold (here live rays), and only the live rays before it are counted."""
    bricks, _, _ = blob_cpu
    n, m = 300, 200
    gen = torch.Generator().manual_seed(7)
    table = torch.rand((wave_step.TABLE_ROWS, n), generator=gen)
    table[wave_step.LIVE] = (torch.rand(n, generator=gen) > 0.3).float()
    root = bricks.top_boxes[0, :6]
    lo, inv = root[:3], 1.0 / (root[3:] - root[:3])
    for mode in wave_step.SORT_MODES:
        ctl = wave_step.new_control("cpu")
        ctl[wave_step.COUNT] = m
        ctl[wave_step.NEXT] = 5
        key = torch.zeros(n, dtype=torch.int32)
        wave_step.key_counted(table, mode, lo, inv, bricks.coarse_boxes, ctl,
                              key)
        full = wave_step.sort_key_plain(table, mode, lo, inv,
                                        bricks.coarse_boxes)
        assert torch.equal(key[:m], full[:m])
        assert (key[m:] == INT32_MAX).all() and (full[m:] < INT32_MAX).any()
        live = int((table[wave_step.LIVE, :m] > 0).sum())
        assert int(ctl[wave_step.NEXT]) == 5 + live
        wave_step.tally(ctl)
        assert ctl.tolist()[:6] == [5 + live, 0, m, 1, 1, m]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


@pytest.fixture(scope="module")
def blob_cuda():
    _needs_card()
    return _load(640, 480, "cuda")


def _launches():
    return [wavefront.trace_bricks_cuda.launches,
            wave_step.wave_record_cuda.launches,
            wave_step.wave_shade_cuda.launches,
            wave_step.wave_sort_key_cuda.launches,
            wave_step.wave_drain_cuda.launches]


def _groups(chunk):
    """The classes a chunk captured a group for: its full width, picked by
    the first read, unless GROUP_WAVES rounds of its drain's lanes hold
    it.  At depth 50 with the roulette from past depth 5 every later read
    drains: its group would run past the roulette's start."""
    return [c for c in chunk.classes[:1]
            if c > wavefront.GROUP_WAVES * chunk.drain_lanes]


@pytest.mark.cuda
@pytest.mark.parametrize("spp,sort_mode,half", [
    (2, "sig_mort", False), (10, "sig_mort", False), (2, "mort_oct", False),
    (2, "none", False), (2, "sig_mort", True)])
def test_cuda_graph_path_matches_the_live_prefix_loop(blob_cuda, spp,
                                                      sort_mode, half):
    bricks, cam, cd = blob_cuda
    slots = torch.from_numpy(wavefront._wave_layout(640, 480)[0])
    pix_slots = slots[:slots.numel() // 2] if half else None
    chunks = 2 if spp == 10 else 1
    cache = wavefront.WaveCache()
    for frame, start in enumerate((0, spp)):
        if frame:
            cd = torch.from_numpy(camera_ray_data(
                Camera((cam.lookfrom[0] + 0.3,) + tuple(cam.lookfrom[1:]),
                       cam.lookat, cam.up, cam.vfov), 640, 480)).cuda()
        kw = dict(sort_mode=sort_mode, pix_slots=pix_slots)
        before, stats, ref_stats = _launches(), {}, {}
        replays0, drained0 = cache.replays(), cache.drained()
        got = wavefront.render_samples_wavefront(
            bricks, cd, 640, 480, start, spp, stats=stats, wave_cache=cache,
            **kw)
        torch.cuda.synchronize()
        primary, group, drain = (cache.replays()[k] - replays0[k]
                                 for k in ("primary", "group", "drain"))
        drained = cache.drained()["waves"] - drained0["waves"]
        # the waves the groups ran; the rest ran in the drain
        waves = stats["waves"] - drained
        K = wavefront.GROUP_WAVES
        launched = primary + K * group
        # a chunk's waves end inside its last group or in its drain
        assert primary == chunks and drain == chunks
        assert drained > 0
        assert waves <= launched <= waves + (K - 1) * (chunks - drain)
        if not frame:
            # the eager pass before a chunk's graphs are captured
            launched += sum(1 + K * len(_groups(c))
                            for c in cache._chunks.values())
            drain += len(cache._chunks)
        assert [a - b for a, b in zip(_launches(), before)] \
            == [launched] * 4 + [drain]
        ref = wavefront.render_samples_wavefront(
            bricks, cd, 640, 480, start, spp, stats=ref_stats,
            tracer=wavefront.trace_wave_slim, **kw)
        assert torch.equal(got, ref)
        assert stats == ref_stats and stats["waves"] > 10 * chunks


def _renderer(spf, **config):
    pack, parsed = load_scene(BLOB_BOX)
    return ProgressiveRenderer(
        pack, Camera.from_parsed(parsed.camera), 640, 480,
        RenderConfig(samples_per_frame=spf, **config), device="cuda")


@pytest.mark.cuda
def test_cuda_state_kept_over_camera_moves_and_rebuilt_for_spf(monkeypatch):
    _needs_card()
    captures = []
    begin = torch.cuda.CUDAGraph.capture_begin

    def counting(graph, *args, **kwargs):
        captures.append(graph)
        return begin(graph, *args, **kwargs)

    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin", counting)
    r = _renderer(10)
    r.step(sync=True)
    chunks = dict(r._wave_cache._chunks)
    # two chunk shapes (6 and 4 samples), each a primary graph, a group a
    # class above its drain limit and the drain
    assert len(chunks) == 2
    assert len(captures) == sum(len(_groups(c)) + 2
                                for c in chunks.values())
    first = len(captures)
    cam = r.camera
    for k in range(3):
        r.set_camera(Camera((cam.lookfrom[0] + 0.1 * (k + 1),)
                            + tuple(cam.lookfrom[1:]), cam.lookat, cam.up,
                            cam.vfov))
        r.step(sync=True)
    assert r.sample_count == 10 and len(captures) == first
    assert all(r._wave_cache._chunks[k] is c for k, c in chunks.items())
    r.set_samples_per_frame(2)
    r.step(sync=True)
    assert len(captures) > first
    assert not set(map(id, r._wave_cache._chunks.values())) \
        & set(map(id, chunks.values()))
    # the frame equals the uncounted schedule's at that camera and sample
    new = r.accum.clone()
    ref = wavefront.render_samples_wavefront(
        r.scene, r._cam_data, 640, 480, 0, 2,
        tracer=wavefront.trace_wave_slim)
    assert torch.equal(new, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("config,share", [
    ({}, 0.9), ({"enable_nee": True}, 0.0),
    ({"wavefront_trace": "slim2"}, 0.0)])
def test_cuda_graph_wave_share(config, share):
    _needs_card()
    r = _renderer(2, **config)
    r.step(sync=True)
    counts = trace.counts()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            r.step(sync=True)
    added = {k: v - counts.get(k, 0) for k, v in trace.counts().items()}
    assert added["waves"] > 3 * 10
    if share:
        assert added["graph_waves"] >= share * added["waves"]
    else:
        assert added.get("graph_waves", 0) == 0


@pytest.mark.cuda
def test_cuda_counted_keys_and_count(blob_cuda):
    bricks, _, _ = blob_cuda
    n, m = 100_000, 61_234
    gen = torch.Generator().manual_seed(11)
    table = torch.rand((wave_step.TABLE_ROWS, n), generator=gen)
    table[wave_step.LIVE] = (torch.rand(n, generator=gen) > 0.3).float()
    table = table.cuda()
    root = bricks.top_boxes[0, :6]
    lo, inv = root[:3].contiguous(), (1.0 / (root[3:] - root[:3]))
    for mode in wave_step.SORT_MODES:
        ctl = wave_step.new_control("cuda")
        ctl[wave_step.COUNT] = m
        key = torch.zeros(n, dtype=torch.int32, device="cuda")
        before = wave_step.wave_sort_key_cuda.launches
        wave_step.key_counted(table, mode, lo, inv, bricks.coarse_boxes, ctl,
                              key)
        wave_step.tally(ctl)
        assert wave_step.wave_sort_key_cuda.launches == before + 1
        ref = wave_step.sort_key_plain(table.cpu(), mode, lo.cpu(), inv.cpu(),
                                       bricks.coarse_boxes.cpu())
        key = key.cpu()
        assert torch.equal(key[:m], ref[:m]) and (key[m:] == INT32_MAX).all()
        live = int((table[wave_step.LIVE, :m] > 0).sum())
        assert ctl.tolist()[:6] == [live, 0, m, 1, 1, m]
