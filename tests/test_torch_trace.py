"""The port's spans and counters (utils/trace.py) on the CPU, and on a card
the count of its host reads against the syncs that PyTorch reports.

With no profiler recording, ``span`` hands out one shared no-op context
and opens no ``record_function``.  Under ``torch.profiler`` a wavefront
frame shows its ``frame.*`` spans once each inside the step; in the wave
loop's uncounted schedule (here engine "slim2") its four ranges a wave and
one ``frame.read`` a wave, in the counted one (the CPU renderer's default)
a ``wavefront.replay`` a group of waves and one read after each; a
one-launch frame shows ``frame.launch``; a build fills the set-up
record.  The ``cuda`` case skips here and runs on a card
with ``python -m pytest --noconftest -m cuda tests/test_torch_trace.py``.
"""

import ctypes.util
import time
import warnings
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from pathtracer_cuda_interactive_tpu_torch import SCENES_DIR
from pathtracer_cuda_interactive_tpu_torch.io.xml_scene import parse_scene
from pathtracer_cuda_interactive_tpu_torch.models.bricks import BrickSet
from pathtracer_cuda_interactive_tpu_torch.models.device_scene import (
    DeviceScene)
from pathtracer_cuda_interactive_tpu_torch.models.scenepack import (
    pack_scene)
from pathtracer_cuda_interactive_tpu_torch.models.subdivide import (
    subdivide_scene)
from pathtracer_cuda_interactive_tpu_torch.ops import cuda_build
from pathtracer_cuda_interactive_tpu_torch.ops.camera import Camera
from pathtracer_cuda_interactive_tpu_torch.render.renderer import (
    ProgressiveRenderer)
from pathtracer_cuda_interactive_tpu_torch.utils import trace
from pathtracer_cuda_interactive_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(2)

CBOX = str(SCENES_DIR / "cbox_rect.xml")
BLOB_BOX = str(SCENES_DIR / "blob_box.xml")
WAVE_RANGES = ("wavefront.sort", "wavefront.trace", "wavefront.shade",
               "wavefront.count")
SETUP = ("setup.parse", "setup.subdivide", "setup.pack", "setup.host_set",
         "setup.upload", "setup.walk_table")


def _renderer(path, width, height, device="cpu", **config):
    return ProgressiveRenderer.from_xml(
        path, RenderConfig(max_depth=4, **config), width=width,
        height=height, device=device)


def _profiled_step(r):
    """One step under a CPU profiler inside a "test.step" range: (the kept
    ranges by name as (start, end) lists, the step's (start, end), the
    stats' waves added, the totals and counters added)."""
    waves = r.waves
    totals, counts = trace.totals(), trace.counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.step"):
            r.step()
    ranges = {}
    for e in prof.events():
        if e.name.startswith(("frame.", "wavefront.", "setup.", "test.")):
            ranges.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    added = {name: (row[0] - totals.get(name, (0, 0.0))[0])
             for name, row in trace.totals().items()}
    counted = {name: n - counts.get(name, 0)
               for name, n in trace.counts().items()}
    return ranges, ranges.pop("test.step")[0], r.waves - waves, added, \
        counted


@pytest.fixture(scope="module")
def wave_frame():
    """A 64x48 wavefront frame of blob_box at depth 4 in the uncounted
    schedule (engine "slim2"), after one frame outside the profiler."""
    r = _renderer(BLOB_BOX, 64, 48, wavefront_trace="slim2")
    assert r.mode == "wavefront"
    r.step()
    return _profiled_step(r)


def test_span_without_a_profiler_is_the_shared_noop(monkeypatch):
    def no_range(name):
        raise AssertionError(f"record_function({name!r}) opened")

    monkeypatch.setattr(trace, "record_function", no_range)
    totals, counts = trace.totals(), trace.counts()
    assert not torch.autograd._profiler_enabled()
    assert trace.span("frame.read") is trace.NOOP
    assert trace.span("wavefront.sort") is trace.span("frame.rays")
    with trace.span("frame.read"):
        pass
    trace.count("waves", 5)
    with trace.setup_span("setup.test_noop"):
        pass
    assert trace.totals() == totals and trace.counts() == counts
    assert trace.setup_seconds()["setup.test_noop"] >= 0.0


def test_spans_record_only_under_a_profiler():
    spans, seconds = trace.totals().get("test.inner", (0, 0.0))
    items = trace.counts().get("test.items", 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.span("test.inner") is not trace.NOOP
        for _ in range(3):
            with trace.span("test.inner"):
                time.sleep(0.001)
        trace.count("test.items", 7)
    assert Counter(e.name for e in prof.events())["test.inner"] == 3
    now, now_s = trace.totals()["test.inner"]
    assert now - spans == 3 and now_s - seconds >= 0.003
    assert trace.counts()["test.items"] - items == 7
    assert trace.span("test.inner") is trace.NOOP


def test_wavefront_frame_spans(wave_frame):
    ranges, (t0, t1), waves, added, _ = wave_frame
    for name in ("frame.layout", "frame.rays", "frame.sum",
                 "frame.accumulate"):
        assert len(ranges[name]) == 1, name
    assert "frame.launch" not in ranges
    for name, spans in ranges.items():
        assert all(t0 <= s <= e <= t1 for s, e in spans), name
    # the wave loop's ranges as before: four a wave, no sort before the
    # primary wave (one chunk at this size; no NEE, so no shadow wave)
    assert waves > 1
    assert [len(ranges[n]) for n in WAVE_RANGES] == [waves - 1] + [waves] * 3
    # the frame.* spans never nest in one another, frame.read apart
    top = sorted(s for name, spans in ranges.items()
                 if name.startswith("frame.") and name != "frame.read"
                 for s in spans)
    assert all(a[1] <= b[0] for a, b in zip(top, top[1:]))
    # the totals count what the profiler saw
    assert {n: added[n] for n in ranges} == {n: len(s)
                                            for n, s in ranges.items()}


def test_reads_are_the_waves_and_the_mask_gathers(wave_frame):
    """One read a wave, its live count; the kept chunk's slot map (the
    padding mask) was gathered and uploaded when it was built."""
    ranges, _, waves, added, counted = wave_frame
    assert len(ranges["frame.read"]) == waves
    counts = ranges["wavefront.count"]
    assert all(any(cs <= s and e <= ce for cs, ce in counts)
               for s, e in ranges["frame.read"])
    assert counted["waves"] == waves and counted["rays"] > 0


def test_counted_frame_reads_the_control_block_once_a_group():
    """The CPU renderer's default frame runs counted: a replay span a
    group (here the primary wave and one group of four, depth 4) and one
    read after each, no per-wave range, no graph."""
    r = _renderer(BLOB_BOX, 32, 24)
    r.step()
    ranges, (t0, t1), waves, _, counted = _profiled_step(r)
    for name in ("frame.layout", "frame.rays", "frame.sum",
                 "frame.accumulate"):
        assert len(ranges[name]) == 1, name
    assert not any(n in ranges for n in WAVE_RANGES)
    assert len(ranges["wavefront.replay"]) == len(ranges["frame.read"]) == 2
    assert counted["waves"] == waves > 1 and "graph_waves" not in counted


def test_nee_adds_a_shadow_read_a_wave():
    r = _renderer(BLOB_BOX, 16, 12, enable_nee=True)
    assert r.mode == "wavefront"
    r.step()
    ranges, _, waves, _, counted = _profiled_step(r)
    primary = len(ranges["wavefront.trace"])
    # a nonzero gather a wave, then a shadow wave of the rays that hit
    # (one light)
    assert primary < waves <= 2 * primary and counted["waves"] == waves
    assert len(ranges["frame.read"]) == 2 * primary


@pytest.mark.parametrize("mode", ["megakernel", "bricks"])
def test_one_launch_frame_shows_frame_launch(mode):
    if mode == "megakernel":
        r = _renderer(CBOX, 32, 24)
    else:
        r = _renderer(BLOB_BOX, 8, 6, large_scene_mode="bricks")
    assert r.mode == mode
    ranges, (t0, t1), waves, _, _ = _profiled_step(r)
    assert len(ranges["frame.launch"]) == len(ranges["frame.accumulate"]) == 1
    assert waves == 0
    assert not any(n.startswith("wavefront.") for n in ranges)
    assert all(t0 <= s <= e <= t1 for spans in ranges.values()
               for s, e in spans)


def test_setup_record_holds_every_setup_span(monkeypatch):
    before = trace.setup_seconds()
    t0 = time.perf_counter()
    parsed = subdivide_scene(parse_scene(CBOX), levels=1)
    pack = pack_scene(parsed)
    DeviceScene.from_pack(pack)
    bricks = BrickSet.from_pack(pack)
    r = ProgressiveRenderer(bricks, Camera.from_parsed(parsed.camera), 16,
                            12, RenderConfig(large_scene_mode="bricks"),
                            device="cpu")
    r.scene.walk_table()
    # a kernel library's hash check, build and load: a C library stands
    # in for the one nvcc would build
    libc = ctypes.util.find_library("c")
    monkeypatch.setattr(cuda_build, "build", lambda source, build_dir: libc)
    cuda_build.load(cuda_build.CSRC_DIR / "megakernel.cu")
    wall = time.perf_counter() - t0
    after = trace.setup_seconds()
    grew = {n: after[n] - before.get(n, 0.0) for n in after
            if after[n] > before.get(n, 0.0)}
    assert set(SETUP + ("setup.kernels",)) <= set(grew)
    # set-up spans do not nest: their seconds add up to no more than the
    # time it all took
    assert sum(grew[n] for n in SETUP + ("setup.kernels",)) <= wall


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["megakernel", "wavefront",
                                  "wavefront-nee", "bricks"])
def test_every_host_sync_is_a_read_span(mode):
    """Over 3 frames of a main-path mode, the syncs that
    ``torch.cuda.set_sync_debug_mode("warn")`` reports are the
    ``frame.read`` spans; the kernel libraries load in ``setup.kernels``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if mode == "megakernel":
        r = _renderer(CBOX, 160, 120, "cuda")
    else:
        r = _renderer(BLOB_BOX, 160, 120, "cuda",
                      enable_nee=mode == "wavefront-nee",
                      large_scene_mode=mode.split("-")[0])
    assert r.mode == mode.split("-")[0]
    r.step(sync=True)
    assert "setup.kernels" in trace.setup_seconds()
    reads = trace.totals().get("frame.read", (0, 0.0))[0]
    with profile(activities=[ProfilerActivity.CPU]):
        # the mode is set outside the record: setting it can warn itself
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                for _ in range(3):
                    r.step(sync=False)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    reads = trace.totals().get("frame.read", (0, 0.0))[0] - reads
    where = Counter(f"{w.filename}:{w.lineno}" for w in syncs)
    assert reads == len(syncs), (reads, where)
    if mode == "wavefront":
        # the counted schedule: a read after the primary wave and one
        # after the group of secondary waves that reaches depth 4
        assert reads == 3 * 2
    elif mode == "wavefront-nee":
        assert reads > 3 * 2
