"""The busy-share and idle-gap arithmetic of tracing.py on a recorded fake
trace, and the metric readers that take it."""

import pytest

from torrey_bench import spec
from torrey_bench.tracing import Event, breakdown, digest


def fake_trace():
    """Two frames of 100 us.  Frame 1: a step range (0-40) holding a
    wavefront.count range (30-40); kernels A 10-30 and B 25-35 (they
    overlap), a copy 50-55, a sync range 40-100 with kernel A 60-90.
    Frame 2: step 100-150, kernel B 150-190, sync 150-200."""
    return [
        Event("bench.frame", "range", 0, 100),
        Event("bench.step", "range", 0, 40),
        Event("wavefront.count", "range", 30, 40),
        Event("bench.sync", "range", 40, 100),
        Event("A", "kernel", 10, 30),
        Event("B", "kernel", 25, 35),
        Event("Memcpy DtoH", "copy", 50, 55),
        Event("A", "kernel", 60, 90),
        Event("bench.frame", "range", 100, 200),
        Event("bench.step", "range", 100, 150),
        Event("bench.sync", "range", 150, 200),
        Event("B", "kernel", 150, 190),
    ]


def test_digest_union_and_gaps():
    d = digest(fake_trace())
    assert d["frames"] == 2
    assert d["window_us"] == 200
    # busy: 10-35, 50-55, 60-90, 150-190
    assert d["busy_us"] == 25 + 5 + 30 + 40
    assert d["kernel_count"] == 4
    assert d["kernel_us"] == 20 + 10 + 30 + 40
    assert d["kernels"] == {"A": [2, 50.0], "B": [2, 50.0]}
    # gaps: 0-10 step, 35-50 mid 42.5 sync, 55-60 sync, 90-150: mid 120
    # step, 190-200 sync
    assert d["idle_us"] == {"bench.step": 10 + 60, "bench.sync": 15 + 5 + 10}
    assert d["ranges"]["wavefront.count"] == [1, 10.0]


def test_gap_takes_the_innermost_range():
    """A gap inside wavefront.count inside bench.step is the count's."""
    events = [Event("bench.frame", "range", 0, 10),
              Event("bench.step", "range", 0, 10),
              Event("wavefront.count", "range", 2, 8),
              Event("K", "kernel", 0, 3), Event("K", "kernel", 7, 10)]
    d = digest(events)
    assert d["idle_us"] == {"wavefront.count": 4}
    assert d["busy_us"] == 6


def test_breakdown_sorted_and_bounded():
    events = [Event("bench.frame", "range", 0, 1000)]
    events += [Event(f"k{i}", "kernel", 10 * i, 10 * i + i + 1)
               for i in range(15)]
    b = breakdown(digest(events))
    assert len(b["device_ops"]) == 10
    assert b["device_ops"][0] == ["k14", 15e-6]
    assert [x[1] for x in b["device_ops"]] == sorted(
        (x[1] for x in b["device_ops"]), reverse=True)
    assert b["idle_gaps"][0][0] == "host"


def test_readers_on_the_digest():
    d = digest(fake_trace())
    run = {"trace": d, "least_ms": 0.01, "frames_ms": [1.0, 2.0, 3.0],
           "step_host_ms": [0.5, 0.7, 0.6],
           "spans": {"scene_build_s": 1.5, "scene_upload_s": 0.25}}
    names = ("launches_per_frame", "kernel_ms", "kernel_roofline",
             "device_idle_share", "wave_host_ms", "step_host_ms",
             "scene_build_s", "scene_upload_s", "step_mfu")
    got = spec.read_metrics([{"name": n, "unit": "u"} for n in names], run)
    value = {k: v["value"] for k, v in got.items()}
    assert value["launches_per_frame"] == 2
    assert value["kernel_ms"] == pytest.approx(0.05)
    assert value["kernel_roofline"] == pytest.approx(20.0)
    assert value["device_idle_share"] == pytest.approx(50.0)
    assert value["wave_host_ms"] == pytest.approx(0.005)
    assert value["step_host_ms"] == pytest.approx(0.6)
    assert value["step_mfu"] == pytest.approx(0.5)
    assert value["scene_build_s"] == 1.5


def test_readers_find_nothing_without_a_trace():
    run = {"trace": None, "least_ms": 0.01, "step_host_ms": []}
    names = ("launches_per_frame", "kernel_ms", "kernel_roofline",
             "device_idle_share", "wave_host_ms", "step_host_ms")
    assert spec.read_metrics([{"name": n, "unit": "u"} for n in names],
                             run) == {}
