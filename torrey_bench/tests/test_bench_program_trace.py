"""The readers of the port's own spans and counters (program_trace.py and
the five metrics on it): on made-up totals, without the port's trace
module (a commit before it: nothing, and no error), in a traced CPU run of
two cells; and the device-trace metrics and ``wave_host_ms`` read the same
on a trace that holds ``frame.*`` ranges besides."""

import sys

import pytest

from torrey_bench import program_trace, run, spec
from torrey_bench.tests.conftest import tiny
from torrey_bench.tests.test_bench_trace import fake_trace
from torrey_bench.tracing import Event, digest

NEW = ("frame_host_ms", "host_reads_per_frame", "host_read_ms",
       "rays_per_wave", "setup_span_s")


def _read(names, run_record=None):
    got = spec.read_metrics([{"name": n, "unit": "u"} for n in names],
                            run_record or {"trace": None})
    return {k: v["value"] for k, v in got.items()}


@pytest.fixture
def port_trace(monkeypatch):
    """The port's trace module with its records replaced by made-up ones:
    two steps under the profiler."""
    from pathtracer_cuda_interactive_tpu_torch.utils import trace
    monkeypatch.setattr(trace, "totals", lambda: {
        "frame.accumulate": (2, 0.002), "frame.layout": (2, 0.004),
        "frame.rays": (2, 0.010), "frame.sum": (2, 0.001),
        "frame.read": (44, 0.030), "wavefront.count": (40, 0.050),
        "setup.kernels": (1, 9.0)})
    monkeypatch.setattr(trace, "counts", lambda: {"waves": 40,
                                                  "rays": 1000})
    monkeypatch.setattr(trace, "setup_seconds", lambda: {
        "setup.parse": 0.5, "setup.upload": 0.25, "setup.kernels": 1.0})
    return trace


def test_readers_on_made_up_totals(port_trace):
    assert _read(NEW) == pytest.approx({
        "frame_host_ms": (0.002 + 0.004 + 0.010 + 0.001) / 2 * 1e3,
        "host_reads_per_frame": 22.0, "host_read_ms": 15.0,
        "rays_per_wave": 25.0, "setup_span_s": 1.75})


def test_readers_find_nothing_but_zero_reads(port_trace, monkeypatch):
    monkeypatch.setattr(port_trace, "totals", lambda: {
        "frame.accumulate": (4, 0.004), "frame.launch": (4, 0.002)})
    monkeypatch.setattr(port_trace, "counts", lambda: {})
    got = _read(NEW)
    assert got["frame_host_ms"] == pytest.approx(1.5)
    assert got["host_reads_per_frame"] == got["host_read_ms"] == 0.0
    assert "rays_per_wave" not in got
    monkeypatch.setattr(port_trace, "totals", lambda: {})
    monkeypatch.setattr(port_trace, "setup_seconds", lambda: {})
    assert _read(NEW) == {}


def test_readers_find_nothing_without_the_port_module(port_trace,
                                                      monkeypatch):
    monkeypatch.delitem(sys.modules, program_trace.MODULE)
    assert program_trace.port_trace() is None
    assert _read(NEW) == {}


def _with_frame_ranges(events):
    """``fake_trace()`` with the port's frame spans inside both steps and
    across their idle gaps, and a read inside wavefront.count."""
    return events + [
        Event("frame.layout", "range", 0, 12),
        Event("frame.rays", "range", 12, 28),
        Event("frame.read", "range", 14, 16),
        Event("frame.read", "range", 31, 39),
        Event("frame.accumulate", "range", 40, 40.5),
        Event("frame.launch", "range", 100, 149),
        Event("frame.accumulate", "range", 149, 150),
        Event("setup.kernels", "range", 101, 110)]


def test_device_metrics_ignore_frame_ranges():
    names = ("wave_host_ms", "kernel_ms", "kernel_roofline",
             "launches_per_frame", "device_idle_share")

    def reading(events):
        d = digest(events)
        return d, _read(names, {"trace": d, "least_ms": 0.01})

    d0, plain = reading(fake_trace())
    d1, framed = reading(_with_frame_ranges(fake_trace()))
    assert set(plain) == set(names) and framed == plain
    assert (d1["busy_us"], d1["window_us"], d1["frames"]) \
        == (d0["busy_us"], d0["window_us"], d0["frames"])
    # the same idle, now put down to the port's spans where they are open
    assert sum(d1["idle_us"].values()) == sum(d0["idle_us"].values())
    assert d1["idle_us"]["frame.layout"] == 10
    assert d1["idle_us"]["frame.launch"] == 60


@pytest.mark.parametrize("name", ["blob_box_x3-wavefront-spf2",
                                  "cbox_rect-spf2"])
def test_traced_cpu_run_reads_the_port(cells, name):
    cell = cells[name]
    size = dict(tiny(name), width=16, height=12, max_depth=3)
    out = run.measure(cell, 4294967311, 0.5, True, device="cpu",
                      overrides=size)
    got = _read([m["name"] for m in cell.per_layer], out["run"])
    wavefront = "wavefront" in name
    expected = set(NEW) - (set() if wavefront else {"rays_per_wave"})
    assert expected <= set(got)
    assert got["frame_host_ms"] > 0 and got["setup_span_s"] > 0
    if wavefront:
        # the counted schedule, the renderer keeping its chunks: the frame
        # is one chunk of 16 x 12 x 2 columns; the host reads the control
        # block after the primary wave and after each group of GROUP_WAVES
        # waves until the depth cap ends every path (live paths in a
        # closed box); nothing drains on the CPU
        from pathtracer_cuda_interactive_tpu_torch.ops.wavefront import (
            GROUP_WAVES, MAX_RAYS_PER_WAVE)
        assert 16 * 12 * 2 <= MAX_RAYS_PER_WAVE
        groups = -(-(size["max_depth"] - 1) // GROUP_WAVES)
        assert got["host_reads_per_frame"] == 1 + groups
        assert 0 < got["rays_per_wave"] <= 16 * 12 * 2
