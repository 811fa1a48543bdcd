"""The orbit traffic (``traffic/orbit-spf2.json``, its camera motion
``motions/orbit.py``): the views it turns through, and a tiny window of the
large scene under it on the CPU, checked at the last frame's camera.
``BENCHMARK.json`` holds no cell of it (PERF.md, Open questions), so the
cell is named in a copy of it."""

import json
import math

import pytest

from torrey_bench import BENCH_DIR, ROOT, program, run, spec

from .conftest import tiny

CELL = "blob_box_x3-wavefront-orbit"


@pytest.fixture(scope="module")
def orbit_cell(tmp_path_factory):
    root = tmp_path_factory.mktemp("orbit")
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["workloads"] = [w for w in doc["workloads"] if w["name"] != CELL]
    doc["workloads"].append({"name": CELL, "config": "blob_box_x3",
                             "traffic": "orbit-spf2", "chips": 1,
                             "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return spec.load_cell(CELL, root=root, bench_dir=BENCH_DIR)


@pytest.fixture(scope="module")
def orbit(orbit_cell):
    return orbit_cell.motion


@pytest.fixture(scope="module")
def initial(orbit_cell):
    from pathtracer_cuda_interactive_tpu_torch.ops.camera import Camera
    from torrey_bench import reference
    _, cam, _ = reference.build_scene(
        str(BENCH_DIR / orbit_cell.config["scene"]))
    return Camera(cam.lookfrom, cam.lookat, cam.up, cam.vfov)


def test_yaw_swings_25_degrees_from_the_frame_index(orbit):
    offsets = [orbit.yaw_offset(f) for f in range(1000)]
    assert max(abs(o) for o in offsets) <= 25.0
    assert max(offsets) == pytest.approx(25.0)
    assert min(offsets) == pytest.approx(-25.0)
    assert offsets[0] == 0.0
    # a drag of at most 13.1 px a frame at 0.1 degree a pixel
    assert max(abs(b - a) for a, b in zip(offsets, offsets[1:])) / 0.1 < 13.1


def test_camera_moves_every_frame_inside_the_box(orbit, initial):
    """Frame 0 is the scene's view; every later frame moves the eye by more
    than the renderer's camera epsilon, about the same lookat, at the same
    height and distance, between the walls (x = +-1, y 0-2, z -1-2)."""
    assert orbit.camera_at(initial, 0).almost_equal(initial)
    dist = math.dist(initial.lookfrom, initial.lookat)
    last = initial
    for f in range(1, 241):
        cam = orbit.camera_at(initial, f)
        assert not cam.almost_equal(last)
        assert (cam.lookat, cam.up, cam.vfov) \
            == (initial.lookat, initial.up, initial.vfov)
        assert math.dist(cam.lookfrom, cam.lookat) == pytest.approx(dist)
        x, y, z = cam.lookfrom
        assert abs(x) <= 0.81 and y == pytest.approx(1.0) and -1 < z < 2
        last = cam


def test_orbit_window_is_checked_at_the_last_camera(orbit_cell):
    """A 16x12 window: every frame after the first restarts the
    accumulation, so the check compares the last frame's 2 samples, traced
    by the reference from the last frame's camera, and reads correct."""
    cell = orbit_cell
    size = dict(tiny(CELL), width=16, height=12, max_depth=3)
    s = program.setup(cell, 21, "cpu", size)
    program.warm_up(s, int(cell.traffic["warmup_frames"]))
    rec = program.run_window(s, cell, 21, 1.0)
    frames = len(rec["frames_ms"])
    assert frames >= 2
    assert (rec["first_sample"], rec["samples"]) == (0, 2)
    cam = cell.motion.camera_at(s.initial_camera, frames - 1)
    assert rec["camera"] == (cam.lookfrom, cam.lookat, cam.up, cam.vfov)
    out = run.measure(cell, 21, 1.0, False, device="cpu", overrides=size)
    assert out["correct"], out["rows"]
