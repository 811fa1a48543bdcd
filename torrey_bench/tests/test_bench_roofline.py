"""The fixed-work arithmetic of roofline.py on hand-made inputs."""

import pytest

from torrey_bench import roofline


FIXED = {"rays_per_sample": 2.0, "box_tests_per_ray": 10.0,
         "tri_tests_per_ray": 3.0, "sphere_tests_per_ray": 1.0,
         "scene_bytes": 1000}


def test_frame_work_counts_ops_and_bytes():
    ops, nbytes = roofline.frame_work(FIXED, 4, 2, 3)
    rays = 4 * 2 * 3 * 2.0
    assert ops == rays * (10 * 26 + 3 * 52 + 1 * 24)
    assert nbytes == 1000 + rays * (24 + 8) + 4 * 2 * 12


def test_least_time_takes_the_larger_bound():
    ms, by = roofline.least_ms(FIXED, 4, 2, 3)
    ops, nbytes = roofline.frame_work(FIXED, 4, 2, 3)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    heavy = dict(FIXED, tri_tests_per_ray=1e6)
    ms, by = roofline.least_ms(heavy, 4, 2, 3)
    ops, _ = roofline.frame_work(heavy, 4, 2, 3)
    assert by == "operations"
    assert ms == pytest.approx(ops / 67e12 * 1e3)


@pytest.mark.parametrize("config", ["cbox_rect", "blob_box_x3"])
def test_configured_work_is_the_reference_count(config, cells):
    """The two configurations' least frame times at 2 spp: cbox_rect's is
    B1's bound of chip_smoke.py (614,400 samples, 5.73 rays, 32 triangle
    tests), 0.0874 ms; both are bound by operations."""
    cell = next(c for c in cells.values() if c.config["name"] == config)
    ms, by = roofline.least_ms(cell.config["fixed_work"], 640, 480, 2)
    assert by == "operations"
    if config == "cbox_rect":
        assert ms == pytest.approx(0.0874, abs=5e-4)
    else:
        assert 0.1 < ms < 0.3
