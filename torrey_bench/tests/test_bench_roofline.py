"""The fixed-work arithmetic of roofline.py on hand-made inputs, the
configurations' least frame times, and the shadow work that fixed_work.py
counts where a configuration samples its point lights."""

import pytest

from torrey_bench import fixed_work, roofline


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


# the least 2-spp frame times at 640x480 before the shadow work was counted
# (roofline.py without its shadow terms): a configuration that samples no
# light keeps them to the bit
UNLIT_LEAST_MS = {"cbox_rect": 0.0873624447761194,
                  "blob_box_x3": 0.17971847630597015}


@pytest.mark.parametrize("config", sorted(UNLIT_LEAST_MS))
def test_unlit_least_time_is_unchanged(config, cells):
    cell = next(c for c in cells.values() if c.config["name"] == config)
    fixed = cell.config["fixed_work"]
    assert not [k for k in fixed if k.startswith("shadow_")]
    assert roofline.least_ms(fixed, 640, 480, 2) \
        == (UNLIT_LEAST_MS[config], "operations")


SHADOW = {"shadow_rays_per_sample": 3.0, "shadow_box_tests_per_ray": 4.0,
          "shadow_tri_tests_per_ray": 2.0,
          "shadow_sphere_tests_per_ray": 1.0}


def test_frame_work_adds_the_shadow_terms():
    ops, nbytes = roofline.frame_work(dict(FIXED, **SHADOW), 4, 2, 3)
    rays, shadow = 4 * 2 * 3 * 2.0, 4 * 2 * 3 * 3.0
    assert ops == rays * (10 * 26 + 3 * 52 + 1 * 24) \
        + shadow * (4 * 26 + 2 * 52 + 1 * 24)
    assert nbytes == 1000 + rays * (24 + 8) + shadow * (24 + 1) + 4 * 2 * 12


def test_lit_scene_counts_shadow_work(cells):
    """The large scene unsubdivided with its point light sampled, at depth
    3: a shadow ray a hit, each with its any-hit search's tests; the frame's
    work grows by exactly their terms."""
    config = dict(cells["blob_box_x3-wavefront-spf2"].config,
                  subdivide_levels=0, max_depth=3,
                  render_config={"enable_nee": True})
    lit = fixed_work.count(config, 32)
    unlit = fixed_work.count(dict(config, render_config={}), 32)
    shadow_keys = set(SHADOW)
    assert shadow_keys <= set(lit) and not shadow_keys & set(unlit)
    assert all(lit[k] > 0 for k in shadow_keys)
    # one light: at most one shadow ray a ray, and one for every hit
    assert 0 < lit["shadow_rays_per_sample"] <= lit["rays_per_sample"]
    assert {k: v for k, v in lit.items() if k not in shadow_keys
            and k != "counted_over"} \
        == {k: v for k, v in unlit.items() if k != "counted_over"}
    w, h, spf = 16, 12, 2
    ops, nbytes = roofline.frame_work(lit, w, h, spf)
    ops0, nbytes0 = roofline.frame_work(unlit, w, h, spf)
    shadow = w * h * spf * lit["shadow_rays_per_sample"]
    assert ops == ops0 + shadow * (
        lit["shadow_box_tests_per_ray"] * roofline.BOX_OPS
        + lit["shadow_tri_tests_per_ray"] * roofline.TRI_OPS
        + lit["shadow_sphere_tests_per_ray"] * roofline.SPHERE_OPS)
    assert nbytes == pytest.approx(
        nbytes0 + shadow * roofline.SHADOW_RAY_BYTES, rel=1e-12)
