"""The plain reference against the port's CPU path, on tiny frames of each
configuration; and the control (the reference in bfloat16) against the
limits of every cell."""

import numpy as np
import pytest
import torch

from torrey_bench import check, program

from .conftest import CELLS, tiny


def _port_and_reference(cell, overrides, samples=2, seed=1984):
    s = program.setup(cell, seed, "cpu", overrides)
    s.renderer.step(samples)
    got = s.renderer.accum.reshape(-1, 3).double().numpy()
    size = program.sizes(cell, overrides)
    pix = np.arange(size["width"] * size["height"])
    ref, sq = check.reference_sums(cell, size, pix, 0, samples, seed, "cpu")
    return got, ref, sq, size, pix


@pytest.mark.parametrize("name", ["cbox_rect-spf2",
                                  "blob_box_x3-wavefront-spf2",
                                  "blob_box_x3-bricks-spf2"])
def test_reference_agrees_with_the_port(cells, name):
    """32x24, depth 4, 2 samples; the large scene at its three levels of
    subdivision.  The small scene runs the port's plain integrator, the
    same arithmetic as the reference: equal to float32 rounding.  The
    large scene's brick walk and the reference's BVH walk meet shared
    edges differently: the criterion of tests/test_megakernel.py:74-77."""
    cell = cells[name]
    overrides = {"width": 32, "height": 24, "max_depth": 4}
    got, ref, _, _, _ = _port_and_reference(cell, overrides)
    assert ref.mean() > 0.05
    if name.startswith("cbox"):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        err = np.abs(got - ref)
        assert (err.max(axis=-1) > 1e-3).mean() < 2e-3
        assert err.mean() < 1e-3


def test_reference_rebuilds_what_the_port_builds(cells):
    """The reference's own parse, subdivision and tree: the large scene has
    327,692 triangles and a sphere, as the configuration says."""
    from torrey_bench import BENCH_DIR, reference
    cfg = cells["blob_box_x3-wavefront-spf2"].config
    scene, _, wh = reference.build_scene(str(BENCH_DIR / cfg["scene"]),
                                         cfg["subdivide_levels"])
    assert scene.num_triangles == cfg["triangles"] == 327692
    assert scene.num_spheres == cfg["spheres"] == 1
    assert wh == (cfg["width"], cfg["height"])


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(cells, name):
    """The control: the reference rounded through bfloat16 after every
    bounce, put in the program's place, fails the cell's limits (on the
    card at the cell's size, calibrate.py reads it)."""
    cell = cells[name]
    overrides = tiny(name)
    size = program.sizes(cell, overrides)
    pix = check.tile_pixels(7, size["width"], size["height"], 12)
    ref, sq = check.reference_sums(cell, size, pix, 0, 16, 7, "cpu")
    ctl, _ = check.reference_sums(cell, size, pix, 0, 16, 7, "cpu",
                                  store_dtype=torch.bfloat16)
    numbers = check.gaps(ctl, ref, sq, 16)
    correct, _ = check.judge(numbers, cell.config["check"]["limits"])
    assert not correct
    assert numbers["z_rms"] > 1.0


def test_tiles_are_distinct_and_seeded():
    a = check.tile_pixels(2 ** 40 + 3, 640, 480, 50)
    b = check.tile_pixels(2 ** 40 + 3, 640, 480, 50)
    c = check.tile_pixels(4, 640, 480, 50)
    assert (a == b).all() and not (a == c).all()
    assert len(np.unique(a)) == 50 * 16
    assert a.min() >= 0 and a.max() < 640 * 480
    assert check.tiles_for_budget(1e7, 2000, 5.0, 640, 480) == 62
    assert check.tiles_for_budget(1e3, 2000, 5.0, 640, 480) == 1
