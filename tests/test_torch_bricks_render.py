"""The persistent brick render (kernel B6) of the port, on the CPU.

* its plain version (ops/brickkernel.py::render_tiles_bricks_plain, the
  path loop over every pixel with the full-record walk) against the JAX
  package's Pallas kernel in interpret mode
  (``ops/brickkernel.py::render_samples_bricks(..., interpret=True)``, about
  6 s here), at the criterion of tests/test_brickkernel.py:97-101: fewer
  than 1e-3 of the elements outside rtol = atol = 1e-4, and a mean absolute
  error below 1e-3;
* tile ranges and real-pass counts, the unit a split across devices
  partitions, add up to the whole image;
* the renderer's "bricks" mode, its NEE reroute to the wavefront, and a
  prebuilt BrickSet with the modes "mx" and "mx2", which takes the
  wavefront as in the JAX package (those paths need their own sets).

The CUDA kernel runs only on a card: the ``cuda`` cases skip without one.
They hold B6 to its plain version at 160x120, 2 samples: depth 4 at the
wavefront's shallow criterion, depth 12 statistically.  They import no
jax, so on the card they run with
``python -m pytest --noconftest -m cuda tests/test_torch_bricks_render.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pathtracer_cuda_interactive_tpu_torch import SCENES_DIR
from pathtracer_cuda_interactive_tpu_torch.models.bricks import BrickSet
from pathtracer_cuda_interactive_tpu_torch.models.scenepack import load_scene
from pathtracer_cuda_interactive_tpu_torch.ops import brickkernel, wavefront
from pathtracer_cuda_interactive_tpu_torch.ops.camera import (
    Camera, camera_ray_data)
from pathtracer_cuda_interactive_tpu_torch.render.renderer import (
    ProgressiveRenderer)
from pathtracer_cuda_interactive_tpu_torch.utils.config import RenderConfig

# The suite runs in several worker processes at once and these tensors are
# small: one intra-op thread per process keeps the workers from spinning
# against each other for the machine's cores.
torch.set_num_threads(1)

W, H = 32, 24
BLOB_BOX = str(SCENES_DIR / "blob_box.xml")


@pytest.fixture(scope="module")
def blob():
    """blob_box (a mirror sphere, a point light, 5,120 blob triangles) as
    (JAX BrickSet, JAX camera data, port BrickSet built from its fields,
    port camera data, the parsed camera).  The JAX package is imported
    here, so the ``cuda`` cases run where jax is not installed."""
    import jax.numpy as jnp
    from pathtracer_cuda_interactive_tpu.models import native as jax_native
    from pathtracer_cuda_interactive_tpu.models.bricks import (
        BrickSet as JaxBrickSet)
    from pathtracer_cuda_interactive_tpu.models.scenepack import (
        load_scene as jax_load_scene)
    from pathtracer_cuda_interactive_tpu.ops.camera import (
        Camera as JaxCamera, camera_ray_data as jax_camera_ray_data)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "build_sah_treelets_native",
                   lambda *args: None)
        jpack, jparsed = jax_load_scene(BLOB_BOX)
        jbricks = JaxBrickSet.from_pack(jpack)
    jcd = jnp.asarray(jax_camera_ray_data(
        JaxCamera.from_parsed(jparsed.camera), W, H))
    fields = {f.name: (getattr(jbricks, f.name)
                       if isinstance(getattr(jbricks, f.name), int)
                       else np.asarray(getattr(jbricks, f.name)))
              for f in dataclasses.fields(JaxBrickSet)}
    _, parsed = load_scene(BLOB_BOX)
    cam = Camera.from_parsed(parsed.camera)
    cd = torch.from_numpy(camera_ray_data(cam, W, H))
    return jbricks, jcd, BrickSet.from_numpy(**fields), cd, cam


def test_plain_matches_jax_b6(blob):
    from pathtracer_cuda_interactive_tpu.ops import brickkernel as jax_bk
    jbricks, jcd, bricks, cd, _ = blob
    ref = np.asarray(jax_bk.render_samples_bricks(
        jbricks, jcd, W, H, 0, 1, max_depth=3, interpret=True))
    got = brickkernel.render_samples_bricks(bricks, cd, W, H, 0, 1,
                                            max_depth=3)
    assert got.shape == (H, W, 3) and got.dtype == torch.float32
    got = got.numpy()
    bad = ~np.isclose(got, ref, rtol=1e-4, atol=1e-4)
    assert bad.mean() < 1e-3, f"{bad.mean():%} mismatched"
    assert np.abs(ref - got).mean() < 1e-3
    assert ref.mean() > 0.0 and ref.std() > 0.0


def test_tile_ranges_and_real_passes_add_up(blob):
    """65x33 is 2x2 tiles of 64x32, the right and bottom ones ragged."""
    bricks, cam = blob[2], blob[4]
    width, height = 65, 33
    cd = torch.from_numpy(camera_ray_data(cam, width, height))
    n = brickkernel.tile_grid(width, height)
    assert n == 4
    pix = brickkernel.tile_pixels(width, height, 0, n)
    assert torch.equal(torch.sort(pix).values, torch.arange(width * height))
    kw = dict(max_depth=2)
    full = brickkernel.render_samples_bricks(bricks, cd, width, height, 5, 2,
                                             **kw)
    parts = [brickkernel.render_tiles_bricks(bricks, cd, width, height, t0,
                                             nt, 5, 2, **kw)
             for t0, nt in ((0, 1), (1, 2), (3, 1))]
    assert torch.equal(parts[0] + parts[1] + parts[2], full)
    assert float(parts[1].reshape(-1, 3)[pix[:2048]].abs().max()) == 0.0
    # passes add up: 1 real of 2 passes from 5, plus 1 pass from 6
    first = brickkernel.render_tiles_bricks(bricks, cd, width, height, 0, n,
                                            5, 2, num_real=1, **kw)
    second = brickkernel.render_tiles_bricks(bricks, cd, width, height, 0, n,
                                             6, 1, **kw)
    assert torch.equal(first + second, full)
    assert float(full.mean()) > 0.0
    with pytest.raises(ValueError, match="tile range"):
        brickkernel.render_tiles_bricks(bricks, cd, width, height, 3, 2, 0, 1)


def test_sample_start_decorrelates_and_reproduces(blob):
    bricks, cd = blob[2], blob[3]
    a = brickkernel.render_samples_bricks(bricks, cd, W, H, 0, 1, max_depth=4)
    b = brickkernel.render_samples_bricks(bricks, cd, W, H, 1, 1, max_depth=4)
    a2 = brickkernel.render_samples_bricks(bricks, cd, W, H, 0, 1,
                                           max_depth=4)
    assert float((a - b).abs().max()) > 1e-3
    assert torch.equal(a, a2)


def test_cpu_render_launches_no_kernel(blob):
    bricks, cd = blob[2], blob[3]
    before = brickkernel.render_bricks_cuda.launches
    brickkernel.render_samples_bricks(bricks, cd, W, H, 0, 1, max_depth=2)
    assert brickkernel.render_bricks_cuda.launches == before == 0
    bg = torch.stack([bricks.bg_r, bricks.bg_g, bricks.bg_b])
    with pytest.raises(ValueError, match="CUDA"):
        brickkernel.render_bricks_cuda(bricks, cd.reshape(12), bg, W, H, 0, 1,
                                       0, 1, -1, 1984, 4, 5)
    with pytest.raises(ValueError, match="bricks on"):
        brickkernel.render_samples_bricks(bricks.to("meta"), cd, W, H, 0, 1)


def test_renderer_bricks_mode(blob):
    bricks, cd = blob[2], blob[3]
    config = RenderConfig(max_depth=3, large_scene_mode="bricks")
    r = ProgressiveRenderer.from_xml(BLOB_BOX, config, width=W, height=H,
                                     device="cpu")
    assert r.mode == "bricks" and isinstance(r.scene, BrickSet)
    r.step(1)
    r.step(1)
    assert r.sample_count == 2 and r.waves == 0
    ref = brickkernel.render_samples_bricks(bricks, cd, W, H, 0, 2,
                                            max_depth=3)
    torch.testing.assert_close(r.accum, ref, rtol=1e-5, atol=1e-6)
    cam = r.camera
    r.set_camera(Camera((0.2,) + tuple(cam.lookfrom[1:]), cam.lookat, cam.up,
                        cam.vfov))
    assert r.sample_count == 0 and float(r.accum.abs().max()) == 0.0


def test_renderer_nee_takes_the_wavefront():
    config = RenderConfig(max_depth=2, large_scene_mode="bricks",
                          enable_nee=True, samples_per_frame=1)
    r = ProgressiveRenderer.from_xml(BLOB_BOX, config, width=W, height=H,
                                     device="cpu")
    assert r.mode == "wavefront"
    r.step()
    assert r.waves == 4        # two waves and their shadow waves


@pytest.mark.parametrize("mode,expected", [("mx", "wavefront"),
                                           ("mx2", "wavefront"),
                                           ("bricks", "bricks"),
                                           ("wavefront", "wavefront")])
def test_prebuilt_brickset_pins_the_large_scene_path(blob, mode, expected):
    """A BrickSet with "mx"/"mx2" renders with the wavefront, as the JAX
    renderer does (its renderer.py:63-65); a ScenePack raises for them
    (tests/test_torch_wavefront.py)."""
    bricks, cam = blob[2], blob[4]
    config = RenderConfig(max_depth=2, large_scene_mode=mode,
                          samples_per_frame=1)
    r = ProgressiveRenderer(bricks, cam, W, H, config, device="cpu")
    assert r.mode == expected
    r.step()
    assert r.sample_count == 1 and float(r.accum.mean()) > 0.0
    assert r.waves == (2 if expected == "wavefront" else 0)
    with pytest.raises(ValueError, match="large_scene_mode"):
        ProgressiveRenderer(bricks, cam, W, H,
                            RenderConfig(large_scene_mode="fast"),
                            device="cpu")


def _wave_check(got, ref):
    """tests/test_wavefront.py:37-39."""
    bad = ~np.isclose(got, ref, rtol=1e-4, atol=1e-4)
    assert bad.mean() < 1e-3 and np.abs(got - ref).mean() < 1e-3


def _deep_check(got, ref):
    """tests/test_megakernel.py:74-77."""
    d = np.abs(ref - got).max(axis=-1)
    assert (d > 1e-3).mean() < 2e-3
    assert np.abs(ref - got).mean() < 1e-3
    assert abs(ref.mean() - got.mean()) < 1e-3


# The condition is a string, so it is evaluated when the test runs, not
# when the module is imported.
@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card (the kernel has no CPU mode)")
def test_cuda_kernel_matches_plain():
    width, height = 160, 120
    pack, parsed = load_scene(BLOB_BOX)
    bricks = BrickSet.from_pack(pack).to("cuda")
    cd = torch.from_numpy(camera_ray_data(Camera.from_parsed(parsed.camera),
                                          width, height)).to("cuda")
    n = brickkernel.tile_grid(width, height)
    for depth, check in ((4, _wave_check), (12, _deep_check)):
        before = brickkernel.render_bricks_cuda.launches
        got = brickkernel.render_samples_bricks(bricks, cd, width, height, 0,
                                                2, max_depth=depth)
        torch.cuda.synchronize()
        assert brickkernel.render_bricks_cuda.launches == before + 1
        ref = brickkernel.render_tiles_bricks_plain(bricks, cd, width,
                                                    height, 0, n, 0, 2,
                                                    max_depth=depth)
        check(got.cpu().numpy(), ref.cpu().numpy())
    # a tile range on the card leaves the other tiles at 0
    part = brickkernel.render_tiles_bricks(bricks, cd, width, height, 1, 2, 0,
                                           1, max_depth=2)
    pix = brickkernel.tile_pixels(width, height, 1, 2, "cuda")
    rest = torch.ones(width * height, dtype=torch.bool, device="cuda")
    rest[pix] = False
    assert float(part.reshape(-1, 3)[rest].abs().max()) == 0.0
    assert float(part.reshape(-1, 3)[pix].mean()) > 0.0


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card (the kernel has no CPU mode)")
def test_cuda_renderer_bricks_mode_launches_b6():
    config = RenderConfig(max_depth=4, large_scene_mode="bricks")
    r = ProgressiveRenderer.from_xml(BLOB_BOX, config, width=64, height=48,
                                     device="cuda")
    b6, b2 = (brickkernel.render_bricks_cuda.launches,
              wavefront.trace_bricks_cuda.launches)
    for _ in range(3):
        r.step(sync=True)
    assert brickkernel.render_bricks_cuda.launches == b6 + 3
    assert wavefront.trace_bricks_cuda.launches == b2
    assert np.isfinite(r.hdr()).all() and r.hdr().mean() > 0.0
