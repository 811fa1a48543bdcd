"""The port's progressive renderer and offline CLI on the CPU.

Accumulation, camera-epsilon and samples-per-frame resets and the
checkpoint behave as in the JAX package's renderer, and after two frames
its image matches the JAX ProgressiveRenderer (its "xla" mode on the CPU)
to the shallow criterion of tests/test_megakernel.py:57-60.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pathtracer_cuda_interactive_tpu.render.renderer import (
    ProgressiveRenderer as JaxProgressiveRenderer)
from pathtracer_cuda_interactive_tpu.utils.config import (
    RenderConfig as JaxRenderConfig)
from pathtracer_cuda_interactive_tpu_torch import SCENES_DIR
from pathtracer_cuda_interactive_tpu_torch.models.device_scene import (
    DeviceScene)
from pathtracer_cuda_interactive_tpu_torch.models.scenepack import (
    load_scene, pack_scene)
from pathtracer_cuda_interactive_tpu_torch.ops.camera import Camera
from pathtracer_cuda_interactive_tpu_torch.render import (
    offline, profile_wavefront)
from pathtracer_cuda_interactive_tpu_torch.render.renderer import (
    ProgressiveRenderer, _render_mode)
from pathtracer_cuda_interactive_tpu_torch.utils import image
from pathtracer_cuda_interactive_tpu_torch.utils.config import RenderConfig

W, H = 32, 24
CBOX = str(SCENES_DIR / "cbox_rect.xml")
BLOB_BOX = str(SCENES_DIR / "blob_box.xml")
SHALLOW = RenderConfig(max_depth=4)


def _renderer(config=SHALLOW, path=CBOX):
    return ProgressiveRenderer.from_xml(path, config, width=W, height=H,
                                        device="cpu")


def _moved(cam: Camera, dz: float) -> Camera:
    return Camera(cam.lookfrom[:2] + (cam.lookfrom[2] + dz,), cam.lookat,
                  cam.up, cam.vfov)


def test_two_single_steps_equal_one_double_step():
    a = _renderer()
    a.step(1)
    a.step(1)
    b = _renderer()
    b.step(2)
    assert a.sample_count == b.sample_count == 2
    assert torch.equal(a.accum, b.accum)
    assert a.accum.shape == (H, W, 3) and a.accum.dtype == torch.float32
    assert a.frame_ms > 0.0


def test_camera_epsilon_and_spf_reset():
    r = _renderer()
    r.step()
    assert r.sample_count == r.config.samples_per_frame == 2
    before = r.accum.clone()
    r.set_camera(_moved(r.camera, 5e-6))          # under 1e-5: kept
    assert r.sample_count == 2 and torch.equal(r.accum, before)
    r.set_camera(_moved(r.camera, 1e-3))          # a real move: reset
    assert r.sample_count == 0 and float(r.accum.abs().max()) == 0.0
    r.step()
    r.set_samples_per_frame(2)                    # unchanged: kept
    assert r.sample_count == 2
    r.set_samples_per_frame(4)
    assert r.sample_count == 0 and r.samples_per_frame == 4
    r.step()
    assert r.sample_count == 4
    r.reset_camera()
    assert r.sample_count == 0 and r.camera == r.initial_camera


def test_checkpoint_round_trip(tmp_path):
    r = _renderer()
    r.step(3)
    r.set_camera(_moved(r.camera, 1e-3))
    r.step(2)
    path = str(tmp_path / "ck.npz")
    r.save_checkpoint(path)
    s = _renderer()
    s.load_checkpoint(path)
    assert s.sample_count == 2
    assert s.camera.almost_equal(r.camera)
    assert torch.equal(s.accum, r.accum)
    np.testing.assert_array_equal(s.framebuffer(), r.framebuffer())
    # resuming continues the same sample streams
    r.step(1)
    s.step(1)
    assert torch.equal(s.accum, r.accum)


def test_two_frames_match_jax_renderer():
    jax_r = JaxProgressiveRenderer.from_xml(
        CBOX, JaxRenderConfig(max_depth=4), width=W, height=H)
    assert jax_r.mode == "xla"
    r = _renderer()
    for _ in range(2):
        jax_r.step()
        r.step()
    ref, got = jax_r.hdr(), r.hdr()
    assert got.dtype == np.float32 and got.shape == ref.shape == (H, W, 3)
    bad = ~np.isclose(got, ref, rtol=1e-4, atol=1e-4)
    assert bad.sum() <= max(1e-4 * bad.size, 2)
    assert np.abs(got - ref).mean() < 1e-4


def test_png_output(tmp_path):
    r = _renderer(path=str(SCENES_DIR / "spheres.xml"))
    r.step(2)
    path = str(tmp_path / "out.png")
    r.save_png(path)
    img = image.read_png(path)
    np.testing.assert_array_equal(img, r.framebuffer())
    assert img.shape == (H, W, 3) and img.std() > 0


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ProgressiveRenderer.from_xml(CBOX, width=W, height=H, device="cuda")


def test_large_scene_takes_the_wavefront_and_matches_jax():
    """blob_box (5,133 primitives) takes the sorted wavefront; two steps of
    one sample equal the JAX render_samples_wavefront of two samples (its
    Pallas kernel in interpret mode), at the criterion of
    tests/test_wavefront.py:37-39."""
    import jax.numpy as jnp
    from pathtracer_cuda_interactive_tpu.models import native as jax_native
    from pathtracer_cuda_interactive_tpu.models.bricks import (
        BrickSet as JaxBrickSet)
    from pathtracer_cuda_interactive_tpu.models.scenepack import (
        load_scene as jax_load_scene)
    from pathtracer_cuda_interactive_tpu.ops import camera as jax_camera
    from pathtracer_cuda_interactive_tpu.ops.wavefront import (
        render_samples_wavefront)
    config = RenderConfig(max_depth=3, samples_per_frame=1)
    r = ProgressiveRenderer.from_xml(BLOB_BOX, config, width=W, height=H,
                                     device="cpu")
    assert r.mode == "wavefront"
    r.step()
    waves = r.waves
    assert waves == 3          # one wave per depth, no NEE
    r.step()
    assert r.sample_count == 2 and r.waves == 2 * waves
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "build_sah_treelets_native",
                   lambda *args: None)
        pack, parsed = jax_load_scene(BLOB_BOX)
        bricks = JaxBrickSet.from_pack(pack)
    cd = jnp.asarray(jax_camera.camera_ray_data(
        jax_camera.Camera.from_parsed(parsed.camera), W, H))
    ref = np.asarray(render_samples_wavefront(bricks, cd, W, H, 0, 2,
                                              max_depth=3, interpret=True))
    got = r.accum.numpy()
    bad = ~np.isclose(got, ref, rtol=1e-4, atol=1e-4)
    assert bad.mean() < 1e-3 and np.abs(got - ref).mean() < 1e-3
    assert ref.mean() > 0.0


def _sphere_grid(ir):
    """513 spheres (one more than the megakernel takes) and no triangle,
    built from the ``ir`` module of either package."""
    spheres = [ir.ParsedSphere(0, -1, np.array([(i % 23) * 0.5 - 5.5,
                                                (i // 23) * 0.5 - 5.5, -9],
                                               np.float32), 0.3)
               for i in range(513)]
    return ir.ParsedScene(
        ir.ParsedCamera(np.zeros(3, np.float32),
                        np.array([0, 0, -1], np.float32),
                        np.array([0, 1, 0], np.float32), 60.0, W, H),
        [ir.ParsedDiffuse(np.full(3, 0.5, np.float32))], [], spheres,
        np.full(3, 0.8, np.float32), 4)


def test_large_sphere_scene_takes_the_plain_path():
    """More than 512 primitives and no triangle: the plain integrator with
    the BVH walk (the JAX package's "xla" mode).  Its first hits equal the
    JAX renderer's; deeper, its frames are the integrator's own sums.  (On
    this dense grid secondary rays graze neighbouring spheres, where XLA's
    fused multiply-adds flip single hits, so deeper frames are not held to
    the JAX package here; tests/test_torch_wavefront.py does that on the
    large triangle scene.)"""
    from pathtracer_cuda_interactive_tpu.models import ir as jax_ir
    from pathtracer_cuda_interactive_tpu.models.scenepack import (
        pack_scene as jax_pack_scene)
    from pathtracer_cuda_interactive_tpu.ops.camera import (
        Camera as JaxCamera)
    from pathtracer_cuda_interactive_tpu_torch.models import ir
    from pathtracer_cuda_interactive_tpu_torch.ops import integrator
    cam = Camera((0.0, 0.0, 0.0), (0.0, 0.0, -1.0), (0.0, 1.0, 0.0), 60.0)
    pack = pack_scene(_sphere_grid(ir))
    r = ProgressiveRenderer(pack, cam, W, H, RenderConfig(max_depth=1),
                            device="cpu")
    assert r.mode == "plain"
    jax_r = JaxProgressiveRenderer(
        jax_pack_scene(_sphere_grid(jax_ir)),
        JaxCamera(cam.lookfrom, cam.lookat, cam.up, cam.vfov), W, H,
        JaxRenderConfig(max_depth=1))
    assert jax_r.mode == "xla"
    for _ in range(2):
        r.step()
        jax_r.step()
    ref, got = jax_r.hdr(), r.hdr()
    assert ref.mean() > 0.0 and ref.std() > 0.0
    bad = ~np.isclose(got, ref, rtol=1e-4, atol=1e-4)
    assert bad.sum() <= max(1e-4 * bad.size, 2)
    assert np.abs(got - ref).mean() < 1e-4

    deep = ProgressiveRenderer(pack, cam, W, H, RenderConfig(max_depth=3),
                               device="cpu")
    deep.step()
    assert torch.equal(deep.accum, integrator.render_samples(
        deep.scene, deep._cam_data, W, H, 0, 2, max_depth=3))
    assert deep.waves == 0


def _device_scene(which):
    """(ScenePack, its DeviceScene, camera) of the small Cornell box, of
    blob_box (5,133 primitives) or of the 513-sphere grid."""
    from pathtracer_cuda_interactive_tpu_torch.models import ir
    if which == "spheres513":
        pack = pack_scene(_sphere_grid(ir))
        cam = Camera((0.0, 0.0, 0.0), (0.0, 0.0, -1.0), (0.0, 1.0, 0.0), 60.0)
    else:
        pack, parsed = load_scene(CBOX if which == "cbox" else BLOB_BOX)
        cam = Camera.from_parsed(parsed.camera)
    return pack, DeviceScene.from_pack(pack), cam


@pytest.mark.parametrize("which,large_scene_mode,mode", [
    ("cbox", "wavefront", "megakernel"), ("cbox", "bricks", "megakernel"),
    ("spheres513", "wavefront", "plain"), ("blob", "wavefront", "plain"),
    ("blob", "bricks", "plain"), ("blob", "mx2", "plain")])
def test_render_mode_of_a_prebuilt_device_scene(which, large_scene_mode,
                                                mode):
    """A DeviceScene holds no bricks: at most 512 primitives take the
    megakernel, more the plain integrator, whatever the large-scene mode
    (the JAX renderer sends such a scene to "xla")."""
    _, scene, _ = _device_scene(which)
    assert _render_mode(scene, large_scene_mode) == mode
    with pytest.raises(ValueError, match="unknown large_scene_mode"):
        _render_mode(scene, "nope")


@pytest.mark.parametrize("which,mode", [("cbox", "megakernel"),
                                        ("spheres513", "plain")])
def test_prebuilt_device_scene_renders_like_its_pack(which, mode):
    pack, scene, cam = _device_scene(which)
    config = RenderConfig(max_depth=3)
    ours = ProgressiveRenderer(scene, cam, W, H, config, device="cpu")
    ref = ProgressiveRenderer(pack, cam, W, H, config, device="cpu")
    assert ours.mode == ref.mode == mode
    assert isinstance(ours.scene, DeviceScene)
    for _ in range(2):
        ours.step()
        ref.step()
    assert ours.sample_count == 4 and torch.equal(ours.accum, ref.accum)
    assert float(ours.accum.mean()) > 0.0 and float(ours.accum.std()) > 0.0


def test_prebuilt_large_device_scene_matches_the_wavefront():
    """blob_box as a DeviceScene takes the plain integrator; as a ScenePack
    the sorted wavefront.  The two images agree at the criterion of
    tests/test_wavefront.py:37-39."""
    pack, scene, cam = _device_scene("blob")
    config = RenderConfig(max_depth=3, samples_per_frame=1)
    ours = ProgressiveRenderer(scene, cam, W, H, config, device="cpu")
    ref = ProgressiveRenderer(pack, cam, W, H, config, device="cpu")
    assert (ours.mode, ref.mode) == ("plain", "wavefront")
    ours.step()
    ref.step()
    got, want = ours.accum.numpy(), ref.accum.numpy()
    bad = ~np.isclose(got, want, rtol=1e-4, atol=1e-4)
    assert bad.mean() < 1e-3 and np.abs(got - want).mean() < 1e-3
    assert want.mean() > 0.0 and ours.waves == 0


def test_config_matches_the_jax_defaults():
    ours = dataclasses.asdict(RenderConfig())
    theirs = dataclasses.asdict(JaxRenderConfig())
    for key, value in ours.items():
        assert theirs[key] == value, key
    # the viewer's fields return with the viewer; the compaction ladder's
    # have no counterpart (the port compacts after every wave)
    assert set(theirs) - set(ours) == {
        "fov_min", "fov_max", "move_speed", "mouse_sensitivity",
        "wavefront_compact_tail", "wavefront_tail_trace"}


def test_offline_cli_writes_png(tmp_path, capsys):
    out = tmp_path / "cli.png"
    ck = tmp_path / "cli.npz"
    assert offline.main([str(SCENES_DIR / "pointlight.xml"), "--device", "cpu",
                         "--spp", "3", "--batch", "2", "--width", str(W),
                         "--height", str(H), "--max-depth", "3", "--nee",
                         "-o", str(out), "--checkpoint", str(ck)]) == 0
    img = image.read_png(str(out))
    assert img.shape == (H, W, 3) and img.mean() > 0
    with np.load(ck) as data:
        assert int(data["sample_count"]) == 3
    assert "Rendered 3 spp" in capsys.readouterr().out


def test_offline_cli_renders_the_large_scene(tmp_path, capsys):
    out = tmp_path / "blob.png"
    assert offline.main([BLOB_BOX, "--device", "cpu", "--spp", "2",
                         "--batch", "1", "--width", str(W), "--height",
                         str(H), "--max-depth", "3", "--nee",
                         "-o", str(out)]) == 0
    img = image.read_png(str(out))
    assert img.shape == (H, W, 3) and img.mean() > 0 and img.std() > 0
    text = capsys.readouterr().out
    assert "5133 primitives" in text and "Rendered 2 spp" in text


def test_profile_wavefront_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        profile_wavefront.main([])
