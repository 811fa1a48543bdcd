"""The port's megakernel dispatcher (ops/megakernel.py).

On CPU tensors it runs the kernel's plain version; that is held to the JAX
package's Pallas megakernel in interpret mode, at the shallow criterion of
tests/test_megakernel.py:57-60.  The pixel-range and real-pass arguments,
the launch counter and the build's failure modes are checked here too.

The CUDA kernel itself runs only on a card: the cases marked ``cuda`` skip
without one.  They import no jax, so on the card they run with
``python -m pytest --noconftest -m cuda tests/test_torch_megakernel.py``.
"""

import numpy as np
import pytest
import torch

from pathtracer_cuda_interactive_tpu_torch import SCENES_DIR
from pathtracer_cuda_interactive_tpu_torch.models.device_scene import (
    DeviceScene)
from pathtracer_cuda_interactive_tpu_torch.models.scenepack import load_scene
from pathtracer_cuda_interactive_tpu_torch.ops import integrator, megakernel
from pathtracer_cuda_interactive_tpu_torch.ops.camera import (
    Camera, camera_ray_data)

W, H = 32, 24


def _load(name, width=W, height=H, device="cpu"):
    pack, parsed = load_scene(str(SCENES_DIR / f"{name}.xml"))
    cd = camera_ray_data(Camera.from_parsed(parsed.camera), width, height)
    return (DeviceScene.from_pack(pack).to(device),
            torch.from_numpy(cd).to(device))


def _jax_pallas(name, num_samples, max_depth, nee):
    """The JAX package's Pallas megakernel in interpret mode (imported here
    so the cuda cases run where jax is not installed)."""
    import jax.numpy as jnp
    from pathtracer_cuda_interactive_tpu.models.device_scene import (
        DeviceScene as JaxDeviceScene)
    from pathtracer_cuda_interactive_tpu.models.scenepack import (
        load_scene as jax_load_scene)
    from pathtracer_cuda_interactive_tpu.ops import camera as jcamera
    from pathtracer_cuda_interactive_tpu.ops.megakernel import (
        render_samples_pallas)
    pack, parsed = jax_load_scene(str(SCENES_DIR / f"{name}.xml"))
    cd = jnp.asarray(jcamera.camera_ray_data(
        jcamera.Camera.from_parsed(parsed.camera), W, H))
    return np.asarray(render_samples_pallas(
        JaxDeviceScene.from_pack(pack), cd, W, H, 0, num_samples,
        max_depth=max_depth, interpret=True, nee=nee))


def assert_shallow_parity(got, ref):
    bad = ~np.isclose(got, ref, rtol=1e-4, atol=1e-4)
    assert bad.sum() <= max(1e-4 * bad.size, 2), \
        f"{bad.sum()} of {bad.size} elements mismatch"
    assert np.abs(ref - got).mean() < 1e-4


def assert_deep_parity(got, ref):
    d = np.abs(ref - got).max(axis=-1)
    assert (d > 1e-3).mean() < 2e-3
    assert np.abs(ref - got).mean() < 1e-3
    assert abs(ref.mean() - got.mean()) < 1e-3


@pytest.mark.parametrize("name,nee", [("spheres", False),
                                      ("cbox_rect", False),
                                      ("pointlight", True),
                                      ("pointlight", False)])
def test_cpu_dispatch_matches_jax_pallas(name, nee):
    scene, cd = _load(name)
    got = megakernel.render_samples_megakernel(
        scene, cd, W, H, 0, 2, max_depth=4, nee=nee).numpy()
    ref = _jax_pallas(name, 2, 4, nee)
    assert got.shape == ref.shape == (H, W, 3)
    assert_shallow_parity(got, ref)


def test_nee_adds_light_only():
    scene, cd = _load("pointlight")
    on = megakernel.render_samples_megakernel(scene, cd, W, H, 0, 2,
                                              max_depth=3, nee=True)
    off = megakernel.render_samples_megakernel(scene, cd, W, H, 0, 2,
                                               max_depth=3, nee=False)
    assert bool((on >= off - 1e-6).all())
    assert float((on - off).max()) > 0.05


def test_sample_start_decorrelates_and_reproduces():
    scene, cd = _load("spheres")
    a = megakernel.render_samples_megakernel(scene, cd, W, H, 0, 1,
                                             max_depth=4)
    b = megakernel.render_samples_megakernel(scene, cd, W, H, 1, 1,
                                             max_depth=4)
    a2 = megakernel.render_samples_megakernel(scene, cd, W, H, 0, 1,
                                              max_depth=4)
    assert float((a - b).abs().max()) > 1e-3
    assert torch.equal(a, a2)


def test_pixel_range_and_real_passes_slice_a_full_render():
    scene, cd = _load("cbox_rect")
    full = megakernel.render_samples_megakernel(scene, cd, W, H, 5, 2,
                                                max_depth=6).reshape(-1, 3)
    pix0, count = 100, 300
    part = megakernel.render_pixels_megakernel(
        scene, cd, W, H, pix0, count, 5, num_samples=3, max_depth=6,
        num_real=2)
    assert part.shape == (count, 3)
    assert torch.equal(part, full[pix0:pix0 + count])
    # passes add up: 2 passes from 5 plus 1 from 7 equal 3 from 5
    three = megakernel.render_pixels_megakernel(scene, cd, W, H, 0, W * H,
                                                5, 3, max_depth=6)
    one = megakernel.render_pixels_megakernel(scene, cd, W, H, 0, W * H, 7,
                                              1, max_depth=6)
    torch.testing.assert_close(full + one, three, rtol=1e-6, atol=1e-6)


def test_cpu_render_launches_no_kernel():
    scene, cd = _load("spheres")
    before = megakernel.megakernel_cuda.launches
    megakernel.render_samples_megakernel(scene, cd, W, H, 0, 1, max_depth=2)
    assert megakernel.megakernel_cuda.launches == before == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    scene, cd = _load("spheres")
    bg = torch.stack([scene.bg_r, scene.bg_g, scene.bg_b])
    with pytest.raises(ValueError, match="CUDA"):
        megakernel.megakernel_cuda(
            scene.prim_rows, scene.num_spheres, scene.num_triangles, None,
            cd.reshape(12), bg, W, H, 0, W * H, 0, 1, -1, 1984, 4, 5)
    assert megakernel.megakernel_cuda.launches == 0


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(megakernel, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        megakernel.build()


def test_too_many_primitives_rejected():
    scene, cd = _load("cbox_rect")
    scene.num_triangles = megakernel.MEGAKERNEL_MAX_PRIMS + 1
    with pytest.raises(ValueError, match="exceed"):
        megakernel.render_samples_megakernel(scene, cd, W, H, 0, 1)


# The condition is a string, so it is evaluated when the test runs, not
# when the module is imported.
@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card (the kernel has no CPU mode)")
@pytest.mark.parametrize("name,nee", [("spheres", False),
                                      ("cbox_rect", False),
                                      ("pointlight", True)])
def test_cuda_kernel_matches_plain(name, nee):
    width, height = 160, 120
    scene, cd = _load(name, width, height, "cuda")
    for depth, check in ((4, assert_shallow_parity),
                         (12, assert_deep_parity)):
        before = megakernel.megakernel_cuda.launches
        got = megakernel.render_samples_megakernel(
            scene, cd, width, height, 0, 2, max_depth=depth, nee=nee)
        torch.cuda.synchronize()
        assert megakernel.megakernel_cuda.launches == before + 1
        ref = integrator.render_samples(scene, cd, width, height, 0, 2,
                                        max_depth=depth, nee=nee)
        check(got.cpu().numpy(), ref.cpu().numpy())
