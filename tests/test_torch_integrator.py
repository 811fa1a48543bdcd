"""The port's plain path tracer (ops/integrator.py) against the JAX
package's integrator, on the in-repo scenes.

Both run the same RNG streams and the same bounce logic, so images agree
to float32 rounding.  The JAX side is jitted, and XLA contracts a*b+c into
FMAs where torch rounds twice, so a 1-ulp difference can flip a discrete
event (a triangle-edge hit, an RR survival) on isolated pixels:

* shallow (2 spp, depth 4), the criterion of tests/test_megakernel.py:57-60:
  at most max(1e-4 of the elements, 2 elements) outside rtol = atol = 1e-4
  (at 32x24x3 a bare 1e-4 share would allow none), and a mean absolute
  error below 1e-4;
* deep (depth 12), statistical as at tests/test_megakernel.py:74-77.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pathtracer_cuda_interactive_tpu.models.device_scene import (
    DeviceScene as JaxDeviceScene)
from pathtracer_cuda_interactive_tpu.models.scenepack import (
    load_scene as jax_load_scene)
from pathtracer_cuda_interactive_tpu.ops import integrator as jax_integrator
from pathtracer_cuda_interactive_tpu.ops.camera import (
    Camera as JaxCamera, camera_ray_data as jax_camera_ray_data)
from pathtracer_cuda_interactive_tpu_torch import SCENES_DIR
from pathtracer_cuda_interactive_tpu_torch.models.device_scene import (
    DeviceScene)
from pathtracer_cuda_interactive_tpu_torch.models.ir import (
    ParsedCamera, ParsedDiffuse, ParsedDiffuseAreaLight, ParsedMirror,
    ParsedScene, ParsedSphere)
from pathtracer_cuda_interactive_tpu_torch.models.scenepack import (
    load_scene, pack_scene)
from pathtracer_cuda_interactive_tpu_torch.ops import integrator, rng
from pathtracer_cuda_interactive_tpu_torch.ops.camera import (
    Camera, camera_ray_data)
from pathtracer_cuda_interactive_tpu_torch.ops.vec import Vec3

W, H = 32, 24
# (scene, NEE on): the point-light scene exercises NEE's shadow rays
CASES = [("spheres", False), ("cbox_rect", False), ("pointlight", True)]


def load_pair(name):
    """The same scene file as (JAX scene, JAX camera data, port scene,
    port camera data) at W x H."""
    path = str(SCENES_DIR / f"{name}.xml")
    jpack, jparsed = jax_load_scene(path)
    pack, parsed = load_scene(path)
    jcd = jnp.asarray(jax_camera_ray_data(
        JaxCamera.from_parsed(jparsed.camera), W, H))
    cd = torch.from_numpy(camera_ray_data(Camera.from_parsed(parsed.camera),
                                          W, H))
    return JaxDeviceScene.from_pack(jpack), jcd, DeviceScene.from_pack(pack), cd


def assert_shallow_parity(got, ref):
    bad = ~np.isclose(got, ref, rtol=1e-4, atol=1e-4)
    assert bad.sum() <= max(1e-4 * bad.size, 2), \
        f"{bad.sum()} of {bad.size} elements mismatch"
    assert np.abs(ref - got).mean() < 1e-4


def assert_deep_parity(got, ref):
    d = np.abs(ref - got).max(axis=-1)
    assert (d > 1e-3).mean() < 2e-3       # <0.2% of pixels flipped
    assert np.abs(ref - got).mean() < 1e-3
    assert abs(ref.mean() - got.mean()) < 1e-3


@pytest.mark.parametrize("name,nee", CASES)
def test_render_samples_matches_jax_shallow(name, nee):
    jscene, jcd, scene, cd = load_pair(name)
    ref = np.asarray(jax_integrator.render_samples(
        jscene, jcd, W, H, 0, 2, max_depth=4, nee=nee))
    got = integrator.render_samples(scene, cd, W, H, 0, 2, max_depth=4,
                                    nee=nee).numpy()
    assert got.shape == (H, W, 3)
    assert ref.mean() > 0.0
    assert_shallow_parity(got, ref)


@pytest.mark.parametrize("name,nee", CASES)
def test_render_samples_matches_jax_deep_statistical(name, nee):
    jscene, jcd, scene, cd = load_pair(name)
    ref = np.asarray(jax_integrator.render_samples(
        jscene, jcd, W, H, 3, 2, max_depth=12, nee=nee))
    got = integrator.render_samples(scene, cd, W, H, 3, 2, max_depth=12,
                                    nee=nee).numpy()
    assert_deep_parity(got, ref)


def test_measure_path_stats_matches_jax():
    jscene, jcd, scene, cd = load_pair("cbox_rect")
    ref_rays, ref_samples = jax_integrator.measure_path_stats(
        jscene, jcd, W, H, 0, 2, max_depth=12)
    rays, samples = integrator.measure_path_stats(scene, cd, W, H, 0, 2,
                                                  max_depth=12)
    assert samples == float(ref_samples) == W * H * 2
    # JAX counts padding lanes and rescales; the port counts real rays
    np.testing.assert_allclose(float(rays), float(ref_rays), rtol=2e-2)
    assert 1.0 < float(rays) / samples < 12.0


def _scene(shapes, materials, lights=(), background=(0.5, 0.5, 0.5)):
    cam = ParsedCamera(np.zeros(3, np.float32),
                       np.array([0, 0, -1], np.float32),
                       np.array([0, 1, 0], np.float32), 45.0, 8, 8)
    return DeviceScene.from_pack(pack_scene(ParsedScene(
        cam, list(materials), list(lights), list(shapes),
        np.asarray(background, np.float32), 16)))


def _sphere(center, radius, material_id, area_light_id=-1):
    return ParsedSphere(material_id, area_light_id,
                        np.asarray(center, np.float32), radius)


def _rays_down_z(n):
    org = Vec3.zeros((n,))
    dirn = Vec3(torch.zeros(n), torch.zeros(n), torch.full((n,), -1.0))
    return org, dirn, rng.seed_rays(torch.arange(n, dtype=torch.int32), 0)


def _array(L: Vec3):
    return L.to_array().numpy()


def test_white_furnace():
    """White diffuse sphere under a unit-white background: every path
    escapes with throughput 1, so E[L] == 1."""
    scene = _scene([_sphere([0, 0, -3], 1.0, 0)],
                   [ParsedDiffuse(np.array([1.0] * 3, np.float32))],
                   background=(1, 1, 1))
    L = _array(integrator.radiance(scene, *_rays_down_z(512)))
    assert abs(L.mean() - 1.0) < 0.02
    assert np.isfinite(L).all()


def test_emitter_front_only_and_mirror():
    light = ParsedDiffuseAreaLight(0, np.array([2.0, 3.0, 4.0], np.float32))
    scene = _scene([_sphere([0, 0, -3], 1.0, 0, area_light_id=0)],
                   [ParsedDiffuse(np.array([0.0] * 3, np.float32))],
                   lights=[light], background=(0, 0, 0))
    L = _array(integrator.radiance(scene, *_rays_down_z(4)))
    np.testing.assert_allclose(L, np.tile([2, 3, 4], (4, 1)), atol=1e-5)
    mirror = _scene([_sphere([0, 0, -3], 1.0, 0)],
                    [ParsedMirror(np.array([1.0] * 3, np.float32))],
                    background=(0.2, 0.4, 0.8))
    L = _array(integrator.radiance(mirror, *_rays_down_z(16)))
    np.testing.assert_allclose(L, np.tile([0.2, 0.4, 0.8], (16, 1)),
                               atol=1e-5)


def test_nee_matches_analytic_inverse_square(tmp_path):
    """Unit diffuse sphere, point light above the pole at height h, camera
    looking straight down: the pole's direct radiance is
    albedo/pi * I / (h-1)^2; without NEE the image is black."""
    albedo, h, inten = 0.6, 4.0, 10.0
    xml = tmp_path / "nee.xml"
    xml.write_text(f"""<scene version="0.6.0">
      <sensor type="perspective"><float name="fov" value="45"/>
        <transform name="toWorld">
          <lookat origin="0, 3, 0" target="0, 0, 0" up="0, 0, 1"/>
        </transform>
        <film type="hdrfilm"><integer name="width" value="{W}"/>
          <integer name="height" value="{H}"/></film></sensor>
      <background><rgb name="radiance" value="0, 0, 0"/></background>
      <bsdf type="diffuse" id="m">
        <rgb name="reflectance" value="{albedo}, {albedo}, {albedo}"/></bsdf>
      <emitter type="point"><point name="position" x="0" y="{h}" z="0"/>
        <rgb name="intensity" value="{inten}, {inten}, {inten}"/></emitter>
      <shape type="sphere"><point name="center" x="0" y="0" z="0"/>
        <float name="radius" value="1"/><ref id="m"/></shape>
    </scene>""")
    pack, parsed = load_scene(str(xml))
    scene = DeviceScene.from_pack(pack)
    cd = torch.from_numpy(camera_ray_data(Camera.from_parsed(parsed.camera),
                                          W, H))
    img = integrator.render_samples(scene, cd, W, H, 0, 1, max_depth=1,
                                    nee=True).numpy()
    expect = albedo / np.pi * inten / (h - 1.0) ** 2
    np.testing.assert_allclose(img[H // 2, W // 2], expect, rtol=2e-2)
    img0 = integrator.render_samples(scene, cd, W, H, 0, 1, max_depth=1,
                                     nee=False).numpy()
    assert img0[H // 2, W // 2].max() == 0.0


def test_nee_shadow_darkens_only_the_shadow():
    """In the point-light scene the occluder's shadow lies on the big
    sphere; moving the occluder away brightens that patch and nothing
    gets darker."""
    _, _, scene, cd = load_pair("pointlight")
    with_occ = integrator.render_samples(scene, cd, W, H, 0, 1, max_depth=1,
                                         nee=True).numpy()
    occluder = scene.num_spheres - 1
    scene.sph_x[occluder] = 50.0
    scene.prim_rows[occluder, 1] = 50.0
    no_occ = integrator.render_samples(scene, cd, W, H, 0, 1, max_depth=1,
                                       nee=True).numpy()
    assert (with_occ <= no_occ + 1e-5).all()
    assert (no_occ - with_occ).max() > 0.05
