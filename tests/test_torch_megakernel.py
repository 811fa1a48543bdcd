"""The port's megakernel dispatcher (ops/megakernel.py).

On CPU tensors it runs the kernel's plain version; that is held to the JAX
package's Pallas megakernel in interpret mode, at the shallow criterion of
tests/test_megakernel.py:57-60.  The pixel-range and real-pass arguments,
the launch counter and the build's failure modes are checked here too, and
two things the kernel's design rests on: the warp's rule for a table taken
together ("smallest t, lowest id" over lanes that each hold primitives l,
l + 32, ... of the spheres and of the triangles) against the sequential
strict-< scan, and the record floats the kernel stages as its test table
against the scene's own fields.

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
from pathtracer_cuda_interactive_tpu_torch.io.xml_scene import parse_scene
from pathtracer_cuda_interactive_tpu_torch.models.scenepack import (
    load_scene, pack_scene)
from pathtracer_cuda_interactive_tpu_torch.models.subdivide import (
    table_scenes)
from pathtracer_cuda_interactive_tpu_torch.ops import integrator, megakernel
from pathtracer_cuda_interactive_tpu_torch.ops.camera import (
    Camera, camera_ray_data)

W, H = 32, 24


def _load(name, width=W, height=H, device="cpu"):
    if name in ("mixed", "full"):
        parsed = table_scenes(parse_scene(str(SCENES_DIR / "cbox_rect.xml"))
                              )[name]
        pack = pack_scene(parsed)
    else:
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


# -- the warp's rule for a table taken together ---------------------------------

def _sequential_scan(t):
    """csrc/megakernel.cu's lane-by-lane scan over per-primitive hit
    distances [rays, P] (inf: a miss): a strict t < best in id order."""
    best_t = np.full(t.shape[0], np.inf, np.float32)
    best_k = np.full(t.shape[0], -1, np.int64)
    for k in range(t.shape[1]):
        better = t[:, k] < best_t
        best_t = np.where(better, t[:, k], best_t)
        best_k = np.where(better, k, best_k)
    return best_t, best_k


def _warp_rule(t, num_spheres):
    """The same table taken by a warp together: lane l scans spheres l,
    l + 32, ... and then triangles l, l + 32, ... with its own strict <;
    then the warp takes the smallest key (the bits of t, with -0 as 0) and,
    among the lanes that hold it, the lowest id."""
    rays, P = t.shape
    ids = np.arange(P)
    lane_of = np.where(ids < num_spheres, ids, ids - num_spheres) % 32
    lane_t = np.full((rays, 32), np.inf, np.float32)
    lane_k = np.full((rays, 32), -1, np.int64)
    for k in range(P):                       # ascending id within every lane
        l = lane_of[k]
        better = t[:, k] < lane_t[:, l]
        lane_t[:, l] = np.where(better, t[:, k], lane_t[:, l])
        lane_k[:, l] = np.where(better, k, lane_k[:, l])
    bits = np.where(lane_t == 0.0, np.float32(0.0), lane_t).view(np.uint32)
    key = np.where(lane_k < 0, np.uint32(0x7f800000), bits)
    nearest = key.min(axis=1)
    k = np.where(key == nearest[:, None], lane_k.astype(np.uint32),
                 np.uint32(0xffffffff)).min(axis=1).astype(np.int32)
    holder = np.where(k < num_spheres, k, k - num_spheres) & 31
    return lane_t[np.arange(rays), holder], k.astype(np.int64)


@pytest.mark.parametrize("num_spheres,num_triangles", [
    (0, 32), (5, 0), (2, 2), (42, 128), (0, 512), (33, 1), (3, 70),
    (256, 256)])
def test_warp_rule_equals_the_sequential_scan(num_spheres, num_triangles):
    rs = np.random.default_rng(num_spheres * 1000 + num_triangles)
    rays, P = 2048, num_spheres + num_triangles
    # few distinct values, so equal t across lanes and within a lane is the
    # rule; both zeros (a sphere hit at tnear = 0 may be either)
    values = np.concatenate([rs.uniform(1e-4, 9.0, 5).astype(np.float32),
                             np.array([0.0, -0.0, 1e-38], np.float32)])
    t = values[rs.integers(0, len(values), (rays, P))]
    t[rs.random(t.shape) < min(0.9, 1.0 - 3.0 / P)] = np.inf
    if P > 40:
        t[:, P - 1] = t[:, 7]                # a forced pair across lanes
        t[:, 39] = t[:, 7]                   # and one within a lane (or not)
    t[: rays // 8] = np.inf                  # rays that miss everything
    seq_t, seq_k = _sequential_scan(t)
    got_t, got_k = _warp_rule(t, num_spheres)
    np.testing.assert_array_equal(got_k, seq_k)
    hit = seq_k >= 0
    np.testing.assert_array_equal(got_t[hit].view(np.int32),
                                  seq_t[hit].view(np.int32))
    ties = (t == seq_t[:, None]).sum(axis=1) > 1
    assert (ties & hit).mean() > 0.05        # ties were decided
    assert hit.any() and (~hit).any()


@pytest.mark.parametrize("name", ["spheres", "cbox_rect", "pointlight",
                                  "mixed", "full"])
def test_records_hold_what_the_kernel_stages(name):
    """The kernel builds its test table from floats 1..4 of a sphere's
    record (centre, radius) and 1..9 of a triangle's (p0, e1, e2): they are
    the scene's own fields, and they move with ``DeviceScene.to``."""
    scene, _ = _load(name)
    S, F = scene.num_spheres, scene.num_triangles
    rows = scene.prim_rows
    assert rows.shape[0] >= S + F and rows.shape[1] == 32
    assert rows.data_ptr() % 16 == 0
    sph = torch.stack([scene.sph_x, scene.sph_y, scene.sph_z, scene.sph_rad],
                      dim=1)
    tri = torch.stack([scene.tri_p0x, scene.tri_p0y, scene.tri_p0z,
                       scene.tri_e1x, scene.tri_e1y, scene.tri_e1z,
                       scene.tri_e2x, scene.tri_e2y, scene.tri_e2z], dim=1)
    assert torch.equal(rows[:S, 1:5], sph)
    assert torch.equal(rows[S:S + F, 1:10], tri)
    assert torch.equal(rows[:S, 0], torch.full((S,), 2.0))
    assert torch.equal(rows[S:S + F, 0], torch.full((F,), 1.0))
    moved = scene.to("cpu")
    assert moved.prim_rows is not None
    assert torch.equal(moved.prim_rows, rows)
    assert (S + F <= megakernel.MEGAKERNEL_MAX_PRIMS)


@pytest.mark.parametrize("name", ["mixed", "full"])
def test_larger_tables_render_like_the_plain_integrator(name):
    """The dispatcher on the two larger tables (42 spheres with 128
    triangles; 512 triangles): on CPU tensors the plain version, whole and
    in pixel ranges."""
    scene, cd = _load(name, 16, 12)
    got = megakernel.render_samples_megakernel(scene, cd, 16, 12, 0, 2,
                                               max_depth=3)
    ref = integrator.render_samples(scene, cd, 16, 12, 0, 2, max_depth=3)
    assert torch.equal(got, ref)
    assert float(got.mean()) > 0.0 and bool(torch.isfinite(got).all())
    part = megakernel.render_pixels_megakernel(scene, cd, 16, 12, 37, 50, 0,
                                               2, max_depth=3)
    assert torch.equal(part, got.reshape(-1, 3)[37:87])


# The condition is a string, so it is evaluated when the test runs, not
# when the module is imported.
@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card (the kernel has no CPU mode)")
@pytest.mark.parametrize("name,nee", [("spheres", False),
                                      ("cbox_rect", False),
                                      ("pointlight", True),
                                      ("mixed", False),
                                      ("full", False)])
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
