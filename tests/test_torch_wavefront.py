"""The port's large-scene path against the JAX package, on the CPU.

* the skip-link BVH walk (ops/trace.py) against the JAX walk, on the same
  BVH;
* the plain version of kernel B2 (ops/brickkernel.py::trace_bricks_plain)
  against the JAX Pallas kernel in interpret mode
  (``_trace_wave_slim(..., interpret=True)``), on the same BrickSet;
* the plain integrator on the large scene, at the criterion of
  tests/test_torch_integrator.py;
* the sort keys, the wave layout and the winner-record epilogue, exactly or
  to float32 rounding; sample splits and reproducibility; the engine names
  and the large-scene modes (every one renders) and the engines' parser.

The JAX side is jitted, and XLA contracts a*b+c into FMAs where torch
rounds twice, so a ray through a shared triangle edge (|u + v - 1| near
1e-6) may hit the other triangle, or slip between the two on one side: at
most 1e-3 of the rays of a wave may differ.  (With the random rays below
one ray of 2048 does: u + v = 0.9999985 on the port's side.)  The sorted
wavefront renders are compared in tests/test_torch_wavefront_render.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pathtracer_cuda_interactive_tpu.models import native as jax_native
from pathtracer_cuda_interactive_tpu.models.bricks import (
    BrickSet as JaxBrickSet)
from pathtracer_cuda_interactive_tpu.models.device_scene import (
    DeviceScene as JaxDeviceScene)
from pathtracer_cuda_interactive_tpu.models.scenepack import (
    load_scene as jax_load_scene)
from pathtracer_cuda_interactive_tpu.ops import integrator as jax_integrator
from pathtracer_cuda_interactive_tpu.ops import trace as jax_trace
from pathtracer_cuda_interactive_tpu.ops import wavefront as jax_wavefront
from pathtracer_cuda_interactive_tpu.ops.camera import (
    Camera as JaxCamera, camera_ray_data as jax_camera_ray_data)
from pathtracer_cuda_interactive_tpu.ops.vec import Vec3 as JaxVec3
from pathtracer_cuda_interactive_tpu_torch import SCENES_DIR
from pathtracer_cuda_interactive_tpu_torch.models.bricks import BrickSet
from pathtracer_cuda_interactive_tpu_torch.models.device_scene import (
    DeviceScene)
from pathtracer_cuda_interactive_tpu_torch.models.scenepack import load_scene
from pathtracer_cuda_interactive_tpu_torch.ops import (
    brickkernel, integrator, pairtrace, trace, wave_step, wavefront)
from pathtracer_cuda_interactive_tpu_torch.ops.camera import (
    Camera, camera_ray_data)
from pathtracer_cuda_interactive_tpu_torch.ops.vec import Vec3
from pathtracer_cuda_interactive_tpu_torch.render.renderer import (
    ProgressiveRenderer)
from pathtracer_cuda_interactive_tpu_torch.utils.config import RenderConfig

# The suite runs in several worker processes at once and these tensors are
# small: one intra-op thread per process keeps the workers from spinning
# against each other for the machine's cores.
torch.set_num_threads(1)

W, H = 32, 24
BLOB_BOX = str(SCENES_DIR / "blob_box.xml")


def _numpy_fields(obj):
    return {f.name: (getattr(obj, f.name) if isinstance(getattr(obj, f.name),
                                                         int)
                     else np.asarray(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def blob():
    """blob_box as (JAX DeviceScene, JAX BrickSet, JAX camera data, port
    DeviceScene, port BrickSet, port camera data); the port's scenes are
    built from the JAX fields, so both sides walk the same trees."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "build_sah_treelets_native",
                   lambda *args: None)
        jpack, jparsed = jax_load_scene(BLOB_BOX)
        jscene = JaxDeviceScene.from_pack(jpack)
        jbricks = JaxBrickSet.from_pack(jpack)
    jcd = jnp.asarray(jax_camera_ray_data(
        JaxCamera.from_parsed(jparsed.camera), W, H))
    _, parsed = load_scene(BLOB_BOX)
    cd = torch.from_numpy(camera_ray_data(Camera.from_parsed(parsed.camera),
                                          W, H))
    return (jscene, jbricks, jcd, DeviceScene.from_numpy(_numpy_fields(jscene)),
            BrickSet.from_numpy(**_numpy_fields(jbricks)), cd)


def _random_rays(n=2048, seed=0):
    """Rays from inside the box toward the blob; the first 64 run straight
    down (an axis-parallel direction) from origins on the ceiling plane,
    where the slab test computes 0 * inf = NaN."""
    rs = np.random.default_rng(seed)
    o = rs.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 1.5], (n, 3))
    tgt = rs.uniform([-0.7, 0.1, -0.7], [0.2, 1.1, 0.35], (n, 3))
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:64] = [0.0, -1.0, 0.0]
    o[:64, 1] = 2.0
    return o.astype(np.float32), d.astype(np.float32)


def _vec(a, shape=None):
    cols = [np.ascontiguousarray(c) for c in a.T]
    if shape is not None:
        return JaxVec3(*(jnp.asarray(c.reshape(shape)) for c in cols))
    return Vec3(*(torch.from_numpy(c) for c in cols))


def test_trace_rays_matches_jax(blob):
    jscene, _, _, scene, _, _ = blob
    o, d = _random_rays()
    ref_prim, ref_t = jax_trace.trace_rays(
        jscene.bvh_nodes, _vec(o, (16, 128)), _vec(d, (16, 128)), 0.0)
    prim, t = trace.trace_rays(scene.bvh_nodes, _vec(o), _vec(d), 0.0)
    prim, t = prim.numpy(), t.numpy()
    ref_prim, ref_t = (np.asarray(ref_prim).reshape(-1),
                       np.asarray(ref_t).reshape(-1))
    same = prim == ref_prim
    assert (~same).mean() <= 1e-3, f"{(~same).sum()} rays differ"
    hit = same & (prim >= 0)
    assert hit.mean() > 0.9
    np.testing.assert_allclose(t[hit], ref_t[hit], rtol=1e-6, atol=1e-6)


def test_trace_occluded_matches_jax(blob):
    jscene, _, _, scene, _, _ = blob
    o, d = _random_rays(seed=1)
    limit = np.random.default_rng(2).uniform(0.05, 2.0, len(o))
    limit = limit.astype(np.float32)
    ref = jax_trace.trace_occluded(
        jscene.bvh_nodes, _vec(o, (16, 128)), _vec(d, (16, 128)), 1e-4,
        jnp.asarray(limit.reshape(16, 128)))
    got = trace.trace_occluded(scene.bvh_nodes, _vec(o), _vec(d), 1e-4,
                               torch.from_numpy(limit)).numpy()
    assert (got != np.asarray(ref).reshape(-1)).mean() <= 1e-3
    assert 0.05 < got.mean() < 0.95


def _jax_b2(jbricks, o, d, tnear):
    """The JAX slim trace kernel B2 in interpret mode on one [16, 128]
    wave."""
    args = [jnp.asarray(np.ascontiguousarray(c).reshape(16, 128))
            for c in (*o.T, *d.T)]
    t, slot = jax_wavefront._trace_wave_slim(
        jnp.asarray(jbricks.sph_rows), jnp.asarray(jbricks.top_boxes),
        jnp.asarray(jbricks.top_links), jnp.asarray(jbricks.brick_data),
        tnear, *args, jnp.ones((16, 128), jnp.float32), jbricks.num_spheres,
        interpret=True)
    return np.asarray(t).reshape(-1), np.asarray(slot).reshape(-1)


def _primary_wave():
    """The camera rays of blob_box at 32x24 (1 spp) in the wave layout,
    padded to one [16, 128] packet by repeating the first ray."""
    _, parsed = load_scene(BLOB_BOX)
    cd = camera_ray_data(Camera.from_parsed(parsed.camera), W, H)
    pix, _ = wavefront._wave_layout(W, H)
    pix = np.where(pix < W * H, pix, 0)
    u = ((pix % W) + 0.5) / W
    v = ((pix // W) + 0.5) / H
    d = cd[1] + u[:, None] * cd[2] - v[:, None] * cd[3] - cd[0]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.broadcast_to(cd[0], d.shape)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("wave", ["primary", "random"])
def test_trace_bricks_plain_matches_jax_b2(blob, wave):
    _, jbricks, _, _, bricks, _ = blob
    o, d = _primary_wave() if wave == "primary" else _random_rays()
    tnear = 0.0 if wave == "primary" else 1e-4
    ref_t, ref_slot = _jax_b2(jbricks, o, d, tnear)
    t, slot = brickkernel.trace_bricks_plain(bricks, _vec(o), _vec(d), tnear)
    t, slot = t.numpy(), slot.numpy()
    assert t.dtype == np.float32 and slot.dtype == np.int32
    assert (slot >= 0).mean() > 0.9
    differ = (slot != ref_slot) | ~np.isclose(t, ref_t, rtol=1e-5, atol=0.0)
    assert differ.mean() <= 1e-3, f"{differ.sum()} rays differ"
    assert np.array_equal(np.isinf(t), slot < 0)


def test_trace_bricks_plain_active_mask_and_empty(blob):
    bricks = blob[4]
    o, d = _random_rays()
    active = torch.from_numpy(np.arange(len(o)) % 3 == 0)
    t_all, s_all = brickkernel.trace_bricks_plain(bricks, _vec(o), _vec(d),
                                                  0.0)
    t, s = brickkernel.trace_bricks_plain(bricks, _vec(o), _vec(d), 0.0,
                                          active)
    assert torch.equal(t[active], t_all[active])
    assert torch.equal(s[active], s_all[active])
    assert bool((s[~active] == -1).all()) and bool(torch.isinf(t[~active]).all())
    t0, s0 = brickkernel.trace_bricks_plain(bricks, Vec3.zeros((0,)),
                                            Vec3.zeros((0,)), 0.0)
    assert t0.shape == s0.shape == (0,)


@pytest.mark.parametrize("nee", [False, True])
def test_integrator_matches_jax_on_the_large_scene(blob, nee):
    jscene, _, jcd, scene, _, cd = blob
    ref = np.asarray(jax_integrator.render_samples(
        jscene, jcd, W, H, 0, 1, max_depth=3, nee=nee))
    got = integrator.render_samples(scene, cd, W, H, 0, 1, max_depth=3,
                                    nee=nee).numpy()
    assert ref.mean() > 0.0
    bad = ~np.isclose(got, ref, rtol=1e-4, atol=1e-4)
    assert bad.sum() <= max(1e-4 * bad.size, 2), \
        f"{bad.sum()} of {bad.size} elements mismatch"
    assert np.abs(ref - got).mean() < 1e-4


def test_port_wavefront_sample_sum_and_reproducible(blob):
    bricks, cd = blob[4], blob[5]
    kw = dict(max_depth=3, nee=True)
    a = wavefront.render_samples_wavefront(bricks, cd, W, H, 0, 2, **kw)
    b0 = wavefront.render_samples_wavefront(bricks, cd, W, H, 0, 1, **kw)
    b1 = wavefront.render_samples_wavefront(bricks, cd, W, H, 1, 1, **kw)
    torch.testing.assert_close(a, b0 + b1, rtol=1e-5, atol=1e-6)
    a2 = wavefront.render_samples_wavefront(bricks, cd, W, H, 0, 2, **kw)
    assert torch.equal(a, a2)
    # the sample chunking (MAX_RAYS_PER_WAVE) splits whole samples
    chunked = dict(kw)
    old = wavefront.MAX_RAYS_PER_WAVE
    wavefront.MAX_RAYS_PER_WAVE = 2048
    try:
        c = wavefront.render_samples_wavefront(bricks, cd, W, H, 0, 2,
                                               **chunked)
    finally:
        wavefront.MAX_RAYS_PER_WAVE = old
    torch.testing.assert_close(c, b0 + b1, rtol=1e-5, atol=1e-6)


def test_wave_layout_and_sort_keys_match_jax(blob):
    _, jbricks, _, _, bricks, _ = blob
    pix, n_blocks = wavefront._wave_layout(W, H)
    ref_pix, ref_blocks = jax_wavefront._wave_layout(W, H)
    np.testing.assert_array_equal(pix, ref_pix)
    assert n_blocks == ref_blocks == 1
    o, d = _random_rays(seed=3)
    root = np.asarray(jbricks.top_boxes)[0, :6]
    lo, inv = root[:3], (1.0 / np.maximum(root[3:] - root[:3], 1e-12))
    lo, inv = lo.astype(np.float32), inv.astype(np.float32)
    jo, jd = _vec(o, (16, 128)), _vec(d, (16, 128))
    live = jnp.ones((16, 128), bool)
    to, td = _vec(o), _vec(d)
    tlo, tinv = torch.from_numpy(lo), torch.from_numpy(inv)
    ref = jax_wavefront._sig_key(jo, jd, live, jnp.asarray(lo),
                                 jnp.asarray(inv),
                                 jnp.asarray(jbricks.coarse_boxes))
    got = wave_step._sig_key(to, td, tlo, tinv, bricks.coarse_boxes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).reshape(-1))
    assert len(np.unique(got.numpy() >> 12)) > 4       # signatures differ
    ref = jax_wavefront._sort_key(jo, jd, live, jnp.asarray(lo),
                                  jnp.asarray(inv))
    got = wave_step._sort_key(to, td, tlo, tinv)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).reshape(-1))
    assert len(np.unique(got.numpy())) > 100


def test_record_from_slots_matches_jax(blob):
    _, jbricks, _, _, bricks, _ = blob
    o, d = _random_rays(seed=4)
    t, slot = brickkernel.trace_bricks_plain(bricks, _vec(o), _vec(d), 1e-4)
    tri_rows = jnp.asarray(jbricks.brick_data)[:, :128, :].reshape(-1, 32)
    ref = jax_wavefront._record_from_slots(
        tri_rows, jnp.asarray(jbricks.sph_rows), jbricks.num_spheres,
        jnp.asarray(t.numpy().reshape(16, 128)),
        jnp.asarray(slot.numpy().reshape(16, 128)),
        _vec(o, (16, 128)), _vec(d, (16, 128)), 1e-4,
        jnp.ones((16, 128), bool))
    got = wave_step._record_from_slots(bricks, t, slot, _vec(o), _vec(d),
                                       1e-4)
    for k, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r).reshape(-1),
                                   rtol=1e-5, atol=1e-5, err_msg=str(k))


def test_cpu_wave_launches_no_kernel(blob):
    bricks = blob[4]
    o, d = _random_rays()
    before = wavefront.trace_bricks_cuda.launches
    t, slot = wavefront.trace_wave_slim(bricks, _vec(o), _vec(d), 0.0)
    ref_t, ref_slot = brickkernel.trace_bricks_plain(bricks, _vec(o), _vec(d),
                                                     0.0)
    assert torch.equal(slot, ref_slot) and torch.equal(t, ref_t)
    assert wavefront.trace_bricks_cuda.launches == before == 0
    with pytest.raises(ValueError, match="CUDA"):
        wavefront.trace_bricks_cuda(bricks, *_vec(o), *_vec(d), 0.0)
    with pytest.raises(ValueError, match="bricks on"):
        wavefront.trace_wave_slim(bricks.to("meta"), _vec(o), _vec(d), 0.0)


@pytest.mark.parametrize("engine", ["slim8", "slimg", "slimg4", "slim2",
                                    "pairs", "pairs8"])
def test_unported_engines_raise(blob, engine):
    """Every engine name of the JAX package renders (the name is from when
    all but "slim" raised): "slim[N]" and "slimg[N]" run kernel B2's walk,
    and "slim2" (kernel B4) finds the same winners, so their images equal
    "slim"'s bit for bit; "pairs[N]" (kernel B5) may differ where two
    triangles tie at an equal t."""
    bricks, cd = blob[4], blob[5]
    ref = wavefront.render_samples_wavefront(bricks, cd, W, H, 0, 1,
                                             max_depth=3)
    got = wavefront.render_samples_wavefront(bricks, cd, W, H, 0, 1,
                                             max_depth=3, trace=engine)
    if engine.startswith("pairs"):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    else:
        assert torch.equal(got, ref)
    renderer = ProgressiveRenderer.from_xml(
        BLOB_BOX, RenderConfig(wavefront_trace=engine, max_depth=2),
        width=W, height=H, device="cpu")
    renderer.step()
    assert renderer.mode == "wavefront" and renderer.waves == 2
    assert np.isfinite(renderer.hdr()).all() and renderer.hdr().mean() > 0.0


@pytest.mark.parametrize("name,parsed", [
    ("slim", ("slim", 0)), ("slim8", ("slim", 8)), ("slim20", ("slim", 20)),
    ("slimg", ("slimg", 8)), ("slimg4", ("slimg", 4)), ("slim2", ("slim2", 0)),
    ("pairs", ("pairs", 32)), ("pairs8", ("pairs", 8))])
def test_parse_engine(name, parsed):
    assert wavefront.parse_engine(name) == parsed
    tracer = wavefront.engine_tracer(name)
    if parsed[0] == "pairs":
        assert tracer.func is pairtrace.trace_wave_pairs
        assert tracer.keywords == {"packet_rows": parsed[1]}
    elif parsed[0] == "slim2":
        assert tracer is wavefront.trace_wave_slim2
    else:
        assert tracer is wavefront.trace_wave_slim


@pytest.mark.parametrize("name", ["slim0", "pairs0", "slimg0", "pairs-1",
                                  "slimx", "slim2x", "pairs 8", "", "Slim"])
def test_bad_engine_names_are_value_errors(blob, name):
    with pytest.raises(ValueError, match="engine"):
        wavefront.parse_engine(name)
    with pytest.raises(ValueError, match="engine"):
        wavefront.render_samples_wavefront(blob[4], blob[5], W, H, 0, 1,
                                           trace=name)
    with pytest.raises(ValueError, match="engine"):
        ProgressiveRenderer.from_xml(BLOB_BOX,
                                     RenderConfig(wavefront_trace=name),
                                     width=W, height=H, device="cpu")


@pytest.mark.parametrize("mode,item", [("mx", "A10"), ("mx2", "A10")])
def test_unported_large_scene_modes_raise(mode, item):
    """Every large-scene mode of the JAX package renders (the name is from
    when "mx" and "mx2" raised, naming their roadmap item): on a ScenePack
    each takes its own path and gives the wavefront's image at the
    criterion of tests/test_mx2.py:54-56."""
    renderer = ProgressiveRenderer.from_xml(
        BLOB_BOX, RenderConfig(large_scene_mode=mode, max_depth=2), width=W,
        height=H, device="cpu")
    assert renderer.mode == mode and item == "A10"
    renderer.step()
    assert renderer.waves == 2 and renderer.sample_count == 2
    ref = ProgressiveRenderer.from_xml(
        BLOB_BOX, RenderConfig(max_depth=2), width=W, height=H, device="cpu")
    ref.step()
    got, want = renderer.hdr(), ref.hdr()
    assert np.isfinite(got).all() and got.mean() > 0.0
    assert (np.abs(got - want) > 1e-3).mean() < 2e-3
    assert np.abs(got - want).mean() < 1e-3


def test_unknown_engine_sort_and_mode_are_errors(blob):
    bricks, cd = blob[4], blob[5]
    with pytest.raises(ValueError, match="engine"):
        wavefront.render_samples_wavefront(bricks, cd, W, H, 0, 1,
                                           trace="fast")
    with pytest.raises(ValueError, match="sort_mode"):
        wavefront.render_samples_wavefront(bricks, cd, W, H, 0, 1,
                                           sort_mode="random")
    with pytest.raises(ValueError, match="large_scene_mode"):
        ProgressiveRenderer.from_xml(
            BLOB_BOX, RenderConfig(large_scene_mode="fast"), width=W,
            height=H, device="cpu")
