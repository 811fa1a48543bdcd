"""The "mx" large-scene path of the port (experiments/mxset.py,
experiments/mxtrace.py: Plucker coefficients, library products in rounds)
against the JAX package on the CPU.

* ``_tri_coeff`` and ``build_mxset``: every field equal to the JAX
  package's (the code is the same numpy);
* the Plucker identity against the port's own triangle test;
* ``_mx_rounds`` on 2,048 seeded rays and the same visit lists: slot equal
  and t to rtol 1e-5 on all but 1e-3 of the rays (XLA contracts a*b+c into
  FMAs and sums a product in its own order, so an edge ray may fall to the
  other side);
* ``render_samples_mx`` against JAX's and against the port's plain
  integrator at depth 3, NEE off and on, at the criterion of
  tests/test_mxtrace.py:62-64: fewer than 2e-3 of the elements off by more
  than 1e-3 and a mean error below 1e-3; samples add, a render repeats bit
  for bit, a frame cut into slot slices gives the same image;
* the renderer with ``large_scene_mode="mx"`` and with a prebuilt MXSet.

This path holds no hand-written kernel, so no case needs a card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pathtracer_cuda_interactive_tpu_torch import SCENES_DIR
from pathtracer_cuda_interactive_tpu_torch.experiments import mxset, mxtrace
from pathtracer_cuda_interactive_tpu_torch.experiments.mxset import MXSet
from pathtracer_cuda_interactive_tpu_torch.models.bricks import BrickSet
from pathtracer_cuda_interactive_tpu_torch.models.device_scene import (
    DeviceScene)
from pathtracer_cuda_interactive_tpu_torch.models.scenepack import load_scene
from pathtracer_cuda_interactive_tpu_torch.ops import (
    geometry, integrator, pairtrace, wavefront)
from pathtracer_cuda_interactive_tpu_torch.ops.camera import (
    Camera, camera_ray_data)
from pathtracer_cuda_interactive_tpu_torch.ops.vec import Vec3
from pathtracer_cuda_interactive_tpu_torch.render.renderer import (
    ProgressiveRenderer, _render_mode)
from pathtracer_cuda_interactive_tpu_torch.utils.config import RenderConfig

# several test workers at once: one intra-op thread per process
torch.set_num_threads(1)

W, H = 32, 24
BLOB_BOX = str(SCENES_DIR / "blob_box.xml")
INF = float("inf")


def _scene_path(name):
    return str(SCENES_DIR / f"{name}.xml")


def _load(width=W, height=H, name="blob_box"):
    pack, parsed = load_scene(_scene_path(name))
    cam = Camera.from_parsed(parsed.camera)
    return pack, torch.from_numpy(camera_ray_data(cam, width, height))


def _jax_set(name, kind):
    """The JAX package's MXSet (kind "mx") or MX2Set ("mx2") of an in-repo
    scene, built with its numpy SAH, as (set, dict of its numpy fields)."""
    from pathtracer_cuda_interactive_tpu.experiments.mx2set import (
        MX2Set as JaxMX2Set)
    from pathtracer_cuda_interactive_tpu.experiments.mxset import (
        MXSet as JaxMXSet)
    from pathtracer_cuda_interactive_tpu.models import native as jax_native
    from pathtracer_cuda_interactive_tpu.models.scenepack import (
        load_scene as jax_load_scene)
    cls = JaxMXSet if kind == "mx" else JaxMX2Set
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "build_sah_treelets_native",
                   lambda *args: None)
        jset = cls.from_pack(jax_load_scene(_scene_path(name))[0])
    return jset, {f.name: getattr(jset, f.name)
                  for f in dataclasses.fields(cls)}


def _jax_camera(width=W, height=H, name="blob_box"):
    import jax.numpy as jnp
    from pathtracer_cuda_interactive_tpu.models.scenepack import (
        load_scene as jax_load_scene)
    from pathtracer_cuda_interactive_tpu.ops.camera import (
        Camera as JaxCamera, camera_ray_data as jax_camera_ray_data)
    parsed = jax_load_scene(_scene_path(name))[1]
    return jnp.asarray(jax_camera_ray_data(
        JaxCamera.from_parsed(parsed.camera), width, height))


def _random_rays(n=2048, seed=0):
    """Rays from inside the box toward the blob, grouped so that each run
    of 128 has a small origin box; the first 64 run straight down from
    origins on the ceiling plane (0 * inf = NaN in a slab test)."""
    rs = np.random.default_rng(seed)
    groups = -(-n // 128)
    centre = rs.uniform([-0.8, 0.3, -0.8], [0.8, 1.7, 1.3], (groups, 3))
    o = np.repeat(centre, 128, axis=0)[:n] + rs.uniform(-0.1, 0.1, (n, 3))
    tgt = rs.uniform([-0.7, 0.1, -0.7], [0.2, 1.1, 0.35], (n, 3))
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:64] = [0.0, -1.0, 0.0]
    o[:64, 1] = 2.0
    return o.astype(np.float32), d.astype(np.float32)


def _vec(a):
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a.T))


def _assert_fields_equal(port_set, fields):
    for f in dataclasses.fields(port_set):
        got, want = getattr(port_set, f.name), fields[f.name]
        if isinstance(got, int):
            assert got == int(want), f.name
        else:
            want = np.asarray(want)
            assert got.dtype == torch.from_numpy(np.array(want)).dtype, f.name
            assert np.array_equal(got.numpy(), want), f.name


def test_tri_coeff_equals_jax():
    from pathtracer_cuda_interactive_tpu.experiments.mxset import (
        _tri_coeff as jax_tri_coeff)
    rs = np.random.default_rng(3)
    p0, e1, e2 = (rs.normal(size=(200, 3)) for _ in range(3))
    got = mxset._tri_coeff(p0, e1, e2)
    assert got.shape == (200, 10, 4) and got.dtype == np.float32
    assert np.array_equal(got, jax_tri_coeff(p0, e1, e2))


@pytest.mark.parametrize("name,bricks", [("blob_box", 60), ("cbox_rect", 1)])
def test_build_mxset_equals_jax(name, bricks):
    jset, fields = _jax_set(name, "mx")
    pack = load_scene(_scene_path(name))[0]
    mx = MXSet.from_pack(pack)
    assert mx.num_bricks == bricks == mx.coeff.shape[0]
    assert mx.coeff.shape == (bricks, 10, 4 * mxset.MX_BRICK_PRIMS)
    _assert_fields_equal(mx, fields)
    _assert_fields_equal(MXSet.from_numpy(**fields), fields)
    assert int((mx.tri_rows[:, 0] != 0).sum()) == pack.num_triangles
    assert mx.device.type == "cpu" and mx.to("meta").device.type == "meta"
    assert mx.nbytes == sum(np.asarray(v).nbytes for k, v in fields.items()
                            if k not in MXSet._STATIC)


def test_plucker_coeff_matches_moller_trumbore():
    """F . C reproduces (det, u*det, v*det, t*det) of the port's
    intersect_triangle for random rays and triangles, at the tolerance of
    tests/test_mxtrace.py:44-47."""
    r = np.random.default_rng(7)
    T = 64
    p0, e1, e2 = (r.normal(size=(T, 3)) for _ in range(3))
    o = r.normal(size=(T, 3)) * 2.0
    d = r.normal(size=(T, 3))
    C = mxset._tri_coeff(p0, e1, e2)
    v3 = lambda a: Vec3(*(torch.from_numpy(c.astype(np.float32))
                          for c in a.T))
    F = mxtrace._features(v3(o), v3(d)).numpy()
    assert F.shape == (T, 10) and np.array_equal(F[:, 9], np.ones(T))
    det, U, V, Tt = np.einsum("tk,tkq->tq", F, C).T
    t, u, v, _ = geometry.intersect_triangle(v3(p0), v3(e1), v3(e2), v3(o),
                                             v3(d), -INF, INF)
    ok = np.abs(det) > 1e-3
    np.testing.assert_allclose(U[ok] / det[ok], u.numpy()[ok], rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_allclose(V[ok] / det[ok], v.numpy()[ok], rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_allclose(Tt[ok] / det[ok], t.numpy()[ok], rtol=2e-3,
                               atol=2e-4)


def test_mx_rounds_match_jax():
    import jax.numpy as jnp
    from jax import lax
    from pathtracer_cuda_interactive_tpu.experiments import (
        mxtrace as jax_mxtrace)
    from pathtracer_cuda_interactive_tpu.ops.vec import Vec3 as JaxVec3
    jset, fields = _jax_set("blob_box", "mx")
    mx = MXSet.from_numpy(**fields)
    o, d = _random_rays()
    M, B, T, tnear = 16, mx.num_bricks, mx.brick_prims, 1e-4
    jv = lambda a: JaxVec3(*(jnp.asarray(c.reshape(M, 128)) for c in a.T))
    live = jnp.ones((M, 128), bool)
    lb = jax_mxtrace._interval_cull(jv(o), jv(d), live,
                                    jnp.asarray(jset.brick_lo),
                                    jnp.asarray(jset.brick_hi), tnear)
    iota = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[None, :], lb.shape)
    slb, order = lax.sort((lb, iota), num_keys=1, dimension=1)
    ref = jax_mxtrace._mx_rounds(jnp.asarray(jset.coeff), order, slb,
                                 jax_mxtrace._features(jv(o), jv(d)), live,
                                 tnear, T, B)
    ref_t, ref_u, ref_v, ref_slot = (np.asarray(a).reshape(-1) for a in ref)

    tv = lambda a: Vec3(*(torch.from_numpy(np.ascontiguousarray(c))
                          .reshape(M, 128) for c in a.T))
    stats = {}
    got = mxtrace._mx_rounds(
        mx.coeff, torch.from_numpy(np.asarray(order).copy()),
        torch.from_numpy(np.asarray(slb).copy()),
        mxtrace._features(tv(o), tv(d)), torch.ones((M, 128), dtype=bool),
        tnear, T, stats)
    t, u, v, slot = (a.numpy().reshape(-1) for a in got)
    assert slot.dtype == np.int32 and (slot >= 0).mean() > 0.9
    assert 0 < stats["rounds"] <= B and stats["products"] <= M * B
    differ = (slot != ref_slot) | ~np.isclose(t, ref_t, rtol=1e-5, atol=0.0)
    assert differ.mean() <= 1e-3, f"{differ.sum()} rays differ"
    same = ~differ & (slot >= 0)
    np.testing.assert_allclose(u[same], ref_u[same], rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(v[same], ref_v[same], rtol=1e-3, atol=1e-5)

    # the whole per-wave trace: the port's own lists give the same hits,
    # and the walk over the BrickSet of the scene the same t
    pt, pslot, _, _ = mxtrace._trace_mx(mx, _vec(o), _vec(d), tnear)
    assert np.array_equal(pslot.numpy(), slot)
    assert np.array_equal(pt.numpy(), t)
    bricks = BrickSet.from_pack(load_scene(BLOB_BOX)[0])
    walk_t, _ = wavefront.trace_wave_slim(bricks, _vec(o), _vec(d), tnear)
    off = ~np.isclose(t, walk_t.numpy(), rtol=1e-4, atol=0.0)
    assert off.mean() <= 1e-3


def test_trace_mx_partial_packet_and_empty_wave():
    mx = MXSet.from_pack(load_scene(BLOB_BOX)[0])
    o, d = _random_rays(2048, seed=5)
    full_t, full_slot, _, _ = mxtrace._trace_mx(mx, _vec(o), _vec(d), 0.0)
    t, slot, u, v = mxtrace._trace_mx(mx, _vec(o[:300]), _vec(d[:300]), 0.0)
    assert t.shape == slot.shape == u.shape == v.shape == (300,)
    # the first two packets are whole in both calls
    assert torch.equal(t[:256], full_t[:256])
    assert torch.equal(slot[:256], full_slot[:256])
    assert bool(((slot >= 0) == torch.isfinite(t)).all())
    e = mxtrace._trace_mx(mx, Vec3.zeros((0,)), Vec3.zeros((0,)), 0.0)
    assert e[0].shape == (0,) and e[1].dtype == torch.int32
    with pytest.raises(ValueError, match="MX set on"):
        mxtrace._trace_mx(mx.to("meta"), _vec(o), _vec(d), 0.0)


def test_products_run_in_full_float32():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with mxtrace.full_float32_products():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.parametrize("nee", [False, True])
def test_render_mx_matches_jax_and_plain(nee):
    from pathtracer_cuda_interactive_tpu.experiments.mxtrace import (
        render_samples_mx as jax_render_samples_mx)
    jset, fields = _jax_set("blob_box", "mx")
    ref = np.asarray(jax_render_samples_mx(jset, _jax_camera(), W, H, 0, 1,
                                           max_depth=3, nee=nee))
    pack, cd = _load()
    stats = {}
    got = mxtrace.render_samples_mx(MXSet.from_numpy(**fields), cd, W, H, 0,
                                    1, max_depth=3, nee=nee,
                                    stats=stats).numpy()
    plain = integrator.render_samples(DeviceScene.from_pack(pack), cd, W, H,
                                      0, 1, max_depth=3, nee=nee).numpy()
    assert ref.mean() > 0.0 and stats["waves"] == (6 if nee else 3)
    assert stats["rounds"] > 0
    for want in (ref, plain):
        bad = np.abs(want - got) > 1e-3
        assert bad.mean() < 2e-3, f"{bad.mean():%} mismatched"
        assert np.abs(want - got).mean() < 1e-3


def test_port_mx_sample_sum_reproducible_and_sort_modes():
    pack, cd = _load()
    mx = MXSet.from_pack(pack)
    kw = dict(max_depth=3)
    a = mxtrace.render_samples_mx(mx, cd, W, H, 0, 2, **kw)
    b0 = mxtrace.render_samples_mx(mx, cd, W, H, 0, 1, **kw)
    b1 = mxtrace.render_samples_mx(mx, cd, W, H, 1, 1, **kw)
    torch.testing.assert_close(a, b0 + b1, rtol=1e-4, atol=1e-5)
    assert torch.equal(a, mxtrace.render_samples_mx(mx, cd, W, H, 0, 2, **kw))
    unsorted = mxtrace.render_samples_mx(mx, cd, W, H, 0, 2, sort_mode="none",
                                         **kw)
    torch.testing.assert_close(a, unsorted, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="sig_mort"):
        mxtrace.render_samples_mx(mx, cd, W, H, 0, 1, sort_mode="sig_mort")
    with pytest.raises(ValueError, match="sort_mode"):
        mxtrace.render_samples_mx(mx, cd, W, H, 0, 1, sort_mode="random")
    with pytest.raises(ValueError, match="scene on"):
        mxtrace.render_samples_mx(mx.to("meta"), cd, W, H, 0, 1)


def test_mx_frame_in_slot_slices(monkeypatch):
    """A frame whose single-sample wave exceeds the cap is cut along its
    slots (128x64 = four 64x32 tiles of 2,048 slots; a cap of 4,096 rays
    makes two slices of one sample each) and gives the same image."""
    width, height = 128, 64
    pack, cd = _load(width, height)
    mx = MXSet.from_pack(pack)
    whole, cut = {}, {}
    ref = mxtrace.render_samples_mx(mx, cd, width, height, 0, 2, max_depth=2,
                                    stats=whole)
    monkeypatch.setattr(mxtrace, "MX_MAX_RAYS_PER_WAVE", 4096)
    got = mxtrace.render_samples_mx(mx, cd, width, height, 0, 2, max_depth=2,
                                    stats=cut)
    assert whole["waves"] == 2 and cut["waves"] == 8
    assert whole["rays"] == cut["rays"]
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def test_renderer_runs_mx_on_the_cpu():
    pack, _ = _load()
    assert _render_mode(pack, "mx") == "mx"
    cam = Camera.from_parsed(load_scene(BLOB_BOX)[1].camera)
    r = ProgressiveRenderer(pack, cam, W, H,
                            RenderConfig(large_scene_mode="mx", max_depth=3,
                                         enable_nee=True), device="cpu")
    assert r.mode == "mx" and isinstance(r.scene, MXSet)
    r.step()
    assert r.waves == 6 and r.sample_count == 2
    img = r.hdr()
    assert np.isfinite(img).all() and img.mean() > 0.0

    # a prebuilt MXSet pins the path whatever the mode says
    mx = MXSet.from_pack(pack)
    for mode in ("wavefront", "bricks", "mx2"):
        assert _render_mode(mx, mode) == "mx"
    p = ProgressiveRenderer(mx, cam, W, H,
                            RenderConfig(max_depth=3, enable_nee=True),
                            device="cpu")
    assert p.mode == "mx"
    p.step()
    assert np.array_equal(p.hdr(), img)
    p.set_camera(Camera((0.2,) + tuple(cam.lookfrom[1:]), cam.lookat, cam.up,
                        cam.vfov))
    assert p.sample_count == 0 and float(p.accum.abs().sum()) == 0.0
