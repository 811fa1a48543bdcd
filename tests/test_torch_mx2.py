"""The "mx2" large-scene path of the port (experiments/mx2set.py,
experiments/mx2.py: superbricks, visit lists, kernel B7) against the JAX
package on the CPU, and the kernel against its plain version on a card.

* ``build_mx2set``: every field equal to the JAX package's;
* the visit lists of 128-ray packets against the JAX ``_interval_cull`` and
  ``lax.sort`` on the same rays: bounds to rtol 1e-6, the same finite set,
  the same order;
* ``trace_mx2_plain`` (B7's plain version) against the JAX Pallas kernel in
  interpret mode, ``_trace_kernel_mx2(interpret=True)``, on 2,048 seeded
  rays and the same lists: slot equal and t to rtol 1e-5 on all but 1e-3 of
  the rays (XLA contracts a*b+c into FMAs and sums the product in its own
  order, so an edge ray may fall to the other side); against the walk over
  the scene's BrickSet, t to rtol 1e-4 on all but 1e-3 of the rays (the
  Plucker form cancels more than Moller-Trumbore; slots are not compared,
  the two sets order triangles differently);
* ``render_samples_mx2`` against JAX's with the kernel in interpret mode
  and against the port's plain integrator at depth 3, NEE off and on, at
  the criterion of tests/test_mx2.py:54-56; samples add and a render
  repeats bit for bit;
* the renderer with ``large_scene_mode="mx2"`` and with a prebuilt MX2Set;
* what kernel B7's early votes rest on: every superbrick's box holds its
  valid subs' boxes, ``box_maybe`` on it is true wherever ``box_hit`` is true
  for one of them (random rays, axis-parallel rays, origins on box planes),
  ``MX2Set.visit_boxes`` is the set's own numbers, and the plain walk with
  the early votes switched on gives the plain walk's t, slot and counters.

The cases marked ``cuda`` skip without a card and import no jax, so on the
card this file runs with ``python -m pytest --noconftest -m cuda
tests/test_torch_mx2.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pathtracer_cuda_interactive_tpu_torch import SCENES_DIR
from pathtracer_cuda_interactive_tpu_torch.experiments import mx2, mx2set
from pathtracer_cuda_interactive_tpu_torch.experiments.mx2set import MX2Set
from pathtracer_cuda_interactive_tpu_torch.models.bricks import BrickSet
from pathtracer_cuda_interactive_tpu_torch.models.device_scene import (
    DeviceScene)
from pathtracer_cuda_interactive_tpu_torch.models.scenepack import load_scene
from pathtracer_cuda_interactive_tpu_torch.ops import (
    brickkernel, cuda_build, integrator, pairtrace, wavefront)
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


def _load(width=W, height=H, device="cpu"):
    pack, parsed = load_scene(BLOB_BOX)
    cam = Camera.from_parsed(parsed.camera)
    return pack, torch.from_numpy(camera_ray_data(cam, width,
                                                  height)).to(device)


def _jax_set(name):
    """The JAX package's MX2Set of an in-repo scene, built with its numpy
    SAH, as (set, dict of its numpy fields)."""
    from pathtracer_cuda_interactive_tpu.experiments.mx2set import (
        MX2Set as JaxMX2Set)
    from pathtracer_cuda_interactive_tpu.models import native as jax_native
    from pathtracer_cuda_interactive_tpu.models.scenepack import (
        load_scene as jax_load_scene)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "build_sah_treelets_native",
                   lambda *args: None)
        jset = JaxMX2Set.from_pack(jax_load_scene(_scene_path(name))[0])
    return jset, {f.name: getattr(jset, f.name)
                  for f in dataclasses.fields(JaxMX2Set)}


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


def _coherent_rays(n, seed):
    """Rays with small origin boxes and sign-definite direction bounds per
    run of 128, so that the cull drops superbricks."""
    rs = np.random.default_rng(seed)
    groups = -(-n // 128)
    centre = rs.uniform([-0.8, 0.2, -0.8], [0.8, 1.8, 1.2], (groups, 3))
    axis = rs.normal(size=(groups, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    o = np.repeat(centre, 128, axis=0)[:n] + rs.uniform(-0.05, 0.05, (n, 3))
    d = np.repeat(axis, 128, axis=0)[:n] + rs.uniform(-0.1, 0.1, (n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _vec(a, device="cpu"):
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(c)).to(device)
                  for c in a.T))


@pytest.fixture(scope="module")
def blob_mx2():
    return MX2Set.from_pack(load_scene(BLOB_BOX)[0])


@pytest.mark.parametrize("name,bricks", [("blob_box", 18), ("cbox_rect", 1)])
def test_build_mx2set_equals_jax(name, bricks):
    jset, fields = _jax_set(name)
    pack = load_scene(_scene_path(name))[0]
    mx = MX2Set.from_pack(pack)
    assert mx.num_bricks == bricks
    assert mx.coeff.shape == (bricks, mx2set.SLAB_ROWS, 128)
    assert mx.subbox.shape == (bricks, 128)
    assert mx.tri_rows.shape == (bricks * mx2set.SB_PRIMS, 32)
    for port_set in (mx, MX2Set.from_numpy(**fields)):
        for f in dataclasses.fields(MX2Set):
            got, want = getattr(port_set, f.name), fields[f.name]
            if isinstance(got, int):
                assert got == int(want), f.name
            else:
                assert np.array_equal(got.numpy(), np.asarray(want)), f.name
                assert got.numpy().dtype == np.asarray(want).dtype, f.name
    # rows 10..15 of every sub are padding, as the kernel assumes
    assert not mx.coeff.view(bricks, 16, 16, 128)[:, :, mx2.FEATURES:].any()
    assert int((mx.tri_rows[:, 0] != 0).sum()) == pack.num_triangles
    assert mx.to("meta").device.type == "meta" and mx.nbytes > 0


@pytest.mark.parametrize("case", ["coherent", "random", "partial"])
def test_visit_lists_match_jax_cull_and_sort(blob_mx2, case):
    import jax.numpy as jnp
    from jax import lax
    from pathtracer_cuda_interactive_tpu.experiments.mxtrace import (
        _interval_cull as jax_interval_cull)
    from pathtracer_cuda_interactive_tpu.ops.vec import Vec3 as JaxVec3
    o, d = (_coherent_rays(2048, 1) if case != "random"
            else _random_rays(seed=2))
    n = 1900 if case == "partial" else 2048      # 14 packets and 108 rays
    M, B, tnear = 16, blob_mx2.num_bricks, 1e-4
    active = (np.arange(2048) < n).reshape(M, 128)
    jv = lambda a: JaxVec3(*(jnp.asarray(c.reshape(M, 128)) for c in a.T))
    lb = jax_interval_cull(jv(o), jv(d), jnp.asarray(active),
                           jnp.asarray(blob_mx2.brick_lo.numpy()),
                           jnp.asarray(blob_mx2.brick_hi.numpy()), tnear)
    iota = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[None, :], lb.shape)
    slb, order = (np.asarray(a) for a in
                  lax.sort((lb, iota), num_keys=1, dimension=1))
    brk, ent, cnt = pairtrace.visit_lists(blob_mx2, _vec(o[:n]), _vec(d[:n]),
                                          tnear, 1)
    P = -(-n // 128)
    assert brk.shape == ent.shape == (P, B) and cnt.shape == (P,)
    assert brk.dtype == torch.int32 and cnt.dtype == torch.int32
    fin = np.isfinite(slb[:P])
    assert np.array_equal(np.isfinite(ent.numpy()), fin)
    assert np.array_equal(cnt.numpy(), fin.sum(axis=1))
    np.testing.assert_allclose(ent.numpy()[fin], slb[:P][fin], rtol=1e-6,
                               atol=0.0)
    if case == "coherent":
        assert 0.02 < fin.mean() < 0.9            # the cull does cull
    # the order: feed the port's sort the JAX bounds, so that a bound that
    # differs in its last bit cannot reorder two superbricks
    brk2, ent2, _ = pairtrace._pack_pairs(torch.from_numpy(
        np.asarray(lb)[:P].copy()))
    assert np.array_equal(brk2.numpy()[fin], order[:P][fin])
    assert np.array_equal(ent2.numpy(), slb[:P])


def test_plain_b7_matches_jax_kernel_in_interpret_mode():
    import jax.numpy as jnp
    from jax import lax
    from pathtracer_cuda_interactive_tpu.experiments import mx2 as jax_mx2
    from pathtracer_cuda_interactive_tpu.ops.vec import Vec3 as JaxVec3
    jset, fields = _jax_set("blob_box")
    mx = MX2Set.from_numpy(**fields)
    o, d = _random_rays()
    M, B, tnear = 16, mx.num_bricks, 1e-4
    jv = lambda a: JaxVec3(*(jnp.asarray(c.reshape(M, 128)) for c in a.T))
    live = jnp.ones((M, 128), bool)
    lb = jax_mx2._interval_cull(jv(o), jv(d), live,
                                jnp.asarray(jset.brick_lo),
                                jnp.asarray(jset.brick_hi), tnear)
    iota = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[None, :], lb.shape)
    slb, order = lax.sort((lb, iota), num_keys=1, dimension=1)
    pad = ((0, 0), (0, 128 - B))
    rays = [jnp.asarray(np.ascontiguousarray(c).reshape(M, 128))
            for c in (*o.T, *d.T)]
    ref_t, ref_slot = jax_mx2._trace_kernel_mx2(
        jnp.asarray(jset.coeff), jnp.asarray(jset.subbox),
        jnp.pad(order, pad), jnp.pad(slb, pad, constant_values=INF), *rays,
        jnp.ones((M, 128), jnp.float32), jnp.asarray(jset.shift), tnear,
        interpret=True)
    ref_t = np.asarray(ref_t).reshape(-1)
    ref_slot = np.asarray(ref_slot).reshape(-1)

    # the same lists: JAX's order and bounds, a count per packet
    slb_np = np.asarray(slb).copy()
    brk = torch.from_numpy(np.asarray(order).copy())
    ent = torch.from_numpy(slb_np)
    cnt = torch.from_numpy(np.isfinite(slb_np).sum(axis=1).astype(np.int32))
    before = mx2.trace_mx2_cuda.launches
    t, slot, stats = mx2.trace_mx2_plain(mx, _vec(o), _vec(d), tnear, brk,
                                         ent, cnt, collect_stats=True)
    assert mx2.trace_mx2_cuda.launches == before == 0
    assert t.dtype == torch.float32 and slot.dtype == torch.int32
    t, slot = t.numpy(), slot.numpy()
    assert (slot >= 0).mean() > 0.9
    assert np.array_equal(slot >= 0, np.isfinite(t))
    differ = (slot != ref_slot) | ~np.isclose(t, ref_t, rtol=1e-5, atol=0.0)
    assert differ.mean() <= 1e-3, f"{differ.sum()} rays differ"
    listed, visited, voted, tested = stats.tolist()
    assert listed == int(cnt.sum()) and 0 < visited <= listed
    assert 0 < voted <= tested <= 16 * visited

    # the port's own lists and dispatch give the same hits
    wt, wslot = mx2.trace_wave_mx2(mx, _vec(o), _vec(d), tnear)
    assert np.array_equal(wt.numpy(), t) and np.array_equal(wslot.numpy(),
                                                            slot)
    pt_, pslot = mx2.trace_wave_mx2_plain(mx, _vec(o), _vec(d), tnear)
    assert torch.equal(pt_, wt) and torch.equal(pslot, wslot)


@pytest.mark.parametrize("n,seed", [(2048, 6), (1900, 7), (300, 8)])
def test_plain_b7_t_is_the_walks(blob_mx2, n, seed):
    """Against kernel B2's plain version over the scene's BrickSet, partial
    last packets included; a slot names the winning triangle's row."""
    bricks = BrickSet.from_pack(load_scene(BLOB_BOX)[0])
    o, d = _random_rays(n, seed)
    walk_t, walk_slot = wavefront.trace_wave_slim(bricks, _vec(o), _vec(d),
                                                  1e-4)
    t, slot = mx2.trace_wave_mx2(blob_mx2, _vec(o), _vec(d), 1e-4)
    assert t.shape == slot.shape == (n,)
    off = ~np.isclose(t.numpy(), walk_t.numpy(), rtol=1e-4, atol=0.0)
    assert off.mean() <= 1e-3, f"{off.sum()} rays off"
    assert (slot >= 0).float().mean() > 0.9
    # same triangles: the records' p0, e1, e2 agree where t does
    hit = torch.from_numpy(~off) & (slot >= 0)
    mine = blob_mx2.tri_rows[slot[hit].long()][:, 1:10]
    theirs = brickkernel.slot_rows(bricks, walk_slot[hit])[:, 1:10]
    assert (mine != theirs).any(dim=1).float().mean() <= 1e-3


def test_early_out_and_empty_wave(blob_mx2):
    """A narrow beam at the blob from the open side of the box: only the z
    axis has a sign-definite direction interval, so every superbrick is
    listed, every ray hits the blob, and the walk ends before the walls
    behind it.  A wave of no rays gives empty results."""
    rs = np.random.default_rng(9)
    o = np.array([-0.25, 0.6, 1.3]) + rs.uniform(-0.02, 0.02, (1024, 3))
    d = (np.array([-0.25, 0.6, -0.17]) + rs.uniform(-0.1, 0.1, (1024, 3))
         - o)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    brk, ent, cnt = pairtrace.visit_lists(blob_mx2, _vec(o), _vec(d), 0.0, 1)
    assert cnt.tolist() == [blob_mx2.num_bricks] * 8
    t, slot, stats = mx2.trace_mx2_plain(blob_mx2, _vec(o), _vec(d), 0.0,
                                         brk, ent, cnt, collect_stats=True)
    listed, visited, voted, tested = stats.tolist()
    assert listed == 8 * blob_mx2.num_bricks and 8 <= visited < listed // 2
    assert bool((slot >= 0).all())
    # the skipped visits held no nearer hit: the walk's t on every ray
    bricks = BrickSet.from_pack(load_scene(BLOB_BOX)[0])
    walk_t, _ = wavefront.trace_wave_slim(bricks, _vec(o), _vec(d), 0.0)
    assert np.isclose(t.numpy(), walk_t.numpy(), rtol=1e-4, atol=0.0).all()
    # cutting every list after its first superbrick loses hits
    one = torch.ones_like(cnt)
    ent1 = torch.where(torch.arange(ent.shape[1])[None, :] < 1, ent, INF)
    t1, _ = mx2.trace_mx2_plain(blob_mx2, _vec(o), _vec(d), 0.0, brk, ent1,
                                one)
    assert bool((t1 >= t).all()) and bool((t1 > t).any())
    t0, s0 = mx2.trace_wave_mx2(blob_mx2, Vec3.zeros((0,)), Vec3.zeros((0,)),
                                0.0)
    assert t0.shape == s0.shape == (0,) and s0.dtype == torch.int32


def test_wrappers_check_their_inputs(blob_mx2, tmp_path, monkeypatch):
    o, d = _random_rays(256)
    brk, ent, cnt = pairtrace.visit_lists(blob_mx2, _vec(o), _vec(d), 0.0, 1)
    with pytest.raises(ValueError, match="CUDA"):
        mx2.trace_mx2_cuda(blob_mx2, *_vec(o), *_vec(d), 0.0, brk, ent, cnt)
    with pytest.raises(ValueError, match="MX2 set on"):
        mx2.trace_wave_mx2(blob_mx2.to("meta"), _vec(o), _vec(d), 0.0)
    monkeypatch.setattr(mx2, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        mx2.build()
    lib = cuda_build.library_path(mx2.SOURCE, tmp_path)
    assert lib.name.startswith("mx2_trace_")


@pytest.mark.parametrize("nee", [False, True])
def test_render_mx2_matches_jax_and_plain(nee):
    import jax.numpy as jnp
    from pathtracer_cuda_interactive_tpu.experiments.mx2 import (
        render_samples_mx2 as jax_render_samples_mx2)
    from pathtracer_cuda_interactive_tpu.models.scenepack import (
        load_scene as jax_load_scene)
    from pathtracer_cuda_interactive_tpu.ops.camera import (
        Camera as JaxCamera, camera_ray_data as jax_camera_ray_data)
    jset, fields = _jax_set("blob_box")
    jcd = jnp.asarray(jax_camera_ray_data(
        JaxCamera.from_parsed(jax_load_scene(BLOB_BOX)[1].camera), W, H))
    ref = np.asarray(jax_render_samples_mx2(jset, jcd, W, H, 0, 1,
                                            max_depth=3, nee=nee,
                                            interpret=True))
    pack, cd = _load()
    stats = {}
    got = mx2.render_samples_mx2(MX2Set.from_numpy(**fields), cd, W, H, 0, 1,
                                 max_depth=3, nee=nee, stats=stats).numpy()
    plain = integrator.render_samples(DeviceScene.from_pack(pack), cd, W, H,
                                      0, 1, max_depth=3, nee=nee).numpy()
    assert ref.mean() > 0.0 and stats["waves"] == (6 if nee else 3)
    for want in (ref, plain):
        bad = np.abs(want - got) > 1e-3
        assert bad.mean() < 2e-3, f"{bad.mean():%} mismatched"
        assert np.abs(want - got).mean() < 1e-3


def test_port_mx2_sample_sum_reproducible_and_sort_modes(blob_mx2):
    _, cd = _load()
    kw = dict(max_depth=3)
    a = mx2.render_samples_mx2(blob_mx2, cd, W, H, 0, 2, **kw)
    b0 = mx2.render_samples_mx2(blob_mx2, cd, W, H, 0, 1, **kw)
    b1 = mx2.render_samples_mx2(blob_mx2, cd, W, H, 1, 1, **kw)
    torch.testing.assert_close(a, b0 + b1, rtol=1e-4, atol=1e-5)
    assert torch.equal(a, mx2.render_samples_mx2(blob_mx2, cd, W, H, 0, 2,
                                                 **kw))
    unsorted = mx2.render_samples_mx2(blob_mx2, cd, W, H, 0, 2,
                                      sort_mode="none", **kw)
    torch.testing.assert_close(a, unsorted, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="sig_mort"):
        mx2.render_samples_mx2(blob_mx2, cd, W, H, 0, 1, sort_mode="sig_mort")
    with pytest.raises(ValueError, match="max_depth"):
        mx2.render_samples_mx2(blob_mx2, cd, W, H, 0, 1, max_depth=0)


def test_renderer_runs_mx2_on_the_cpu(blob_mx2):
    pack, _ = _load()
    assert _render_mode(pack, "mx2") == "mx2"
    cam = Camera.from_parsed(load_scene(BLOB_BOX)[1].camera)
    r = ProgressiveRenderer(pack, cam, W, H,
                            RenderConfig(large_scene_mode="mx2", max_depth=3,
                                         enable_nee=True), device="cpu")
    assert r.mode == "mx2" and isinstance(r.scene, MX2Set)
    r.step()
    assert r.waves == 6 and r.sample_count == 2
    img = r.hdr()
    assert np.isfinite(img).all() and img.mean() > 0.0

    # a prebuilt MX2Set pins the path whatever the mode says
    for mode in ("wavefront", "bricks", "mx"):
        assert _render_mode(blob_mx2, mode) == "mx2"
    p = ProgressiveRenderer(blob_mx2, cam, W, H,
                            RenderConfig(max_depth=3, enable_nee=True),
                            device="cpu")
    assert p.mode == "mx2"
    p.step()
    assert np.array_equal(p.hdr(), img)
    p.reset_accumulation()
    assert p.sample_count == 0


# -- on the card ---------------------------------------------------------------

# -- the votes kernel B7 takes before the exact ones ------------------------------

def _edge_rays(mx, n, seed):
    """Rays inside the scene box, a third with a zero direction component
    (both signs of zero), many with an origin component on a plane of a sub
    box or of a superbrick box: the slab test's 0 * inf = NaN cases."""
    rs = np.random.default_rng(seed)
    lo, hi = mx.scene_lo.numpy(), mx.scene_hi.numpy()
    o = (lo + (hi - lo) * rs.random((n, 3))).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[0::3, 0] = 0.0
    d[1::5, 1] = -0.0
    d[2::7, 2] = 0.0
    sub = mx.subbox.view(-1, mx2set.NUM_SUBS, 8).numpy()
    pick = rs.integers(0, sub.shape[0], n)
    part = rs.integers(0, mx2set.NUM_SUBS, n)
    o[0::3, 0] = sub[pick[0::3], part[0::3], 0]      # on a sub's min x plane
    o[1::5, 1] = mx.brick_hi.numpy()[pick[1::5], 1]  # on a superbrick's max y
    o[2::7, 2] = sub[pick[2::7], part[2::7], 5]      # on a sub's max z plane
    return o, d


@pytest.mark.parametrize("name", ["blob_box", "cbox_rect"])
def test_superbrick_box_holds_its_subs_and_votes_yes_where_they_do(name):
    mx = MX2Set.from_pack(load_scene(_scene_path(name))[0])
    sub = mx.subbox.view(-1, mx2set.NUM_SUBS, 8)
    valid = sub[:, :, 6] > 0.0
    assert bool(valid.any(dim=1).all())
    assert bool((mx.brick_lo[:, None, :] <= sub[:, :, 0:3])[valid].all())
    assert bool((mx.brick_hi[:, None, :] >= sub[:, :, 3:6])[valid].all())

    boxes = mx.visit_boxes()
    assert boxes.shape == (mx.num_bricks, 8) and boxes.dtype == torch.float32
    assert boxes.data_ptr() % 16 == 0 and boxes.is_contiguous()
    assert torch.equal(boxes[:, 0:3], mx.brick_lo)
    assert torch.equal(boxes[:, 3:6], mx.brick_hi)
    assert torch.equal(boxes[:, 6], valid.sum(dim=1).to(torch.float32))
    assert mx.visit_boxes() is boxes                  # built once
    assert torch.equal(mx.to("cpu").visit_boxes(), boxes)

    o, d = _edge_rays(mx, 128 * 12, seed=5)
    rays = lambda a: Vec3(*(torch.from_numpy(a[:, c].copy()).view(-1, 128)
                            for c in range(3)))
    po, pd = rays(o), rays(d)
    pinv = Vec3(1.0 / pd.x, 1.0 / pd.y, 1.0 / pd.z)
    rs = np.random.default_rng(9)
    sub_pass = nan_seen = 0
    for b in range(mx.num_bricks):
        row = lambda box: box[None, :].expand(po.x.shape[0], -1)
        for t_max in (INF, float(rs.uniform(0.05, 3.0))):
            whole = mx2.box_maybe(row(boxes[b]), po, pinv, t_max)
            for s in torch.nonzero(valid[b]).reshape(-1).tolist():
                part = mx2.box_hit(row(sub[b, s]), po, pinv, t_max)
                assert bool(whole[part].all()), (b, s, t_max)
                sub_pass += int(part.sum())
        tn, tf = mx2._slab_interval(row(boxes[b]), po, pinv)
        nan_seen += int((torch.isnan(tn) | torch.isnan(tf)).sum())
    assert sub_pass > 0 and nan_seen > 0              # both cases were met


@pytest.mark.parametrize("n,seed,kind", [(2048, 11, "random"),
                                         (1900, 12, "coherent"),
                                         (300, 13, "edge")])
def test_plain_walk_with_early_votes_is_the_plain_walk(blob_mx2, n, seed,
                                                       kind):
    if kind == "edge":
        o, d = _edge_rays(blob_mx2, n, seed)
    else:
        o, d = (_random_rays if kind == "random" else _coherent_rays)(n, seed)
    org, dirn = _vec(o), _vec(d)
    brk, ent, cnt = pairtrace.visit_lists(blob_mx2, org, dirn, 1e-4, 1)
    t, slot, seen = mx2.trace_mx2_plain(blob_mx2, org, dirn, 1e-4, brk, ent,
                                        cnt, collect_stats=True)
    et, eslot, eseen = mx2.trace_mx2_plain(blob_mx2, org, dirn, 1e-4, brk,
                                           ent, cnt, collect_stats=True,
                                           early_votes=True)
    assert torch.equal(t.view(torch.int32), et.view(torch.int32))
    assert torch.equal(slot, eslot)
    assert eseen[:4].tolist() == seen.tolist()
    listed, visited, voted, tested, boxed_out = eseen.tolist()
    assert 0 < boxed_out < visited <= listed and voted <= tested
    assert int((slot >= 0).sum()) > 0


def _capture_waves(mx, cd, width, height, n_waves):
    waves = []

    def recording(scene, org, dirn, tnear):
        waves.append((org, dirn, tnear))
        return mx2.trace_wave_mx2_plain(scene, org, dirn, tnear)

    mx2.render_samples_mx2(mx, cd, width, height, 0, 1, max_depth=n_waves,
                           tracer=recording)
    return waves[:n_waves]


# The condition is a string, so it is evaluated when the test runs, not
# when the module is imported.
@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card (the kernel has no CPU mode)")
def test_cuda_kernel_matches_plain_on_waves():
    """Bit for bit, counters included: the kernel is built with
    --fmad=false and sums each product in the plain version's order."""
    pack, cd = _load(160, 120, "cuda")
    mx = MX2Set.from_pack(pack).to("cuda")
    bricks = BrickSet.from_pack(pack).to("cuda")
    for org, dirn, tnear in _capture_waves(mx, cd, 160, 120, 3):
        before = mx2.trace_mx2_cuda.launches
        t, slot = mx2.trace_wave_mx2(mx, org, dirn, tnear)
        torch.cuda.synchronize()
        assert mx2.trace_mx2_cuda.launches == before + 1
        brk, ent, cnt = pairtrace.visit_lists(mx, org, dirn, tnear, 1)
        tp, sp, plain_stats = mx2.trace_mx2_plain(
            mx, org, dirn, tnear, brk, ent, cnt, collect_stats=True)
        assert torch.equal(t, tp) and torch.equal(slot, sp)
        _, _, stats = mx2.trace_mx2_cuda(mx, *org, *dirn, tnear, brk, ent,
                                         cnt, collect_stats=True)
        assert stats[:4].tolist() == plain_stats.tolist()
        # the fifth counter: the visits that ended at the superbrick's box
        _, _, early_stats = mx2.trace_mx2_plain(
            mx, org, dirn, tnear, brk, ent, cnt, collect_stats=True,
            early_votes=True)
        assert stats.tolist() == early_stats.tolist()
        walk_t, _ = wavefront.trace_bricks_cuda(bricks, *org, *dirn, tnear)
        off = ~torch.isclose(t, walk_t, rtol=1e-4, atol=0.0)
        assert off.float().mean() <= 1e-3


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card (the kernel has no CPU mode)")
@pytest.mark.parametrize("nee", [False, True])
def test_cuda_mx2_render_launches_b7_only(nee):
    width, height = 64, 48
    pack, cd = _load(width, height, "cuda")
    mx = MX2Set.from_pack(pack).to("cuda")
    stats = {}
    b7 = mx2.trace_mx2_cuda.launches
    b2 = wavefront.trace_bricks_cuda.launches
    got = mx2.render_samples_mx2(mx, cd, width, height, 0, 2, max_depth=4,
                                 nee=nee, stats=stats)
    torch.cuda.synchronize()
    assert mx2.trace_mx2_cuda.launches == b7 + stats["waves"]
    assert wavefront.trace_bricks_cuda.launches == b2
    ref = mx2.render_samples_mx2(mx, cd, width, height, 0, 2, max_depth=4,
                                 nee=nee, tracer=mx2.trace_wave_mx2_plain)
    assert torch.equal(got, ref)
    assert float(ref.mean()) > 0.0
