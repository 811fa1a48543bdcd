"""Kernel B5, the pair-list brick trace (wavefront engine "pairs[N]",
ops/pairtrace.py): the visit-list builders and the kernel's plain version
against the JAX package on the CPU, and the kernel against its plain
version and kernel B2 on a card; the brick-box vote of kernel B5 against
the chunk gates it stands in front of.

The same numpy rays and the same brick arrays go through both packages.
The JAX waves are [rows, 128] tables with an active mask; the port's are
[N], in packets of consecutive rays, so the cull's inputs are reshaped to
the same [M, K] packets on both sides.  Entry bounds agree to rtol 1e-6
(XLA may contract a multiply-add), the finite set and the pair order
exactly.  t per ray is the walk's (kernel B2's plain version) on every ray;
against the JAX kernel in interpret mode at most 1e-3 of the rays of a wave
may differ (the FMA edge ray, tests/test_torch_wavefront.py).  The cases
marked ``cuda`` skip without a card and import no jax, so on the card this
file runs with ``python -m pytest --noconftest -m cuda
tests/test_torch_pairtrace.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pathtracer_cuda_interactive_tpu_torch import SCENES_DIR
from pathtracer_cuda_interactive_tpu_torch.models.bricks import BrickSet
from pathtracer_cuda_interactive_tpu_torch.models.scenepack import load_scene
from pathtracer_cuda_interactive_tpu_torch.ops import (
    brickkernel, cuda_build, pairtrace, wavefront)
from pathtracer_cuda_interactive_tpu_torch.ops.camera import (
    Camera, camera_ray_data)
from pathtracer_cuda_interactive_tpu_torch.ops.vec import Vec3
from pathtracer_cuda_interactive_tpu_torch.render.renderer import (
    ProgressiveRenderer)
from pathtracer_cuda_interactive_tpu_torch.utils.config import RenderConfig

# several test workers at once: one intra-op thread per process
torch.set_num_threads(1)

W, H = 32, 24
BLOB_BOX = str(SCENES_DIR / "blob_box.xml")
INF = float("inf")


def _load(width, height, device="cpu"):
    pack, parsed = load_scene(BLOB_BOX)
    cd = camera_ray_data(Camera.from_parsed(parsed.camera), width, height)
    return (BrickSet.from_pack(pack).to(device),
            torch.from_numpy(cd).to(device))


def _random_rays(n=2048, seed=0):
    """Rays from inside the box toward the blob; the first 64 run straight
    down from origins on the ceiling plane (0 * inf = NaN in the slab
    test)."""
    rs = np.random.default_rng(seed)
    o = rs.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 1.5], (n, 3))
    tgt = rs.uniform([-0.7, 0.1, -0.7], [0.2, 1.1, 0.35], (n, 3))
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:64] = [0.0, -1.0, 0.0]
    o[:64, 1] = 2.0
    return o.astype(np.float32), d.astype(np.float32)


def _coherent_rays(n, seed):
    """Rays with small origin boxes and sign-definite direction bounds per
    run of 128, so that the cull drops bricks."""
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


def _jax_bricks():
    """(JAX BrickSet, the port's BrickSet built from its fields)."""
    from pathtracer_cuda_interactive_tpu.models import native as jax_native
    from pathtracer_cuda_interactive_tpu.models.bricks import (
        BrickSet as JaxBrickSet)
    from pathtracer_cuda_interactive_tpu.models.scenepack import (
        load_scene as jax_load_scene)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "build_sah_treelets_native",
                   lambda *args: None)
        jbricks = JaxBrickSet.from_pack(jax_load_scene(BLOB_BOX)[0])
    fields = {f.name: (getattr(jbricks, f.name)
                       if isinstance(getattr(jbricks, f.name), int)
                       else np.asarray(getattr(jbricks, f.name)))
              for f in dataclasses.fields(JaxBrickSet)}
    return jbricks, BrickSet.from_numpy(**fields)


@pytest.fixture(scope="module")
def bricks():
    return _load(W, H)[0]


def _cull_inputs(case):
    """(o [n, 3], d [n, 3], rays per packet, active [M, K] or None)."""
    if case == "coherent":
        o, d = _coherent_rays(2048, 1)
        return o, d, 256, None
    if case == "random":
        o, d = _random_rays(seed=2)
        return o, d, 512, None
    if case == "masked":
        # a partial last packet: the tail of the table is padding
        o, d = _coherent_rays(2048, 3)
        active = np.ones(2048, bool)
        active[1700:] = False
        return o, d, 256, active.reshape(-1, 256)
    # "axis_parallel": every ray of a packet runs along -y from an origin on
    # a brick's top plane; two axes span zero and put no constraint
    o, d = _coherent_rays(1024, 4)
    d[:] = [0.0, -1.0, 0.0]
    return o, d, 256, "plane"


@pytest.mark.parametrize("case", ["coherent", "random", "masked",
                                  "axis_parallel"])
def test_interval_cull_and_pack_pairs_match_jax(case):
    import jax.numpy as jnp
    from pathtracer_cuda_interactive_tpu.ops import pairtrace as jax_pairtrace
    from pathtracer_cuda_interactive_tpu.ops.vec import Vec3 as JaxVec3
    jbricks, port = _jax_bricks()
    o, d, K, active = _cull_inputs(case)
    if isinstance(active, str):
        o[:, 1] = np.asarray(jbricks.brick_hi)[3, 1]
        active = None
    M = len(o) // K
    if active is None:
        active = np.ones((M, K), bool)
    tnear = 1e-4
    jv = lambda a: JaxVec3(*(jnp.asarray(c.reshape(M, K)) for c in a.T))
    tv = lambda a: Vec3(*(torch.from_numpy(np.ascontiguousarray(c))
                          .reshape(M, K) for c in a.T))
    ref = np.asarray(jax_pairtrace._interval_cull(
        jv(o), jv(d), jnp.asarray(active), jnp.asarray(jbricks.brick_lo),
        jnp.asarray(jbricks.brick_hi), tnear))
    lb = pairtrace._interval_cull(tv(o), tv(d), torch.from_numpy(active),
                                  port.brick_lo, port.brick_hi, tnear)
    got = lb.numpy()
    assert got.shape == ref.shape == (M, port.num_bricks)
    assert got.dtype == np.float32
    assert np.array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-6, atol=0.0)
    if case in ("coherent", "masked"):
        assert 0.02 < fin.mean() < 0.9            # the cull does cull
    if case == "masked":
        assert not fin[-1].any() and fin[-2].any()   # an all-padding packet

    # the pair order: the port's rows, valid prefixes end to end, are the
    # JAX package's flat list.  Feed both the JAX bounds so that a bound
    # that differs in its last bit cannot reorder two bricks.
    pkt_s, brk_s, ent_s, count = jax_pairtrace._pack_pairs(jnp.asarray(ref))
    count = int(count)
    brk, ent, cnt = pairtrace._pack_pairs(torch.from_numpy(ref.copy()))
    assert brk.dtype == torch.int32 and cnt.dtype == torch.int32
    assert int(cnt.sum()) == count == int(fin.sum())
    rows = [np.arange(int(c)) for c in cnt]
    flat_pkt = np.concatenate([np.full(len(r), p) for p, r in enumerate(rows)])
    flat_brk = np.concatenate([brk[p, :len(r)].numpy()
                               for p, r in enumerate(rows)])
    flat_ent = np.concatenate([ent[p, :len(r)].numpy()
                               for p, r in enumerate(rows)])
    np.testing.assert_array_equal(flat_pkt, np.asarray(pkt_s)[:count])
    np.testing.assert_array_equal(flat_brk, np.asarray(brk_s)[:count])
    np.testing.assert_array_equal(flat_ent, np.asarray(ent_s)[:count])
    assert bool(torch.isinf(ent[torch.arange(port.num_bricks)[None, :]
                                >= cnt[:, None]]).all())


def test_pack_pairs_near_first_and_stable():
    lb = torch.tensor([[3.0, INF, 1.0, 1.0],     # bricks 2, 3 (tie), then 0
                       [INF, INF, INF, INF],     # visits nothing
                       [0.5, 2.0, 1.0, 0.5]])    # 0, 3 (tie), 2, 1
    brk, ent, cnt = pairtrace._pack_pairs(lb)
    assert cnt.tolist() == [3, 0, 4]
    assert brk[0, :3].tolist() == [2, 3, 0]
    assert brk[2].tolist() == [0, 3, 2, 1]
    assert ent[2].tolist() == [0.5, 0.5, 1.0, 2.0]
    assert brk.is_contiguous() and ent.is_contiguous()


@pytest.mark.parametrize("n,packet_rows", [(2048, 32), (2048, 4), (1900, 4),
                                           (300, 1)])
def test_plain_b5_t_equals_the_walk_on_every_ray(bricks, n, packet_rows):
    """Partial last packets included (1900 = 3 x 512 + 364, 300 = 2 x 128 +
    44)."""
    o, d = _random_rays(n, seed=6)
    ref_t, ref_slot = brickkernel.trace_bricks_plain(bricks, _vec(o), _vec(d),
                                                     1e-4)
    before = pairtrace.trace_pairs_cuda.launches
    t, slot = pairtrace.trace_wave_pairs(bricks, _vec(o), _vec(d), 1e-4,
                                         packet_rows)
    assert pairtrace.trace_pairs_cuda.launches == before == 0
    assert t.dtype == torch.float32 and slot.dtype == torch.int32
    assert torch.equal(t, ref_t)
    assert (slot != ref_slot).float().mean() <= 1e-3       # equal-t ties
    assert bool(((slot >= 0) == torch.isfinite(t)).all())
    assert (slot >= 0).float().mean() > 0.9


def test_plain_b5_on_coherent_packets_and_empty_wave(bricks):
    """Packets whose lists leave bricks out give the walk's t too."""
    o, d = _coherent_rays(2048, 7)
    brk, ent, cnt = pairtrace.visit_lists(bricks, _vec(o), _vec(d), 0.0, 1)
    assert brk.shape == (16, bricks.num_bricks)
    assert int(cnt.min()) < bricks.num_bricks
    ref_t, _ = brickkernel.trace_bricks_plain(bricks, _vec(o), _vec(d), 0.0)
    t, slot = pairtrace.trace_pairs_plain(bricks, _vec(o), _vec(d), 0.0, brk,
                                          ent, cnt, 128)
    assert torch.equal(t, ref_t)
    t0, s0 = pairtrace.trace_wave_pairs(bricks, Vec3.zeros((0,)),
                                        Vec3.zeros((0,)), 0.0)
    assert t0.shape == s0.shape == (0,) and s0.dtype == torch.int32


def test_visit_boxes_hold_their_valid_gates(bricks):
    """Every brick's visit box (what kernel B5 votes on before the 16 gates)
    is the brick's box, holds each of its valid chunk boxes, and counts
    them."""
    boxes = bricks.visit_boxes()
    assert boxes.shape == (bricks.num_bricks, 8) and boxes.is_contiguous()
    assert bricks.visit_boxes() is boxes
    assert torch.equal(boxes[:, :3], bricks.brick_lo)
    assert torch.equal(boxes[:, 3:6], bricks.brick_hi)
    sub = bricks.sub_boxes
    valid = sub[:, :, 6] > 0.0
    assert torch.equal(boxes[:, 6], valid.sum(dim=1).float())
    assert bool((boxes[:, 7] == 0.0).all()) and bool((boxes[:, 6] >= 1).all())
    inside = ((sub[:, :, :3] >= boxes[:, None, :3]).all(dim=2)
              & (sub[:, :, 3:6] <= boxes[:, None, 3:6]).all(dim=2))
    assert bool(inside[valid].all())
    moved = bricks.to("cpu")
    assert moved.visit_boxes() is not boxes
    assert torch.equal(moved.visit_boxes(), boxes)


def _vote_rays(case, bricks):
    """(o, d, t_max) [n] for the brick-box vote: random rays at random best
    t; axis-parallel rays; and axis-parallel rays from origins on box
    planes (0 * inf = NaN in the slab test)."""
    rs = np.random.default_rng({"random": 11, "axis_parallel": 12,
                                "on_plane": 13}[case])
    n = 4096
    o = rs.uniform([-1.0, 0.0, -1.0], [1.0, 2.0, 1.6], (n, 3))
    if case == "random":
        d = rs.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    else:
        axis = rs.integers(0, 3, n)
        d = np.zeros((n, 3))
        d[np.arange(n), axis] = rs.choice([-1.0, 1.0], n)
        if case == "on_plane":
            # the origin's other two coordinates on a plane of some brick's
            # or some gate's box
            sub = bricks.sub_boxes.numpy().reshape(-1, 8)
            planes = np.concatenate([bricks.visit_boxes().numpy()[:, :6],
                                     sub[sub[:, 6] > 0, :6]])
            pick = planes[rs.integers(0, len(planes), n)]
            for k in range(n):
                for ax in range(3):
                    if ax != axis[k]:
                        o[k, ax] = pick[k, ax + 3 * rs.integers(0, 2)]
    t_max = np.where(rs.random(n) < 0.3, np.inf, rs.uniform(0.0, 3.0, n))
    return (o.astype(np.float32), d.astype(np.float32),
            torch.from_numpy(t_max.astype(np.float32)))


@pytest.mark.parametrize("case", ["random", "axis_parallel", "on_plane"])
def test_brick_box_vote_says_yes_wherever_a_gate_does(bricks, case):
    """``slab_maybe`` on a brick's visit box at a ray's best t is true
    wherever the exact slab test of one of its valid gates is: kernel B5's
    vote can only end a visit that no gate would let through."""
    from pathtracer_cuda_interactive_tpu_torch.ops import geometry as g
    o, d, t_max = _vote_rays(case, bricks)
    org, dirn = _vec(o), _vec(d)
    inv = Vec3(1.0 / dirn.x, 1.0 / dirn.y, 1.0 / dirn.z)
    col = lambda v: Vec3(v.x[:, None], v.y[:, None], v.z[:, None])
    box = bricks.visit_boxes()
    tn, tf = g.slab_interval(col(org), col(inv),
                             Vec3(box[:, 0], box[:, 1], box[:, 2]),
                             Vec3(box[:, 3], box[:, 4], box[:, 5]))
    maybe = g.slab_maybe(tn, tf, t_max[:, None])             # [n, B]
    sub = bricks.sub_boxes
    any_gate = torch.zeros_like(maybe)
    nan_seen = 0
    for s in range(sub.shape[1]):
        tn, tf = g.slab_interval(col(org), col(inv),
                                 Vec3(sub[:, s, 0], sub[:, s, 1], sub[:, s, 2]),
                                 Vec3(sub[:, s, 3], sub[:, s, 4], sub[:, s, 5]))
        nan_seen += int((torch.isnan(tn) | torch.isnan(tf)).sum())
        any_gate |= (sub[:, s, 6] > 0.0) & g.slab_hit(tn, tf, t_max[:, None])
    assert bool(any_gate.any())
    assert not bool((any_gate & ~maybe).any())
    assert bool((maybe & ~any_gate).any())      # the vote is looser
    if case == "on_plane":
        assert nan_seen > 0


@pytest.mark.parametrize("case,packet_rows", [
    ("random", 1), ("random", 4), ("coherent", 1), ("coherent", 4)])
def test_plain_early_votes_give_the_plain_walk_and_counters(bricks, case,
                                                            packet_rows):
    """``trace_pairs_plain(early_votes=True)``, the kernel's walk with its
    vote on the brick's own box, gives the plain walk's (t, slot) bit for
    bit and the same three counters, plus the visits that ended at the
    box; the counters are per warp of 32 rays."""
    group = pairtrace.PAIR_GROUP
    o, d = (_random_rays(1900, 21) if case == "random"
            else _coherent_rays(1900, 22))
    org, dirn = _vec(o), _vec(d)
    brk, ent, cnt = pairtrace.visit_lists(bricks, org, dirn, 1e-4,
                                          packet_rows)
    rays = packet_rows * 128
    t, slot = pairtrace.trace_pairs_plain(bricks, org, dirn, 1e-4, brk, ent,
                                          cnt, rays)
    t3, s3, c3 = pairtrace.trace_pairs_plain(bricks, org, dirn, 1e-4, brk,
                                             ent, cnt, rays,
                                             collect_stats=True)
    t4, s4, c4 = pairtrace.trace_pairs_plain(bricks, org, dirn, 1e-4, brk,
                                             ent, cnt, rays,
                                             collect_stats=True,
                                             early_votes=True)
    for got_t, got_s in ((t3, s3), (t4, s4)):
        assert torch.equal(got_t.view(torch.int32), t.view(torch.int32))
        assert torch.equal(got_s, slot)
    assert c3.tolist() == c4[:3].tolist() and len(c4) == 4
    listed, skipped, tested, boxed_out = c4.tolist()
    # each warp of a packet that holds a ray sees the packet's whole list
    assert listed == sum(int(cnt[p]) * -(-min(rays, 1900 - p * rays) // group)
                         for p in range(int(cnt.numel())))
    assert 0 <= skipped < listed and tested > 0
    assert 0 < boxed_out < listed - skipped
    ref_t, _ = brickkernel.trace_bricks_plain(bricks, org, dirn, 1e-4)
    assert torch.equal(t, ref_t)


@pytest.mark.parametrize("packet_rows", [16, 8])
def test_plain_b5_matches_jax_trace_wave_pairs(packet_rows):
    import jax.numpy as jnp
    from pathtracer_cuda_interactive_tpu.ops import pairtrace as jax_pairtrace
    jbricks, port = _jax_bricks()
    o, d = _random_rays()
    args = [jnp.asarray(np.ascontiguousarray(c).reshape(16, 128))
            for c in (*o.T, *d.T)]
    ref_t, ref_slot = jax_pairtrace.trace_wave_pairs(
        jnp.asarray(jbricks.brick_data), jnp.asarray(jbricks.brick_lo),
        jnp.asarray(jbricks.brick_hi), 1e-4, *args,
        jnp.ones((16, 128), jnp.float32), interpret=True,
        packet_rows=packet_rows)
    ref_t = np.asarray(ref_t).reshape(-1)
    ref_slot = np.asarray(ref_slot).reshape(-1)
    t, slot = pairtrace.trace_wave_pairs(port, _vec(o), _vec(d), 1e-4,
                                         packet_rows)
    t, slot = t.numpy(), slot.numpy()
    assert (slot >= 0).mean() > 0.9
    differ = (slot != ref_slot) | ~np.isclose(t, ref_t, rtol=1e-5, atol=0.0)
    assert differ.mean() <= 1e-3, f"{differ.sum()} rays differ"


def test_wrappers_check_their_inputs(bricks, tmp_path, monkeypatch):
    o, d = _random_rays(256)
    brk, ent, cnt = pairtrace.visit_lists(bricks, _vec(o), _vec(d), 0.0, 2)
    with pytest.raises(ValueError, match="CUDA"):
        pairtrace.trace_pairs_cuda(bricks, *_vec(o), *_vec(d), 0.0, brk, ent,
                                   cnt, 256)
    with pytest.raises(ValueError, match="bricks on"):
        pairtrace.trace_wave_pairs(bricks.to("meta"), _vec(o), _vec(d), 0.0)
    with pytest.raises(ValueError, match="packet_rows"):
        pairtrace.trace_wave_pairs(bricks, _vec(o), _vec(d), 0.0, 0)
    monkeypatch.setattr(pairtrace, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        pairtrace.build()
    lib = cuda_build.library_path(pairtrace.SOURCE, tmp_path)
    assert lib.name.startswith("pair_trace_")


@pytest.mark.parametrize("engine", ["pairs", "pairs8"])
@pytest.mark.parametrize("nee", [False, True])
def test_pairs_render_matches_jax(engine, nee):
    """The port's wavefront with the plain B5 against the JAX wavefront with
    its Pallas pair kernel in interpret mode, at the criterion of
    tests/test_wavefront.py:37-39."""
    import jax.numpy as jnp
    from pathtracer_cuda_interactive_tpu.ops import wavefront as jax_wavefront
    from pathtracer_cuda_interactive_tpu.ops.camera import (
        Camera as JaxCamera, camera_ray_data as jax_camera_ray_data)
    from pathtracer_cuda_interactive_tpu.models.scenepack import (
        load_scene as jax_load_scene)
    jbricks, port = _jax_bricks()
    jcd = jnp.asarray(jax_camera_ray_data(
        JaxCamera.from_parsed(jax_load_scene(BLOB_BOX)[1].camera), W, H))
    cd = _load(W, H)[1]
    ref = np.asarray(jax_wavefront.render_samples_wavefront(
        jbricks, jcd, W, H, 0, 1, max_depth=3, interpret=True, nee=nee,
        trace=engine))
    got = wavefront.render_samples_wavefront(port, cd, W, H, 0, 1,
                                             max_depth=3, nee=nee,
                                             trace=engine).numpy()
    assert ref.mean() > 0.0
    bad = ~np.isclose(got, ref, rtol=1e-4, atol=1e-4)
    assert bad.mean() < 1e-3, f"{bad.mean():%} mismatched"
    assert np.abs(ref - got).mean() < 1e-3


def test_port_pairs_reproducible_and_sample_additive():
    bricks, cd = _load(W, H)
    kw = dict(max_depth=2, trace="pairs")
    a = wavefront.render_samples_wavefront(bricks, cd, W, H, 0, 2, **kw)
    b0 = wavefront.render_samples_wavefront(bricks, cd, W, H, 0, 1, **kw)
    b1 = wavefront.render_samples_wavefront(bricks, cd, W, H, 1, 1, **kw)
    torch.testing.assert_close(a, b0 + b1, rtol=1e-5, atol=1e-6)
    a2 = wavefront.render_samples_wavefront(bricks, cd, W, H, 0, 2, **kw)
    assert torch.equal(a, a2)


def test_renderer_runs_pairs_on_the_cpu():
    r = ProgressiveRenderer.from_xml(
        BLOB_BOX, RenderConfig(max_depth=3, wavefront_trace="pairs8",
                               enable_nee=True),
        width=W, height=H, device="cpu")
    assert r.mode == "wavefront"
    r.step()
    assert r.waves == 6 and r.sample_count == 2
    img = r.hdr()
    assert np.isfinite(img).all() and img.mean() > 0.0


# -- on the card ---------------------------------------------------------------

def _capture_waves(bricks, cd, width, height, n_waves):
    waves = []

    def recording(b, org, dirn, tnear):
        waves.append((org, dirn, tnear))
        return brickkernel.trace_bricks_plain(b, org, dirn, tnear)

    wavefront.render_samples_wavefront(bricks, cd, width, height, 0, 1,
                                       max_depth=n_waves, tracer=recording)
    return waves[:n_waves]


# The condition is a string, so it is evaluated when the test runs, not
# when the module is imported.
@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card (the kernel has no CPU mode)")
@pytest.mark.parametrize("packet_rows", [32, 8, 1])
def test_cuda_kernel_matches_plain_and_b2_on_waves(packet_rows):
    bricks, cd = _load(160, 120, "cuda")
    for org, dirn, tnear in _capture_waves(bricks, cd, 160, 120, 3):
        before = pairtrace.trace_pairs_cuda.launches
        t, slot = pairtrace.trace_wave_pairs(bricks, org, dirn, tnear,
                                             packet_rows)
        torch.cuda.synchronize()
        assert pairtrace.trace_pairs_cuda.launches == before + 1
        t2, s2 = wavefront.trace_bricks_cuda(bricks, *org, *dirn, tnear)
        assert torch.equal(t, t2)
        assert (slot != s2).float().mean() <= 1e-4
        brk, ent, cnt = pairtrace.visit_lists(bricks, org, dirn, tnear,
                                              packet_rows)
        tp, sp, plain_stats = pairtrace.trace_pairs_plain(
            bricks, org, dirn, tnear, brk, ent, cnt, packet_rows * 128,
            collect_stats=True, early_votes=True)
        assert torch.equal(t.view(torch.int32), tp.view(torch.int32))
        assert torch.equal(slot, sp)
        _, _, stats = pairtrace.trace_pairs_cuda(
            bricks, *org, *dirn, tnear, brk, ent, cnt, packet_rows * 128,
            collect_stats=True)
        assert stats.tolist() == plain_stats.tolist()
        listed, skipped, tested, boxed_out = stats.tolist()
        assert listed >= int(cnt.sum()) and 0 <= skipped <= listed
        assert tested > 0
    # a brick set that is not on the rays' card is refused before any launch
    with pytest.raises(ValueError, match="bricks on"):
        pairtrace.trace_pairs_cuda(bricks.to("cpu"), *org, *dirn, tnear, brk,
                                   ent, cnt, packet_rows * 128)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card (the kernel has no CPU mode)")
@pytest.mark.parametrize("nee", [False, True])
def test_cuda_pairs_render_launches_b5_only(nee):
    width, height = 64, 48
    bricks, cd = _load(width, height, "cuda")
    stats = {}
    b5 = pairtrace.trace_pairs_cuda.launches
    b2 = wavefront.trace_bricks_cuda.launches
    got = wavefront.render_samples_wavefront(bricks, cd, width, height, 0, 2,
                                             max_depth=4, nee=nee,
                                             trace="pairs8", stats=stats)
    torch.cuda.synchronize()
    assert pairtrace.trace_pairs_cuda.launches == b5 + stats["waves"]
    assert wavefront.trace_bricks_cuda.launches == b2
    ref = wavefront.render_samples_wavefront(bricks, cd, width, height, 0, 2,
                                             max_depth=4, nee=nee)
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    bad = ~np.isclose(got, ref, rtol=1e-4, atol=1e-4)
    assert bad.mean() < 1e-3 and np.abs(got - ref).mean() < 1e-3
    assert ref.mean() > 0.0
