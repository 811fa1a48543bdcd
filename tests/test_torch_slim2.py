"""Kernel B4, the slim walk with the deferred leaf (wavefront engine
"slim2"): its plain version (ops/brickkernel.py::
trace_bricks_pipelined_plain) against the JAX package and against kernel
B2's plain version on the CPU, over the set's own tensors and over the walk
table the kernel reads, and the kernel against both on a card.

The pruning best t of the deferred walk is one leaf stale, which only
admits more nodes and leaves; with strict ``t < best`` and leaves tested in
the walk's own order the winner cannot change, so B4 equals B2 bit for bit
(plain against plain here, kernel against kernel on the card) while its
per-ray counters are at least B2's.  Against the JAX Pallas kernel in
interpret mode at most 1e-3 of the rays of a wave may differ (XLA's FMA
contraction on a shared triangle edge, tests/test_torch_wavefront.py).  The
cases marked ``cuda`` skip without a card and import no jax, so on the card
this file runs with ``python -m pytest --noconftest -m cuda
tests/test_torch_slim2.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pathtracer_cuda_interactive_tpu_torch import SCENES_DIR
from pathtracer_cuda_interactive_tpu_torch.models.bricks import BrickSet
from pathtracer_cuda_interactive_tpu_torch.models.scenepack import load_scene
from pathtracer_cuda_interactive_tpu_torch.ops import (
    brickkernel, cuda_build, wavefront)
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


def _vec(a, device="cpu"):
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(c)).to(device)
                  for c in a.T))


@pytest.fixture(scope="module")
def bricks():
    return _load(W, H)[0]


@pytest.mark.parametrize("seed,tnear", [(0, 1e-4), (5, 0.0)])
def test_plain_b4_equals_plain_b2_and_enters_more_bricks(bricks, seed, tnear):
    o, d = _random_rays(seed=seed)
    t2, s2, c2 = brickkernel.trace_bricks_plain(
        bricks, _vec(o), _vec(d), tnear, collect_stats=True)
    t4, s4, c4 = brickkernel.trace_bricks_pipelined_plain(
        bricks, _vec(o), _vec(d), tnear, collect_stats=True)
    assert torch.equal(t4, t2) and torch.equal(s4, s2)
    assert (s2 >= 0).float().mean() > 0.9
    # the stale best t admits more: never fewer nodes or bricks, and more
    # bricks on some rays; a drain's chunk gates are exact, but an extra
    # brick may still pass one
    assert bool((c4 >= c2).all())
    assert int((c4[1] > c2[1]).sum()) > 0
    assert bool((c4[1] >= (s4 >= 0).to(torch.int32)).all())


@pytest.mark.parametrize("seed,tnear", [(1, 1e-4), (7, 0.0)])
def test_plain_b4_over_the_walk_table_equals_the_walk_over_the_set(
        bricks, seed, tnear):
    """What kernel B4 reads: the walk over the set's WalkTable gives the
    walk over the set's own tensors, and plain B2, bit for bit, counters
    included."""
    o, d = _random_rays(seed=seed)
    table = bricks.walk_table()
    t, s, c = brickkernel.trace_bricks_pipelined_plain(
        bricks, _vec(o), _vec(d), tnear, collect_stats=True, table=table)
    ref_t, ref_s, ref_c = brickkernel.trace_bricks_pipelined_plain(
        bricks, _vec(o), _vec(d), tnear, collect_stats=True)
    assert torch.equal(t.view(torch.int32), ref_t.view(torch.int32))
    assert torch.equal(s, ref_s) and torch.equal(c, ref_c)
    t2, s2 = brickkernel.trace_bricks_plain(bricks, _vec(o), _vec(d), tnear,
                                            table=table)
    assert torch.equal(t.view(torch.int32), t2.view(torch.int32))
    assert torch.equal(s, s2) and (s >= 0).float().mean() > 0.9


def test_plain_b4_active_mask_shape_and_empty(bricks):
    o, d = _random_rays()
    shape = (16, 128)
    org = Vec3(*(c.reshape(shape) for c in _vec(o)))
    dirn = Vec3(*(c.reshape(shape) for c in _vec(d)))
    active = (torch.arange(2048) % 3 == 0).reshape(shape)
    t_all, s_all = brickkernel.trace_bricks_pipelined_plain(bricks, org, dirn,
                                                            0.0)
    t, s = brickkernel.trace_bricks_pipelined_plain(bricks, org, dirn, 0.0,
                                                    active)
    assert t.shape == s.shape == shape
    assert torch.equal(t[active], t_all[active])
    assert torch.equal(s[active], s_all[active])
    assert bool((s[~active] == -1).all()) and bool(torch.isinf(t[~active]).all())
    t0, s0 = brickkernel.trace_bricks_pipelined_plain(
        bricks, Vec3.zeros((0,)), Vec3.zeros((0,)), 0.0)
    assert t0.shape == s0.shape == (0,)


def test_plain_b4_matches_jax_slim2():
    """The same rays and the same brick arrays through the JAX package's
    B4 (Pallas, interpret mode)."""
    import jax.numpy as jnp
    from pathtracer_cuda_interactive_tpu.models import native as jax_native
    from pathtracer_cuda_interactive_tpu.models.bricks import (
        BrickSet as JaxBrickSet)
    from pathtracer_cuda_interactive_tpu.models.scenepack import (
        load_scene as jax_load_scene)
    from pathtracer_cuda_interactive_tpu.ops import wavefront as jax_wavefront
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "build_sah_treelets_native",
                   lambda *args: None)
        jbricks = JaxBrickSet.from_pack(jax_load_scene(BLOB_BOX)[0])
    fields = {f.name: (getattr(jbricks, f.name)
                       if isinstance(getattr(jbricks, f.name), int)
                       else np.asarray(getattr(jbricks, f.name)))
              for f in dataclasses.fields(JaxBrickSet)}
    port = BrickSet.from_numpy(**fields)
    o, d = _random_rays()
    args = [jnp.asarray(np.ascontiguousarray(c).reshape(16, 128))
            for c in (*o.T, *d.T)]
    ref_t, ref_slot = jax_wavefront._trace_wave_slim2(
        jnp.asarray(jbricks.top_boxes), jnp.asarray(jbricks.top_links),
        jnp.asarray(jbricks.brick_data), 1e-4, *args,
        jnp.ones((16, 128), jnp.float32), interpret=True)
    ref_t = np.asarray(ref_t).reshape(-1)
    ref_slot = np.asarray(ref_slot).reshape(-1)
    t, slot = wavefront.trace_wave_slim2(port, _vec(o), _vec(d), 1e-4)
    t, slot = t.numpy(), slot.numpy()
    assert t.dtype == np.float32 and slot.dtype == np.int32
    assert (slot >= 0).mean() > 0.9
    differ = (slot != ref_slot) | ~np.isclose(t, ref_t, rtol=1e-5, atol=0.0)
    assert differ.mean() <= 1e-3, f"{differ.sum()} rays differ"
    assert np.array_equal(np.isinf(t), slot < 0)


def test_cpu_wave_takes_the_plain_version_and_launches_nothing(bricks):
    o, d = _random_rays()
    before = wavefront.trace_bricks_slim2_cuda.launches
    t, slot = wavefront.trace_wave_slim2(bricks, _vec(o), _vec(d), 0.0)
    ref_t, ref_slot = brickkernel.trace_bricks_pipelined_plain(
        bricks, _vec(o), _vec(d), 0.0)
    assert torch.equal(slot, ref_slot) and torch.equal(t, ref_t)
    assert wavefront.trace_bricks_slim2_cuda.launches == before == 0
    with pytest.raises(ValueError, match="CUDA"):
        wavefront.trace_bricks_slim2_cuda(bricks, *_vec(o), *_vec(d), 0.0)
    with pytest.raises(ValueError, match="bricks on"):
        wavefront.trace_wave_slim2(bricks.to("meta"), _vec(o), _vec(d), 0.0)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(wavefront, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(wavefront, "_slim2_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        wavefront.load_slim2_library()
    lib = cuda_build.library_path(wavefront.SLIM2_SOURCE, tmp_path)
    assert lib.name.startswith("brick_trace_slim2_")


def test_source_starts_the_copy_before_the_drain():
    """The kernel is B4 and not B2 under a second name: it runs the shared
    walk with the deferred leaf.  In that walk the found leaf is taken in
    hand first (on the card nothing is fetched ahead of it: with the walk
    table in L2 a prefetch measured slower than the deferral alone), then
    the pending leaf, not the found one, is entered, then the found leaf
    becomes the pending one, all before the warp's chunk tests."""
    src = wavefront.SLIM2_SOURCE.read_text()
    assert "brick_walk<false, false, true>" in src
    walk = (cuda_build.CSRC_DIR / "brick_walk.cuh").read_text()
    deferred = walk[walk.index(
        "while (next == end && (sp > 0 || (kDefer && pend >= 0)))"):]
    found = deferred.index("const int brick = __float_as_int(b.w);")
    drain = deferred.index("next = pend * kNumSubs;", found)
    handover = deferred.index("pend = brick;")
    tests = deferred.index("warp_chunk_round<kFull>(")
    assert 0 < found < drain < handover < tests


@pytest.mark.parametrize("nee", [False, True])
def test_slim2_render_equals_slim(nee):
    bricks, cd = _load(W, H)
    kw = dict(max_depth=3, nee=nee)
    ref = wavefront.render_samples_wavefront(bricks, cd, W, H, 0, 1, **kw)
    stats = {}
    got = wavefront.render_samples_wavefront(bricks, cd, W, H, 0, 1,
                                             trace="slim2", stats=stats, **kw)
    assert torch.equal(got, ref) and float(ref.mean()) > 0.0
    assert stats["waves"] == (6 if nee else 3)


@pytest.mark.parametrize("nee", [False, True])
def test_slim2_render_matches_jax(nee):
    """The port's wavefront with the plain B4 against the JAX wavefront with
    its pipelined Pallas walk in interpret mode, at the criterion of
    tests/test_wavefront.py:37-39."""
    import jax.numpy as jnp
    from pathtracer_cuda_interactive_tpu.models import native as jax_native
    from pathtracer_cuda_interactive_tpu.models.bricks import (
        BrickSet as JaxBrickSet)
    from pathtracer_cuda_interactive_tpu.models.scenepack import (
        load_scene as jax_load_scene)
    from pathtracer_cuda_interactive_tpu.ops import wavefront as jax_wavefront
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
    port, cd = BrickSet.from_numpy(**fields), _load(W, H)[1]
    ref = np.asarray(jax_wavefront.render_samples_wavefront(
        jbricks, jcd, W, H, 0, 1, max_depth=3, interpret=True, nee=nee,
        trace="slim2"))
    got = wavefront.render_samples_wavefront(port, cd, W, H, 0, 1,
                                             max_depth=3, nee=nee,
                                             trace="slim2").numpy()
    assert ref.mean() > 0.0
    bad = ~np.isclose(got, ref, rtol=1e-4, atol=1e-4)
    assert bad.mean() < 1e-3, f"{bad.mean():%} mismatched"
    assert np.abs(ref - got).mean() < 1e-3


def test_renderer_runs_slim2_on_the_cpu():
    ref = ProgressiveRenderer.from_xml(BLOB_BOX, RenderConfig(max_depth=3),
                                       width=W, height=H, device="cpu")
    r = ProgressiveRenderer.from_xml(
        BLOB_BOX, RenderConfig(max_depth=3, wavefront_trace="slim2"),
        width=W, height=H, device="cpu")
    assert r.mode == "wavefront"
    r.step()
    ref.step()
    assert r.waves == 3 and r.sample_count == 2
    assert torch.equal(r.accum, ref.accum)


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
@pytest.mark.parametrize("wave", [0, 1, 2])
def test_cuda_kernel_equals_b2_and_plain_on_waves(wave):
    bricks, cd = _load(160, 120, "cuda")
    org, dirn, tnear = _capture_waves(bricks, cd, 160, 120, 3)[wave]
    before = wavefront.trace_bricks_slim2_cuda.launches
    t, slot = wavefront.trace_bricks_slim2_cuda(bricks, *org, *dirn, tnear)
    torch.cuda.synchronize()
    assert wavefront.trace_bricks_slim2_cuda.launches == before + 1
    t2, s2 = wavefront.trace_bricks_cuda(bricks, *org, *dirn, tnear)
    tp, sp = brickkernel.trace_bricks_pipelined_plain(
        bricks, org, dirn, tnear, table=bricks.walk_table())
    assert torch.equal(t.view(torch.int32), t2.view(torch.int32))
    assert torch.equal(slot, s2)
    assert torch.equal(t.view(torch.int32), tp.view(torch.int32))
    assert torch.equal(slot, sp)
    assert (slot >= 0).float().mean() > 0.5


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card (the kernel has no CPU mode)")
@pytest.mark.parametrize("nee", [False, True])
def test_cuda_slim2_render_launches_b4_only(nee):
    width, height = 64, 48
    bricks, cd = _load(width, height, "cuda")
    stats = {}
    b4 = wavefront.trace_bricks_slim2_cuda.launches
    b2 = wavefront.trace_bricks_cuda.launches
    got = wavefront.render_samples_wavefront(bricks, cd, width, height, 0, 2,
                                             max_depth=4, nee=nee,
                                             trace="slim2", stats=stats)
    torch.cuda.synchronize()
    assert wavefront.trace_bricks_slim2_cuda.launches == b4 + stats["waves"]
    assert wavefront.trace_bricks_cuda.launches == b2
    ref = wavefront.render_samples_wavefront(bricks, cd, width, height, 0, 2,
                                             max_depth=4, nee=nee)
    assert torch.equal(got, ref) and float(ref.mean()) > 0.0
