"""The full-record brick trace (kernel B3) of the port, on the CPU.

* its plain version (ops/brickkernel.py::trace_bricks_full_plain) against
  the JAX package's Pallas kernel in interpret mode
  (``ops/wavefront.py::_trace_wave(..., interpret=True)``) on the same
  BrickSet: t to rtol 1e-5, the other 15 channels to rtol = atol = 1e-4,
  on all but 1e-3 of the rays (XLA's fused multiply-adds move shared-edge
  hits, ROADMAP C5; one ray of the 2048 random ones differs);
* its walk against the slim walk of kernel B2 on a sphere-free brick set;
* the per-ray counters (the TPU counts per packet; ROADMAP C4) and their
  summary in render/kernel_stats.py;
* the dispatcher ``ops/wavefront.py::trace_wave_full`` on the CPU.

The CUDA kernel runs only on a card: the ``cuda`` case skips without one.
It holds B3 to the plain version on the waves of a wavefront render, all
16 channels and the counters, on all but 1e-4 of the rays.  It imports no
jax, so on the card it runs with
``python -m pytest --noconftest -m cuda tests/test_torch_brick_full.py``.
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
from pathtracer_cuda_interactive_tpu_torch.ops.vec import Vec3
from pathtracer_cuda_interactive_tpu_torch.render import kernel_stats

# The suite runs in several worker processes at once and these tensors are
# small: one intra-op thread per process keeps the workers from spinning
# against each other for the machine's cores.
torch.set_num_threads(1)

W, H = 32, 24
BLOB_BOX = str(SCENES_DIR / "blob_box.xml")
INF = float("inf")


@pytest.fixture(scope="module")
def blob():
    """blob_box (a sphere, a point light, 5,120 blob triangles) as (JAX
    BrickSet, port BrickSet built from its fields).  The JAX package is
    imported here and in ``_jax_b3``, so the ``cuda`` case runs where jax
    is not installed."""
    from pathtracer_cuda_interactive_tpu.models import native as jax_native
    from pathtracer_cuda_interactive_tpu.models.bricks import (
        BrickSet as JaxBrickSet)
    from pathtracer_cuda_interactive_tpu.models.scenepack import (
        load_scene as jax_load_scene)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "build_sah_treelets_native",
                   lambda *args: None)
        jpack, _ = jax_load_scene(BLOB_BOX)
        jbricks = JaxBrickSet.from_pack(jpack)
    fields = {f.name: (getattr(jbricks, f.name)
                       if isinstance(getattr(jbricks, f.name), int)
                       else np.asarray(getattr(jbricks, f.name)))
              for f in dataclasses.fields(JaxBrickSet)}
    return jbricks, BrickSet.from_numpy(**fields)


def _random_rays(n=2048, seed=0):
    """Rays from inside the box toward the blob and the sphere; the first 64
    run straight down (an axis-parallel direction) from origins on the
    ceiling plane, where the slab test computes 0 * inf = NaN."""
    rs = np.random.default_rng(seed)
    o = rs.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 1.5], (n, 3))
    tgt = rs.uniform([-0.7, 0.1, -0.7], [0.2, 1.1, 0.35], (n, 3))
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:64] = [0.0, -1.0, 0.0]
    o[:64, 1] = 2.0
    return o.astype(np.float32), d.astype(np.float32)


def _primary_wave():
    """The camera rays of blob_box at 32x24 (pixel centres) in the wave
    layout, padded to one [16, 128] packet by repeating the first ray."""
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


def _vec(a):
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a.T))


def _jax_b3(jbricks, o, d, tnear):
    """The JAX full trace kernel B3 in interpret mode on one [16, 128]
    wave: 16 channels, each flattened."""
    import jax.numpy as jnp
    from pathtracer_cuda_interactive_tpu.ops import wavefront as jax_wavefront
    args = [jnp.asarray(np.ascontiguousarray(c).reshape(16, 128))
            for c in (*o.T, *d.T)]
    rec = jax_wavefront._trace_wave(
        jnp.asarray(jbricks.sph_rows), jnp.asarray(jbricks.top_boxes),
        jnp.asarray(jbricks.top_links), jnp.asarray(jbricks.brick_data),
        tnear, *args, jnp.ones((16, 128), jnp.float32), jbricks.num_spheres,
        interpret=True)
    return [np.asarray(r).reshape(-1) for r in rec]


@pytest.mark.parametrize("wave", ["primary", "random"])
def test_full_plain_matches_jax_b3(blob, wave):
    jbricks, bricks = blob
    o, d = _primary_wave() if wave == "primary" else _random_rays()
    tnear = 0.0 if wave == "primary" else 1e-4
    ref = _jax_b3(jbricks, o, d, tnear)
    got = [c.numpy() for c in brickkernel.trace_bricks_full_plain(
        bricks, _vec(o), _vec(d), tnear)]
    assert len(got) == 16 and all(c.dtype == np.float32 for c in got)
    differ = ~np.isclose(got[0], ref[0], rtol=1e-5, atol=0.0)
    for g, r in zip(got[1:], ref[1:]):
        differ |= ~np.isclose(g, r, rtol=1e-4, atol=1e-4)
    assert differ.mean() <= 1e-3, f"{differ.sum()} rays differ"
    assert np.isfinite(got[0]).mean() > 0.9
    if wave == "random":
        # the mirror sphere is hit, and wins its rays' records
        sph = np.asarray(jbricks.sph_rows)[0]
        assert (np.isfinite(got[0]) & (got[7] == sph[19])).sum() > 20


def test_full_walk_equals_the_slim_walk_without_spheres(blob):
    bricks = dataclasses.replace(blob[1], num_spheres=0)
    o, d = _vec(_random_rays()[0]), _vec(_random_rays()[1])
    ref_t, ref_slot = brickkernel.trace_bricks_plain(bricks, o, d, 1e-4)
    start = torch.full((2048,), INF)
    t, slot, uv, _ = brickkernel._walk(bricks, o, d, 1e-4, start, full=True)
    assert torch.equal(t, ref_t) and torch.equal(slot, ref_slot)
    rec = brickkernel.trace_bricks_full_plain(bricks, o, d, 1e-4)
    assert torch.equal(rec[0], ref_t)
    # the material channels are the winning slot's record
    hit = ref_slot >= 0
    rows = brickkernel.slot_rows(bricks, ref_slot)
    for k, j in ((7, 19), (8, 20), (9, 21), (10, 22), (11, 23), (15, 27)):
        assert torch.equal(rec[k][hit], rows[hit, j])
    assert bool((uv[0][hit] >= 0).all()) and bool((uv[1][hit] >= 0).all())


def test_counters_and_active_mask(blob):
    bricks = blob[1]
    o, d = _vec(_random_rays(seed=1)[0]), _vec(_random_rays(seed=1)[1])
    active = torch.from_numpy(np.arange(2048) % 3 != 0)
    rec_all, c_all = brickkernel.trace_bricks_full_plain(
        bricks, o, d, 1e-4, collect_stats=True)
    rec, c = brickkernel.trace_bricks_full_plain(bricks, o, d, 1e-4, active,
                                                 collect_stats=True)
    assert c.dtype == torch.int32 and c.shape == (3, 2048)
    for a, b in zip(rec, rec_all):
        assert torch.equal(a[active], b[active])
    assert torch.equal(c[:, active], c_all[:, active])
    # untraced rays: a miss and no counts
    assert bool(torch.isinf(rec[0][~active]).all())
    assert all(bool((ch[~active] == 0).all()) for ch in rec[1:])
    assert bool((c[:, ~active] == 0).all())
    nodes, bricks_in, chunks = c_all
    assert bool((nodes >= 1).all()) and bool((bricks_in <= nodes).all())
    assert bool((chunks <= 16 * bricks_in).all())
    assert float(bricks_in.float().mean()) >= 1.0
    # without counters, the same record
    plain = brickkernel.trace_bricks_full_plain(bricks, o, d, 1e-4)
    assert all(torch.equal(a, b) for a, b in zip(plain, rec_all))
    empty, c0 = brickkernel.trace_bricks_full_plain(
        bricks, Vec3.zeros((0,)), Vec3.zeros((0,)), 0.0, collect_stats=True)
    assert len(empty) == 16 and empty[0].shape == (0,)
    assert c0.shape == (3, 0)


def test_cpu_wave_launches_no_kernel(blob):
    bricks = blob[1]
    o, d = _vec(_random_rays()[0]), _vec(_random_rays()[1])
    before = wavefront.trace_bricks_full_cuda.launches
    rec, counts = wavefront.trace_wave_full(bricks, o, d, 0.0,
                                            collect_stats=True)
    ref, ref_counts = brickkernel.trace_bricks_full_plain(
        bricks, o, d, 0.0, collect_stats=True)
    assert all(torch.equal(a, b) for a, b in zip(rec, ref))
    assert torch.equal(counts, ref_counts)
    assert len(wavefront.trace_wave_full(bricks, o, d, 0.0)) == 16
    assert wavefront.trace_bricks_full_cuda.launches == before == 0
    with pytest.raises(ValueError, match="CUDA"):
        wavefront.trace_bricks_full_cuda(bricks, *o, *d, 0.0)
    with pytest.raises(ValueError, match="bricks on"):
        wavefront.trace_wave_full(bricks.to("meta"), o, d, 0.0)


def test_counter_summary():
    nodes = torch.arange(64, dtype=torch.int32)          # two warps
    counts = torch.stack([nodes, nodes // 2, torch.zeros_like(nodes)])
    s = kernel_stats.counter_summary(counts)
    assert s["nodes"]["mean"] == 31.5 and s["nodes"]["max"] == 63
    assert s["nodes"]["warp_max_mean"] == (31 + 63) / 2
    assert s["nodes"]["useful_share"] == pytest.approx(31.5 / 47)
    assert s["bricks"]["warp_max_mean"] == (15 + 31) / 2
    assert s["chunks"]["useful_share"] == 0.0
    # a ragged last warp counts its own lanes only
    s = kernel_stats.counter_summary(counts[:, :40])
    assert s["nodes"]["warp_max_mean"] == (31 + 39) / 2


def test_kernel_stats_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        kernel_stats.main([])


def _record_differs(rec, counts, ref, ref_counts):
    """Rays where B3 and its plain version disagree: a channel off by more
    than float rounding (rtol 1e-5), or any counter."""
    differ = (counts != ref_counts).any(dim=0).cpu().numpy()
    for a, b in zip(rec, ref):
        differ |= ~np.isclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-5,
                              atol=1e-6)
    return differ


# The condition is a string, so it is evaluated when the test runs, not
# when the module is imported.
@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card (the kernel has no CPU mode)")
def test_cuda_kernel_matches_plain_on_waves():
    width, height = 160, 120
    pack, parsed = load_scene(BLOB_BOX)
    bricks = BrickSet.from_pack(pack).to("cuda")
    cd = torch.from_numpy(camera_ray_data(Camera.from_parsed(parsed.camera),
                                          width, height)).to("cuda")
    for org, dirn, tnear in kernel_stats.capture_waves(bricks, cd, width,
                                                       height, 2, "sig_mort"):
        before = wavefront.trace_bricks_full_cuda.launches
        rec, counts = wavefront.trace_wave_full(bricks, org, dirn, tnear,
                                                collect_stats=True)
        torch.cuda.synchronize()
        assert wavefront.trace_bricks_full_cuda.launches == before + 1
        ref, ref_counts = brickkernel.trace_bricks_full_plain(
            bricks, org, dirn, tnear, collect_stats=True)
        differ = _record_differs(rec, counts, ref, ref_counts)
        assert differ.mean() <= 1e-4, f"{differ.sum()} rays differ"
        assert float(torch.isfinite(rec[0]).float().mean()) > 0.5
