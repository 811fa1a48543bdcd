"""The wavefront's bounce step (ops/wave_step.py): the ray table, the sort
keys with the dead-ray sentinel, the one-gather sort and compaction, and
kernels W1-W3 (csrc/wave_step.cu) against their plain versions.

On the CPU: the keys equal the JAX package's ``_sort_key`` / ``_sig_key``
under an ``active`` mask bit for bit; one stable sort and one gather leave
the same live table as a compaction by ``torch.nonzero`` followed by the
sort of the live rays, bit for bit; the loop matches the JAX package's
``render_samples_wavefront`` with ``sort_mode="mort_oct"``, NEE off and
on, at the criterion of tests/test_wavefront.py:37-39 (the other sort
modes are in tests/test_torch_wavefront_render.py); the dispatchers take
the plain versions on CPU tensors and launch nothing.

The cases marked ``cuda`` skip without a card and import no jax, so on the
card this file runs with ``python -m pytest --noconftest -m cuda
tests/test_torch_wave_step.py``: W1, W3 and W2's first half bit for bit
their plain versions on the waves of a render, W2's states, pixels,
samples and live flags bit for bit and its floats within rtol 1e-4 on all
but 1e-4 of the rays (the ulps of ``cosf``, ``sinf`` and ``powf``), and no
op of a plain version on the card's path.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pathtracer_cuda_interactive_tpu_torch import SCENES_DIR
from pathtracer_cuda_interactive_tpu_torch.models.bricks import BrickSet
from pathtracer_cuda_interactive_tpu_torch.models.scenepack import load_scene
from pathtracer_cuda_interactive_tpu_torch.ops import (
    cuda_build, wave_step, wavefront)
from pathtracer_cuda_interactive_tpu_torch.ops.camera import (
    Camera, camera_ray_data)
from pathtracer_cuda_interactive_tpu_torch.ops.vec import Vec3

# several test workers at once: one intra-op thread per process
torch.set_num_threads(1)

W, H = 32, 24
BLOB_BOX = str(SCENES_DIR / "blob_box.xml")
KERNELS = (wave_step.wave_record_cuda, wave_step.wave_shadow_rays_cuda,
           wave_step.wave_shade_cuda, wave_step.wave_sort_key_cuda)


def _load(width, height, device="cpu"):
    pack, parsed = load_scene(BLOB_BOX)
    cd = camera_ray_data(Camera.from_parsed(parsed.camera), width, height)
    return (BrickSet.from_pack(pack).to(device),
            torch.from_numpy(cd).to(device))


@pytest.fixture(scope="module")
def bricks():
    return _load(W, H)[0]


def _box(bricks):
    root = bricks.top_boxes[0, :6]
    lo = root[:3].contiguous()
    return lo, 1.0 / torch.clamp_min(root[3:] - lo, 1e-12)


def _random_table(n=2048, seed=0, live_share=0.6):
    """A ray table of rays from inside the box toward the blob (the first
    64 straight down from the ceiling plane: 0 * inf = NaN in the slab
    tests), random states, pixels and samples, and about ``live_share`` of
    them live."""
    rs = np.random.default_rng(seed)
    o = rs.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 1.5], (n, 3))
    tgt = rs.uniform([-0.7, 0.1, -0.7], [0.2, 1.1, 0.35], (n, 3))
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:64] = [0.0, -1.0, 0.0]
    o[:64, 1] = 2.0
    col = lambda a: Vec3(*(torch.from_numpy(np.ascontiguousarray(c))
                           for c in a.astype(np.float32).T))
    ints = lambda hi: torch.from_numpy(rs.integers(-2 ** 31 if hi is None
                                                   else 0, hi or 2 ** 31,
                                                   n).astype(np.int32))
    table = wave_step.make_table(col(o), col(d), ints(None), ints(4096),
                                 ints(4))
    table[wave_step.THROUGHPUT:wave_step.RADIANCE + 3] = torch.from_numpy(
        rs.uniform(0.0, 2.0, (6, n)).astype(np.float32))
    table[wave_step.LIVE] = torch.from_numpy(
        (rs.uniform(size=n) < live_share).astype(np.float32))
    return table


def _bits(t):
    return t.view(torch.int32)


def test_table_layout():
    table = _random_table(256)
    assert table.shape == (16, 256) and table.dtype == torch.float32
    state, pix, samp = wave_step.int_rows(table)
    assert state.dtype == torch.int32 and bool((pix < 4096).all())
    assert bool((samp >= 0).all()) and bool((samp < 4).all())
    org = wave_step.rows3(table, wave_step.ORG)
    assert all(c.is_contiguous() and c.shape == (256,) for c in org)
    # one gather moves every column, the int rows' bits included
    perm = torch.randperm(256)
    moved = table.index_select(1, perm)
    assert torch.equal(_bits(moved), _bits(table)[:, perm])


@pytest.mark.parametrize("mode", ["sig_mort", "mort_oct"])
def test_keys_with_the_dead_sentinel_match_jax(bricks, mode):
    import jax.numpy as jnp

    from pathtracer_cuda_interactive_tpu.ops import wavefront as jax_wf
    from pathtracer_cuda_interactive_tpu.ops.vec import Vec3 as JaxVec3
    table = _random_table(seed=1)
    lo, inv = _box(bricks)
    got = wave_step.sort_key_plain(table, mode, lo, inv, bricks.coarse_boxes)
    jv = lambda row: JaxVec3(*(jnp.asarray(table[row + k].numpy()
                                           .reshape(16, 128))
                               for k in range(3)))
    active = jnp.asarray((table[wave_step.LIVE] > 0).numpy().reshape(16, 128))
    args = (jv(wave_step.ORG), jv(wave_step.DIR), active,
            jnp.asarray(lo.numpy()), jnp.asarray(inv.numpy()))
    if mode == "sig_mort":
        ref = jax_wf._sig_key(*args, jnp.asarray(bricks.coarse_boxes.numpy()))
    else:
        ref = jax_wf._sort_key(*args)
    ref = np.asarray(ref).reshape(-1)
    np.testing.assert_array_equal(got.numpy(), ref)
    dead = (table[wave_step.LIVE] == 0).numpy()
    assert dead.any() and (ref[dead] == wave_step.INT32_MAX).all()
    assert len(np.unique(ref[~dead])) > 16


def test_none_key_keeps_the_live_order():
    table = _random_table(seed=2)
    key = wave_step.sort_key_plain(table, "none", None, None)
    live = table[wave_step.LIVE] > 0
    assert bool((key[live] == 0).all())
    assert bool((key[~live] == wave_step.INT32_MAX).all())


@pytest.mark.parametrize("mode", ["sig_mort", "mort_oct", "none"])
def test_one_gather_sort_equals_the_nonzero_compaction(bricks, mode):
    """What the loop does between two waves, against what it did before: a
    compaction by ``torch.nonzero`` and 15 gathers, then a stable sort of
    the live rays by their key (none for "none") and 15 more gathers."""
    table = _random_table(seed=3)
    lo, inv = _box(bricks)
    n = int(torch.count_nonzero(table[wave_step.LIVE]))
    key = wave_step.sort_key_plain(table, mode, lo, inv, bricks.coarse_boxes)
    perm = torch.sort(key, stable=True).indices[:n]
    got = table.index_select(1, perm)

    live = torch.nonzero(table[wave_step.LIVE] > 0).reshape(-1)
    cols = [table[r][live] for r in range(16)]
    if mode != "none":
        org, dirn = Vec3(*cols[0:3]), Vec3(*cols[3:6])
        if mode == "sig_mort":
            k = wave_step._sig_key(org, dirn, lo, inv, bricks.coarse_boxes)
        else:
            k = wave_step._sort_key(org, dirn, lo, inv)
        order = torch.sort(k, stable=True).indices
        cols = [c[order] for c in cols]
    want = torch.stack(cols)
    assert got.shape == (16, n) and n > 1000
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("nee", [False, True])
def test_wavefront_mort_oct_matches_jax(nee):
    """The loop on the ray table against the JAX wavefront with its Pallas
    trace in interpret mode, sorted by "mort_oct"; 32x24, 1 spp, depth 3."""
    import jax.numpy as jnp

    from pathtracer_cuda_interactive_tpu.models import native as jax_native
    from pathtracer_cuda_interactive_tpu.models.bricks import (
        BrickSet as JaxBrickSet)
    from pathtracer_cuda_interactive_tpu.models.scenepack import (
        load_scene as jax_load_scene)
    from pathtracer_cuda_interactive_tpu.ops import wavefront as jax_wf
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
    ref = np.asarray(jax_wf.render_samples_wavefront(
        jbricks, jcd, W, H, 0, 1, max_depth=3, interpret=True, nee=nee,
        sort_mode="mort_oct"))
    stats = {}
    got = wavefront.render_samples_wavefront(
        port, cd, W, H, 0, 1, max_depth=3, nee=nee, sort_mode="mort_oct",
        stats=stats).numpy()
    assert ref.mean() > 0.0
    bad = ~np.isclose(got, ref, rtol=1e-4, atol=1e-4)
    assert bad.mean() < 1e-3, f"{bad.mean():%} mismatched"
    assert np.abs(ref - got).mean() < 1e-3
    assert stats["waves"] == (6 if nee else 3)


def test_plain_steps_are_the_cpu_path(bricks):
    """On CPU tensors every dispatcher runs its plain version and no kernel
    is launched; ``PLAIN_STEPS`` renders the same image bit for bit; the
    kernels' wrappers refuse CPU tensors."""
    cd = _load(W, H)[1]
    before = [k.launches for k in KERNELS]
    log = []
    kw = dict(max_depth=4, nee=True)
    got = wavefront.render_samples_wavefront(
        bricks, cd, W, H, 0, 1, steps=wave_step.recording_steps(log), **kw)
    ref = wavefront.render_samples_wavefront(
        bricks, cd, W, H, 0, 1, steps=wave_step.PLAIN_STEPS, **kw)
    assert torch.equal(got, ref) and float(ref.mean()) > 0.0
    assert [k.launches for k in KERNELS] == before == [0, 0, 0, 0]
    names = [name for name, _ in log]
    assert names[:3] == ["record", "shadow_rays", "shade"]
    assert names.count("record") == names.count("shade") == 4
    assert names.count("key") == 3 and names.count("shadow_rays") == 4
    name, args = log[names.index("key")]
    with pytest.raises(ValueError, match="CUDA"):
        wave_step.wave_sort_key_cuda(*args)
    name, args = log[names.index("record")]
    with pytest.raises(ValueError, match="CUDA"):
        wave_step.wave_record_cuda(*args)
    with pytest.raises(ValueError, match="bricks on"):
        wave_step.wave_record(bricks.to("meta"), *args[1:])


def test_shade_writes_each_ended_ray_once(bricks):
    """W2's plain version on a recorded bounce wave: the new table keeps the
    pixels and samples, the rays that ended hold their radiance at their
    (sample, pixel) of ``out`` and nowhere else, and the live rays moved to
    their hit points."""
    cd = _load(W, H)[1]
    log = []
    wavefront.render_samples_wavefront(
        bricks, cd, W, H, 0, 2, max_depth=6,
        steps=wave_step.recording_steps(log, wave_step.PLAIN_STEPS))
    shades = [args for name, args in log if name == "shade"]
    table, rec, depth = shades[1][:3]
    out = shades[1][6].clone()
    new = wave_step.shade_plain(table, rec, *shades[1][2:6], out,
                                *shades[1][7:])
    assert torch.equal(_bits(wave_step.int_rows(new)[1:]),
                       _bits(wave_step.int_rows(table)[1:]))
    live = new[wave_step.LIVE] > 0
    assert 0 < int(live.sum()) < int(live.numel())
    _, pix, samp = wave_step.int_rows(new)
    written = out[samp.long(), pix.long()]
    L = new[wave_step.RADIANCE:wave_step.RADIANCE + 3].T
    assert torch.equal(written[~live], L[~live])
    assert int((out != shades[1][6]).any(dim=2).sum()) <= int((~live).sum())
    hit_pos = rec[4:7].T
    assert torch.equal(new[wave_step.ORG:wave_step.ORG + 3].T[live],
                       hit_pos[live])


@pytest.mark.parametrize("compact_tail,sort_mode,tail_waves",
                         [(8, "sig_mort", 3), (1, "mort_oct", 3),
                          (0, "sig_mort", 0), (8, "none", 0)])
def test_tail_trace_runs_from_depth_two(bricks, monkeypatch, compact_tail,
                                        sort_mode, tail_waves):
    """With the ladder on (``compact_tail > 0`` and a sort), every wave from
    depth 2 on traces with ``tail_trace``; the image is the same, since B4's
    plain version gives B2's hits bit for bit."""
    calls = []
    slim2 = wavefront.trace_wave_slim2

    def counting(*args):
        calls.append(int(args[1].x.numel()))
        return slim2(*args)

    monkeypatch.setattr(wavefront, "trace_wave_slim2", counting)
    cd = _load(W, H)[1]
    kw = dict(max_depth=5, sort_mode=sort_mode)
    ref = wavefront.render_samples_wavefront(bricks, cd, W, H, 0, 1, **kw)
    stats = {}
    got = wavefront.render_samples_wavefront(
        bricks, cd, W, H, 0, 1, compact_tail=compact_tail,
        tail_trace="slim2", stats=stats, **kw)
    assert torch.equal(got, ref)
    assert len(calls) == tail_waves and stats["waves"] == 5


def test_ladder_knobs_are_checked_and_reach_the_renderer(bricks):
    from pathtracer_cuda_interactive_tpu_torch.render.renderer import (
        ProgressiveRenderer)
    from pathtracer_cuda_interactive_tpu_torch.utils.config import (
        RenderConfig)
    cd = _load(W, H)[1]
    with pytest.raises(ValueError, match="unknown wavefront trace engine"):
        wavefront.render_samples_wavefront(bricks, cd, W, H, 0, 1,
                                           tail_trace="bvh")
    with pytest.raises(ValueError, match="compact_tail"):
        wavefront.render_samples_wavefront(bricks, cd, W, H, 0, 1,
                                           compact_tail=-1)
    with pytest.raises(ValueError, match="positive integer"):
        ProgressiveRenderer.from_xml(
            BLOB_BOX, RenderConfig(wavefront_tail_trace="pairs0"), width=W,
            height=H, device="cpu")
    renders = []
    for config in (RenderConfig(max_depth=4),
                   RenderConfig(max_depth=4, wavefront_tail_trace="slim2",
                                wavefront_compact_tail=2)):
        r = ProgressiveRenderer.from_xml(BLOB_BOX, config, width=W, height=H,
                                         device="cpu")
        r.step()
        renders.append(r.accum)
    assert torch.equal(*renders) and float(renders[0].mean()) > 0.0


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(wave_step, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(wave_step, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        wave_step.load_library()
    lib = cuda_build.library_path(wave_step.SOURCE, tmp_path)
    assert lib.name.startswith("wave_step_")


# -- on the card --------------------------------------------------------------

def _shade_check(new, out, ref_new, ref_out) -> float:
    """W2's contract: states, pixels, samples and live flags bit for bit on
    every ray; returns the share of rays whose floats (the table's 12 float
    rows, and ``out`` where a ray ended) are not within rtol 1e-4."""
    assert torch.equal(_bits(new[12:]), _bits(ref_new[12:]))
    close = torch.isclose(new[:12], ref_new[:12], rtol=1e-4,
                          atol=1e-6).all(0)
    _, pix, samp = wave_step.int_rows(new)
    close &= torch.isclose(out[samp.long(), pix.long()],
                           ref_out[samp.long(), pix.long()], rtol=1e-4,
                           atol=1e-6).all(1)
    return float((~close).float().mean())


# The condition is a string, so it is evaluated when the test runs, not
# when the module is imported.
@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card (the kernels have no CPU mode)")
@pytest.mark.parametrize("mode", ["sig_mort", "mort_oct", "none"])
def test_cuda_kernels_equal_plain_on_a_render_s_waves(mode):
    bricks, cd = _load(160, 120, "cuda")
    log = []
    wavefront.render_samples_wavefront(
        bricks, cd, 160, 120, 0, 2, max_depth=8, nee=True, sort_mode=mode,
        steps=wave_step.recording_steps(log))
    torch.cuda.synchronize()
    assert [name for name, _ in log].count("key") >= 2
    for name, args in log:
        if name == "shade":
            out, ref_out = args[6].clone(), args[6].clone()
            new = wave_step.wave_shade_cuda(*args[:6], out, *args[7:])
            ref_new = wave_step.shade_plain(*args[:6], ref_out, *args[7:])
            assert _shade_check(new, out, ref_new, ref_out) <= 1e-4
            continue
        got = getattr(wave_step.STEPS, name)(*args)
        want = getattr(wave_step.PLAIN_STEPS, name)(*args)
        torch.cuda.synchronize()
        if name == "key":
            assert torch.equal(got, want)
        else:
            assert torch.equal(_bits(got), _bits(want)), name


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card (the kernels have no CPU mode)")
@pytest.mark.parametrize("nee", [False, True])
def test_cuda_path_runs_no_plain_op(monkeypatch, nee):
    """Every plain version raises while the card renders: the path runs
    W1-W3 on every wave and none of their torch ops; and it agrees with
    the same render through the plain versions."""
    bricks, cd = _load(160, 120, "cuda")
    ref = wavefront.render_samples_wavefront(
        bricks, cd, 160, 120, 0, 2, max_depth=4, nee=nee,
        steps=wave_step.PLAIN_STEPS)

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card's path")

    for name in ("_record_from_slots", "_shade", "_nee_term", "_sig_key",
                 "_sort_key", "_sphere_tmin", "_light_dir", "record_plain",
                 "shade_plain", "sort_key_plain", "shadow_rays_plain"):
        monkeypatch.setattr(wave_step, name, refuse)
    for k in KERNELS:
        monkeypatch.setattr(k, "launches", 0)
    stats = {}
    got = wavefront.render_samples_wavefront(
        bricks, cd, 160, 120, 0, 2, max_depth=4, nee=nee, stats=stats)
    torch.cuda.synchronize()
    closest = stats["waves"] // 2 if nee else stats["waves"]
    assert wave_step.wave_record_cuda.launches == closest
    assert wave_step.wave_shade_cuda.launches == closest
    assert wave_step.wave_sort_key_cuda.launches == closest - 1
    assert wave_step.wave_shadow_rays_cuda.launches == (closest if nee
                                                        else 0)
    bad = ~torch.isclose(got, ref, rtol=1e-4, atol=1e-4)
    assert float(bad.float().mean()) < 1e-3
    assert float((got - ref).abs().mean()) < 1e-3
