"""The port's tile and sample split (parallel/sharding.py) over
``torch.distributed``: worlds of 2 and 4 ``gloo`` processes on the CPU
against the port's single-device renders, and one "xla" image against the
JAX package's ``render_samples_sharded`` on its 8-device virtual CPU mesh.

Each world starts once per module (a module-scoped fixture) and renders
every case; the tests then only compare.  Spawned ranks re-import this
module, so it imports jax only inside the test that compares with JAX.

Tolerances: "xla", "megakernel" and "bricks" render each pixel as the
single render does, and only the order of the sample sum differs, so
rtol = atol = 1e-5 (tests/test_sharding.py:39).  The wave paths ("wavefront",
"mx", "mx2") trace each tile's rays in other packets, which may change an
equal-t tie (ROADMAP C4): tests/test_wavefront.py:37-39's criterion.

The blob_box cases render 32x48: two 64x32 screen tiles, so that each of
two tile ranks owns one (at 32x24 the frame is one tile).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from pathtracer_cuda_interactive_tpu_torch import SCENES_DIR
from pathtracer_cuda_interactive_tpu_torch.experiments.mx2 import (
    render_samples_mx2)
from pathtracer_cuda_interactive_tpu_torch.experiments.mx2set import MX2Set
from pathtracer_cuda_interactive_tpu_torch.experiments.mxset import MXSet
from pathtracer_cuda_interactive_tpu_torch.experiments.mxtrace import (
    render_samples_mx)
from pathtracer_cuda_interactive_tpu_torch.models.bricks import BrickSet
from pathtracer_cuda_interactive_tpu_torch.models.device_scene import (
    DeviceScene)
from pathtracer_cuda_interactive_tpu_torch.models.scenepack import load_scene
from pathtracer_cuda_interactive_tpu_torch.ops import integrator
from pathtracer_cuda_interactive_tpu_torch.ops.brickkernel import (
    render_samples_bricks)
from pathtracer_cuda_interactive_tpu_torch.ops.camera import (
    Camera, camera_ray_data)
from pathtracer_cuda_interactive_tpu_torch.ops.megakernel import (
    render_samples_megakernel)
from pathtracer_cuda_interactive_tpu_torch.ops.wavefront import (
    render_samples_wavefront)
from pathtracer_cuda_interactive_tpu_torch.parallel import sharding as sh
from pathtracer_cuda_interactive_tpu_torch.parallel.world import run_world

SIZES = {"spheres": (32, 24), "blob_box": (32, 48)}
SPP, DEPTH = 3, 3
WRAP = 2 ** 32 - 1
SETS = {"xla": DeviceScene, "megakernel": DeviceScene, "bricks": BrickSet,
        "wavefront": BrickSet, "mx": MXSet, "mx2": MX2Set}
WAVE_MODES = ("wavefront", "mx", "mx2")

# one thread per process: the ranks and the other test workers share cores
torch.set_num_threads(1)


def _case(scene, mode, sp, spp=SPP, start=0):
    return dict(scene=scene, mode=mode, sp=sp, spp=spp, start=start)


# world of 2: each mode as pure tile split (sample_parallel 1) and pure
# sample split (2); the remainder cases; the sample-index wrap
CASES2 = {}
for _sp in (1, 2):
    for _mode in ("xla", "megakernel"):
        CASES2[f"{_mode}-sp{_sp}"] = _case("spheres", _mode, _sp)
    for _mode in ("bricks", "wavefront", "mx", "mx2"):
        CASES2[f"{_mode}-sp{_sp}"] = _case("blob_box", _mode, _sp)
for _spp in (1, 5):
    CASES2[f"xla-sp2-spp{_spp}"] = _case("spheres", "xla", 2, spp=_spp)
CASES2["xla-sp2-wrap"] = _case("spheres", "xla", 2, start=WRAP)
CASES2["wavefront-sp2-wrap"] = _case("blob_box", "wavefront", 2, start=WRAP)

# world of 4: samples 4 ways, and 2 tiles x 2 sample shards
CASES4 = {
    "xla-sp4": _case("spheres", "xla", 4),
    "xla-sp4-spp5": _case("spheres", "xla", 4, spp=5),
    "xla-sp2": _case("spheres", "xla", 2),
    "megakernel-sp2": _case("spheres", "megakernel", 2),
    "bricks-sp2": _case("blob_box", "bricks", 2),
}


def _load(scene, mode):
    """(set of tensors for ``mode``, camera data) of an in-repo scene at
    its test size, on the CPU."""
    width, height = SIZES[scene]
    pack, parsed = load_scene(str(SCENES_DIR / f"{scene}.xml"))
    cd = torch.from_numpy(camera_ray_data(Camera.from_parsed(parsed.camera),
                                          width, height))
    return SETS[mode].from_pack(pack), cd


def _world_main(rank, world_size, cases):
    """One rank: every case through render_samples_sharded, the mesh's
    coordinates, and (world of 2) a scaling report."""
    out = {"coords": {}}
    loaded = {}
    for name, c in cases.items():
        key = (c["scene"], SETS[c["mode"]])
        if key not in loaded:
            loaded[key] = _load(c["scene"], c["mode"])
        scene, cd = loaded[key]
        mesh = sh.make_mesh(sample_parallel=c["sp"], device="cpu")
        out["coords"][name] = (mesh.s_idx, mesh.t_idx)
        width, height = SIZES[c["scene"]]
        out[name] = sh.render_samples_sharded(
            sh.replicate_scene(scene, mesh), cd, width, height, c["start"],
            c["spp"], mesh, max_depth=DEPTH, mode=c["mode"])
    if world_size == 2:
        scene, cd = loaded[("spheres", DeviceScene)]
        out["scaling"] = sh.scaling_report(
            scene, cd, sh.make_mesh(device="cpu"), 32, 24, num_samples=2,
            repeats=1, max_depth=DEPTH)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' results by world size.  The two run at once, and the
    single renders are made meanwhile."""
    with ThreadPoolExecutor(2) as pool:
        futures = {n: pool.submit(run_world, _world_main, n,
                                  tmp_path_factory.mktemp(f"world{n}"),
                                  (cases,), timeout=240)
                   for n, cases in ((2, CASES2), (4, CASES4))}
        for c in (*CASES2.values(), *CASES4.values()):
            single(c)
        return {n: f.result() for n, f in futures.items()}


@pytest.fixture(scope="module")
def world2(worlds):
    return worlds[2]


@pytest.fixture(scope="module")
def world4(worlds):
    return worlds[4]


_SINGLE = {}


def single(c):
    """The port's unsharded render of case ``c`` (cached per module)."""
    key = (c["scene"], c["mode"], c["spp"], c["start"])
    if key not in _SINGLE:
        scene, cd = _load(c["scene"], c["mode"])
        width, height = SIZES[c["scene"]]
        render = {"xla": integrator.render_samples,
                  "megakernel": render_samples_megakernel,
                  "bricks": render_samples_bricks,
                  "wavefront": render_samples_wavefront,
                  "mx": render_samples_mx,
                  "mx2": render_samples_mx2}[c["mode"]]
        _SINGLE[key] = render(scene, cd, width, height, c["start"], c["spp"],
                              max_depth=DEPTH).numpy()
    return _SINGLE[key]


def assert_matches_single(results, name, c):
    imgs = [r[name].numpy() for r in results]
    for img in imgs[1:]:
        np.testing.assert_array_equal(img, imgs[0])   # every rank: all
    got, ref = imgs[0], single(c)
    assert got.shape == ref.shape
    if c["mode"] in WAVE_MODES:
        bad = ~np.isclose(got, ref, rtol=1e-4, atol=1e-4)
        assert bad.mean() < 1e-3, f"{bad.mean():%} mismatched"
        assert np.abs(ref - got).mean() < 1e-3
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert ref.mean() > 0


@pytest.mark.parametrize("name", sorted(CASES2))
def test_port_sharded_matches_single_world2(world2, name):
    assert_matches_single(world2, name, CASES2[name])


@pytest.mark.parametrize("name", sorted(CASES4))
def test_port_sharded_matches_single_world4(world4, name):
    assert_matches_single(world4, name, CASES4[name])


def test_port_rank_layout_is_jax_mesh_reshape(world4):
    """Rank r sits where device r sits in the JAX
    reshape(sample_parallel, n // sample_parallel)."""
    layout = np.arange(4).reshape(2, 2)
    for rank, res in enumerate(world4):
        s, t = res["coords"]["xla-sp2"]
        assert layout[s, t] == rank
        assert res["coords"]["xla-sp4"] == (rank, 0)


def test_port_sample_start_wraps():
    """A shard's first sample is taken modulo 2^32: the shard starting at
    2^32 - 1 + 2 renders samples 1, 2, ... (the JAX uint32)."""
    mesh = sh.Mesh(2, 1, 2, 1, torch.device("cpu"), False)
    assert sh._sample_shard(mesh, WRAP, 3) == (1, 2, 1)
    assert sh._sample_shard(mesh, 7, 3) == (9, 2, 1)
    assert sh._sample_shard(mesh, 0, 1) == (1, 1, 0)


def test_port_mesh_shape_validation():
    with pytest.raises(ValueError):
        sh.make_mesh(world_size=8, sample_parallel=3, device="cpu")
    with pytest.raises(ValueError):
        sh.make_mesh(world_size=4, sample_parallel=0, device="cpu")
    one = sh.make_mesh(device="cpu")
    assert (one.world_size, one.rank, one.shape) == \
        (1, 0, {sh.SAMPLE_AXIS: 1, sh.TILE_AXIS: 1})
    with pytest.raises(ValueError):       # no process group of 8 ranks
        sh.make_mesh(world_size=8, sample_parallel=2, device="cpu")
    layout = sh.Mesh(8, 5, 2, 4, torch.device("cpu"), False)
    assert layout.shape == {sh.SAMPLE_AXIS: 2, sh.TILE_AXIS: 4}
    assert (layout.s_idx, layout.t_idx) == (1, 1)
    with pytest.raises(RuntimeError):     # no process group to reduce over
        layout.all_reduce(torch.zeros(1))


def test_port_tile_padding_covers_image():
    pix, rows = sh._padded_grid(33, 7, 8)
    assert rows % 8 == 0
    assert pix.size >= 33 * 7
    assert pix[0, 0] == 0 and pix.flat[33 * 7 - 1] == 33 * 7 - 1
    # the wave paths' slot maps of 3 tile ranks hold every pixel once
    W, H, n = 200, 70, 3
    seen = np.concatenate([
        sh._tile_slots(W, H, sh.Mesh(n, r, 1, n, torch.device("cpu"),
                                     False)).numpy()
        for r in range(n)])
    assert seen.size % n == 0
    np.testing.assert_array_equal(np.sort(seen[seen < W * H]),
                                  np.arange(W * H))


def test_port_scaling_report_keys(world2):
    for res in world2:
        rep = res["scaling"]
        assert set(rep) == {"n_devices", "mode", "speedup", "efficiency",
                            "per_shard_overhead", "one_ms", "mesh_ms",
                            "shard_ms"}
        assert rep["speedup"] == pytest.approx(rep["one_ms"]
                                               / rep["mesh_ms"])
        assert rep["n_devices"] == 2 and rep["mode"] == "xla"
        assert rep["speedup"] > 0 and rep["per_shard_overhead"] > 0
    assert world2[0]["scaling"] == world2[1]["scaling"]


def test_port_sharded_xla_matches_jax_mesh(world2):
    """The "xla" image of a 2-rank, 2-sample-shard world against the JAX
    package's render_samples_sharded on its 8-device virtual CPU mesh at
    sample_parallel 2, S = 3 (both sum exactly 3 passes).  Torch and XLA
    round a*b+c differently, so the criterion of
    tests/test_megakernel.py:57-60."""
    import jax.numpy as jnp

    from pathtracer_cuda_interactive_tpu.models.device_scene import (
        DeviceScene as JaxDeviceScene)
    from pathtracer_cuda_interactive_tpu.models.scenepack import (
        load_scene as jax_load_scene)
    from pathtracer_cuda_interactive_tpu.ops.camera import (
        Camera as JaxCamera, camera_ray_data as jax_camera_ray_data)
    from pathtracer_cuda_interactive_tpu.parallel import sharding as jsh

    W, H = SIZES["spheres"]
    pack, parsed = jax_load_scene(str(SCENES_DIR / "spheres.xml"))
    cd = jnp.asarray(jax_camera_ray_data(
        JaxCamera.from_parsed(parsed.camera), W, H))
    mesh = jsh.make_mesh(sample_parallel=2)
    ref = np.asarray(jsh.render_samples_sharded(
        jsh.replicate_scene(JaxDeviceScene.from_pack(pack), mesh), cd, W, H,
        jnp.uint32(0), SPP, mesh, max_depth=DEPTH))
    got = world2[0]["xla-sp2"].numpy()
    bad = ~np.isclose(got, ref, rtol=1e-4, atol=1e-4)
    assert bad.sum() <= max(1e-4 * bad.size, 2), \
        f"{bad.sum()} of {bad.size} elements mismatch"
    assert np.abs(ref - got).mean() < 1e-4
