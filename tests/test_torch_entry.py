"""The port's entry points (entry.py): ``entry()``'s step against the JAX
package's ``integrator.render_samples`` on the same scene, and the dry run
in one world of 2 ``gloo`` ranks on the CPU (started once for the module),
against single-process renders.

``entry()`` renders depth 8, between the integrator tests' shallow depth 4
and deep depth 12, so its image is held to their statistical criterion
(tests/test_torch_integrator.py::assert_deep_parity).  The dry run's "xla"
and "megakernel" images are sums of the same passes as one process's
render, so their means agree to float32 rounding (rtol 1e-5).
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
from pathtracer_cuda_interactive_tpu_torch import entry as entry_mod
from pathtracer_cuda_interactive_tpu_torch.models.device_scene import (
    DeviceScene)
from pathtracer_cuda_interactive_tpu_torch.ops import integrator

torch.set_num_threads(1)

MODES = ("xla", "megakernel", "wavefront", "mx", "mx2")


@pytest.fixture(scope="module")
def dryrun():
    return entry_mod.dryrun_multichip(2, device="cpu")


def test_entry_step_matches_jax():
    fn, (scene, cd, start) = entry_mod.entry(device="cpu")
    got = fn(scene, cd, start).numpy()
    pack, parsed = jax_load_scene(str(entry_mod.CBOX))
    jcd = jnp.asarray(jax_camera_ray_data(
        JaxCamera.from_parsed(parsed.camera), 160, 120))
    ref = np.asarray(jax_integrator.render_samples(
        JaxDeviceScene.from_pack(pack), jcd, 160, 120, 0, num_samples=1,
        max_depth=8))
    assert got.shape == (120, 160, 3) and ref.mean() > 0
    d = np.abs(ref - got)
    assert (d.max(axis=-1) > 1e-3).mean() < 2e-3
    assert d.mean() < 1e-3
    assert abs(ref.mean() - got.mean()) < 1e-3


def test_dryrun_renders_every_mode(dryrun):
    assert set(dryrun["images"]) == set(MODES)
    for stats in dryrun["images"].values():
        assert np.isfinite(stats["mean"]) and stats["std"] > 0
    assert np.isfinite(dryrun["loss"]) and dryrun["loss"] > 0
    assert dryrun["device"] == "cpu"


def test_dryrun_images_equal_single_renders(dryrun):
    from pathtracer_cuda_interactive_tpu_torch.ops.megakernel import (
        render_samples_megakernel)

    W, H = entry_mod.DRY_W, entry_mod.DRY_H
    pack, cd = entry_mod._load(entry_mod.CBOX, W, H, "cpu")
    scene = DeviceScene.from_pack(pack)
    single = {
        "xla": integrator.render_samples(
            scene, cd, W, H, 0, entry_mod.DRY_SPP,
            max_depth=entry_mod.DRY_BOUNCES),
        "megakernel": render_samples_megakernel(
            scene, cd, W, H, 0, entry_mod.DRY_SPP,
            max_depth=entry_mod.DRY_BOUNCES)}
    for mode, img in single.items():
        np.testing.assert_allclose(dryrun["images"][mode]["mean"],
                                   float(img.mean()), rtol=1e-5)


def test_dryrun_scaling_reports(dryrun):
    reps = dryrun["reports"]
    assert [r["mode"] for r in reps] == list(MODES)
    for r in reps:
        assert r["n_devices"] == 2
        for key in ("speedup", "efficiency", "per_shard_overhead", "one_ms",
                    "mesh_ms", "shard_ms"):
            assert r[key] > 0, (r["mode"], key)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the card is there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry_mod.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry_mod.dryrun_multichip(2)
