"""The port's sorted wavefront (ops/wavefront.py) against the JAX package's,
on the CPU, where the port traces each wave with the plain version of
kernel B2 and the JAX package runs its Pallas kernel in interpret mode.

Both run the same RNG streams and the same bounce logic; they differ only
where a ray meets a shared triangle edge (the JAX walk is per packet and
XLA fuses multiply-adds), so renders meet the criterion of
tests/test_wavefront.py:37-39: fewer than 1e-3 of the elements outside
rtol = atol = 1e-4 and a mean absolute error below 1e-3.  Deeper, the
wavefront and the port's plain integrator agree statistically.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pathtracer_cuda_interactive_tpu.models import native as jax_native
from pathtracer_cuda_interactive_tpu.models.bricks import (
    BrickSet as JaxBrickSet)
from pathtracer_cuda_interactive_tpu.models.scenepack import (
    load_scene as jax_load_scene)
from pathtracer_cuda_interactive_tpu.ops import wavefront as jax_wavefront
from pathtracer_cuda_interactive_tpu.ops.camera import (
    Camera as JaxCamera, camera_ray_data as jax_camera_ray_data)
from pathtracer_cuda_interactive_tpu_torch import SCENES_DIR
from pathtracer_cuda_interactive_tpu_torch.models.bricks import BrickSet
from pathtracer_cuda_interactive_tpu_torch.models.device_scene import (
    DeviceScene)
from pathtracer_cuda_interactive_tpu_torch.models.scenepack import load_scene
from pathtracer_cuda_interactive_tpu_torch.ops import integrator, wavefront
from pathtracer_cuda_interactive_tpu_torch.ops.camera import (
    Camera, camera_ray_data)

# The suite runs in several worker processes at once and these tensors are
# small: one intra-op thread per process keeps the workers from spinning
# against each other for the machine's cores.
torch.set_num_threads(1)

W, H = 32, 24
BLOB_BOX = str(SCENES_DIR / "blob_box.xml")


@pytest.fixture(scope="module")
def blob():
    """(JAX BrickSet, JAX camera data, port BrickSet, port DeviceScene,
    port camera data) of blob_box; the port's BrickSet is built from the
    JAX fields."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "build_sah_treelets_native",
                   lambda *args: None)
        jpack, jparsed = jax_load_scene(BLOB_BOX)
        jbricks = JaxBrickSet.from_pack(jpack)
    jcd = jnp.asarray(jax_camera_ray_data(
        JaxCamera.from_parsed(jparsed.camera), W, H))
    pack, parsed = load_scene(BLOB_BOX)
    cd = torch.from_numpy(camera_ray_data(Camera.from_parsed(parsed.camera),
                                          W, H))
    fields = {f.name: (getattr(jbricks, f.name)
                       if isinstance(getattr(jbricks, f.name), int)
                       else np.asarray(getattr(jbricks, f.name)))
              for f in dataclasses.fields(JaxBrickSet)}
    return (jbricks, jcd, BrickSet.from_numpy(**fields),
            DeviceScene.from_pack(pack), cd)


def assert_wavefront_parity(got, ref):
    """tests/test_wavefront.py:37-39."""
    bad = ~np.isclose(got, ref, rtol=1e-4, atol=1e-4)
    assert bad.mean() < 1e-3, f"{bad.mean():%} mismatched"
    assert np.abs(ref - got).mean() < 1e-3


@pytest.mark.parametrize("sort_mode", ["sig_mort", "none"])
@pytest.mark.parametrize("nee", [False, True])
def test_wavefront_matches_jax(blob, sort_mode, nee):
    jbricks, jcd, bricks, _, cd = blob
    ref = np.asarray(jax_wavefront.render_samples_wavefront(
        jbricks, jcd, W, H, 0, 1, max_depth=3, interpret=True,
        sort_mode=sort_mode, nee=nee))
    stats = {}
    got = wavefront.render_samples_wavefront(
        bricks, cd, W, H, 0, 1, max_depth=3, sort_mode=sort_mode, nee=nee,
        stats=stats)
    assert got.shape == (H, W, 3) and got.dtype == torch.float32
    assert ref.mean() > 0.0
    assert_wavefront_parity(got.numpy(), ref)
    # three waves (one per depth), plus one shadow wave per wave with NEE
    assert stats["waves"] == (6 if nee else 3)
    assert W * H <= stats["rays"] <= 3 * W * H * (2 if nee else 1)


def test_tail_trace_matches_jax(blob):
    """The compaction ladder's knobs: "slim" for the first two waves and
    "slim2" (kernel B4's plain version) from depth 2 on, against the JAX
    ladder with the same engines in interpret mode; 32x24, depth 4."""
    jbricks, jcd, bricks, _, cd = blob
    ref = np.asarray(jax_wavefront.render_samples_wavefront(
        jbricks, jcd, W, H, 0, 1, max_depth=4, interpret=True, trace="slim",
        tail_trace="slim2"))
    stats = {}
    got = wavefront.render_samples_wavefront(
        bricks, cd, W, H, 0, 1, max_depth=4, trace="slim", tail_trace="slim2",
        stats=stats)
    assert ref.mean() > 0.0
    assert_wavefront_parity(got.numpy(), ref)
    assert stats["waves"] == 4


def test_wavefront_matches_the_plain_integrator(blob):
    """The port's two large-scene renderers agree with each other deeper
    down, statistically (tests/test_megakernel.py:74-77)."""
    _, _, bricks, scene, cd = blob
    got = wavefront.render_samples_wavefront(bricks, cd, W, H, 3, 2,
                                             max_depth=6).numpy()
    ref = integrator.render_samples(scene, cd, W, H, 3, 2,
                                    max_depth=6).numpy()
    d = np.abs(ref - got).max(axis=-1)
    assert (d > 1e-3).mean() < 2e-3
    assert abs(ref.mean() - got.mean()) < 1e-3
