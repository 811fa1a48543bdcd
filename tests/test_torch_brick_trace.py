"""Kernel B2's wrapper (ops/wavefront.py::trace_bricks_cuda) and build.

The CUDA kernel itself runs only on a card: the cases marked ``cuda`` skip
without one.  They hold the kernel to its plain version
(ops/brickkernel.py::trace_bricks_plain) on waves of blob_box and on whole
wavefront renders.  The kernel and the plain version walk the same per-ray
order with the same arithmetic, so slots agree except where rounding on
the card differs (at most 1e-4 of the rays).  This file imports no jax, so
on the card it runs with
``python -m pytest --noconftest -m cuda tests/test_torch_brick_trace.py``.
"""

import re

import numpy as np
import pytest
import torch

from pathtracer_cuda_interactive_tpu_torch import SCENES_DIR
from pathtracer_cuda_interactive_tpu_torch.models.bricks import (
    STACK_DEPTH, BrickSet)
from pathtracer_cuda_interactive_tpu_torch.models.scenepack import load_scene
from pathtracer_cuda_interactive_tpu_torch.ops import cuda_build, wavefront
from pathtracer_cuda_interactive_tpu_torch.ops.brickkernel import (
    trace_bricks_plain)
from pathtracer_cuda_interactive_tpu_torch.ops.camera import (
    Camera, camera_ray_data)

BLOB_BOX = str(SCENES_DIR / "blob_box.xml")


def _load(width, height, device="cpu"):
    pack, parsed = load_scene(BLOB_BOX)
    cd = camera_ray_data(Camera.from_parsed(parsed.camera), width, height)
    return (BrickSet.from_pack(pack).to(device),
            torch.from_numpy(cd).to(device))


def capture_waves(bricks, cd, width, height, n_waves):
    """The first ``n_waves`` waves of a plain-traced wavefront render, as
    (org, dirn, tnear): the primary wave, then sorted bounce waves."""
    waves = []

    def recording(b, org, dirn, tnear):
        waves.append((org, dirn, tnear))
        return trace_bricks_plain(b, org, dirn, tnear)

    wavefront.render_samples_wavefront(bricks, cd, width, height, 0, 1,
                                       max_depth=n_waves, tracer=recording)
    return waves[:n_waves]


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(wavefront, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        wavefront.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build_all([wavefront.SOURCE], tmp_path / "_build")
    assert not (tmp_path / "_build").exists() or \
        not any((tmp_path / "_build").iterdir())


def test_library_name_follows_the_source(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// a\n")
    first = cuda_build.library_path(src, tmp_path)
    src.write_text("// b\n")
    assert cuda_build.library_path(src, tmp_path) != first
    assert first.name.startswith("k_") and first.suffix == ".so"


def test_library_name_follows_the_headers(tmp_path):
    """A source includes the shared csrc/*.cuh headers, so an edit to any of
    them must build a new library, not load a stale one."""
    src = tmp_path / "k.cu"
    src.write_text('#include "walk.cuh"\n')
    header = tmp_path / "walk.cuh"
    header.write_text("// a\n")
    first = cuda_build.library_path(src, tmp_path)
    header.write_text("// b\n")
    second = cuda_build.library_path(src, tmp_path)
    assert second != first
    (tmp_path / "other.cuh").write_text("// c\n")
    assert cuda_build.library_path(src, tmp_path) != second
    # the package's own sources depend on their headers
    lib = cuda_build.library_path(wavefront.SOURCE, tmp_path)
    assert lib == cuda_build.library_path(wavefront.SOURCE, tmp_path)
    assert lib.name.startswith("brick_trace_")


def test_kernel_stack_is_the_builders_bound():
    # the walk of kernels B2, B3 and B6 lives in the shared header
    src = (cuda_build.CSRC_DIR / "brick_walk.cuh").read_text()
    assert re.search(r"constexpr int kStack = (\d+);", src).group(1) == \
        str(STACK_DEPTH)
    bricks, _ = _load(8, 8)
    o = torch.zeros(4)
    bricks.top_depth = STACK_DEPTH - 1
    with pytest.raises(ValueError, match="too deep"):
        wavefront.trace_bricks_cuda(bricks, o, o, o, o, o, o, 0.0)


def test_captured_waves_are_primary_then_sorted():
    bricks, cd = _load(32, 24)
    waves = capture_waves(bricks, cd, 32, 24, 2)
    assert [w[2] for w in waves] == [0.0, 1e-4]
    assert waves[0][0].x.numel() == 32 * 24
    assert 0 < waves[1][0].x.numel() <= 32 * 24


def _assert_kernel_matches(bricks, org, dirn, tnear):
    before = wavefront.trace_bricks_cuda.launches
    t, slot = wavefront.trace_wave_slim(bricks, org, dirn, tnear)
    torch.cuda.synchronize()
    assert wavefront.trace_bricks_cuda.launches == before + 1
    ref_t, ref_slot = trace_bricks_plain(bricks, org, dirn, tnear)
    t, slot = t.cpu().numpy(), slot.cpu().numpy()
    ref_t, ref_slot = ref_t.cpu().numpy(), ref_slot.cpu().numpy()
    differ = (slot != ref_slot) | ~np.isclose(t, ref_t, rtol=1e-5, atol=0.0)
    assert differ.mean() <= 1e-4, f"{differ.sum()} of {len(t)} rays differ"
    assert (slot >= 0).mean() > 0.5


# The condition is a string, so it is evaluated when the test runs, not
# when the module is imported.
@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card (the kernel has no CPU mode)")
def test_cuda_kernel_matches_plain_on_waves():
    bricks, cd = _load(160, 120, "cuda")
    for org, dirn, tnear in capture_waves(bricks, cd, 160, 120, 3):
        _assert_kernel_matches(bricks, org, dirn, tnear)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card (the kernel has no CPU mode)")
@pytest.mark.parametrize("nee", [False, True])
def test_cuda_wavefront_render_matches_plain(nee):
    width, height = 64, 48
    bricks, cd = _load(width, height, "cuda")
    stats = {}
    before = wavefront.trace_bricks_cuda.launches
    got = wavefront.render_samples_wavefront(bricks, cd, width, height, 0, 2,
                                             max_depth=4, nee=nee,
                                             stats=stats)
    torch.cuda.synchronize()
    assert wavefront.trace_bricks_cuda.launches == before + stats["waves"]
    ref = wavefront.render_samples_wavefront(bricks, cd, width, height, 0, 2,
                                             max_depth=4, nee=nee,
                                             tracer=trace_bricks_plain)
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    bad = ~np.isclose(got, ref, rtol=1e-4, atol=1e-4)
    assert bad.mean() < 1e-3 and np.abs(got - ref).mean() < 1e-3
    assert ref.mean() > 0.0
