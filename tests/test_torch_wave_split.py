"""The wave paths' slot map and pass count (ops/wavefront.py::render_waves
``pix_slots`` and ``num_real``), what a tile and sample split across
devices hands each device (parallel/sharding.py).

A slice of the slot map renders only its own pixels, and each pixel lies in
one slice, so two halves add up to the whole frame.  ``num_real`` renders
only the passes that count, so it equals a render of that many passes bit
for bit.  The wavefront's plain walk gives each ray its own result
whatever wave it is in, so its two halves add up to the frame bit for bit.
"""

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
from pathtracer_cuda_interactive_tpu_torch.models.scenepack import load_scene
from pathtracer_cuda_interactive_tpu_torch.ops.camera import (
    Camera, camera_ray_data)
from pathtracer_cuda_interactive_tpu_torch.ops.wavefront import (
    WAVE_ROWS, LANES, _wave_layout, render_samples_wavefront)

torch.set_num_threads(1)

DEPTH = 3
RENDERS = {"wavefront": (BrickSet, render_samples_wavefront),
           "mx": (MXSet, render_samples_mx),
           "mx2": (MX2Set, render_samples_mx2)}


def blob(width, height, set_cls):
    pack, parsed = load_scene(str(SCENES_DIR / "blob_box.xml"))
    cd = torch.from_numpy(camera_ray_data(Camera.from_parsed(parsed.camera),
                                          width, height))
    return set_cls.from_pack(pack), cd


def test_port_slot_map_halves_sum_to_the_frame():
    """32x48 is two 64x32 tiles, one block of WAVE_ROWS x 128 slots each."""
    W, H = 32, 48
    bs, cd = blob(W, H, BrickSet)
    slots = torch.from_numpy(_wave_layout(W, H)[0])
    block = WAVE_ROWS * LANES
    assert slots.numel() == 2 * block
    whole = render_samples_wavefront(bs, cd, W, H, 0, 1, max_depth=DEPTH)
    halves = [render_samples_wavefront(bs, cd, W, H, 0, 1, max_depth=DEPTH,
                                       pix_slots=slots[k * block:
                                                       (k + 1) * block])
              for k in range(2)]
    # the halves' pixels are apart, and each holds some of the image
    on = [(h != 0).any(dim=-1) for h in halves]
    assert not (on[0] & on[1]).any() and on[0].any() and on[1].any()
    assert torch.equal(halves[0] + halves[1], whole)
    # a map of padding slots alone renders nothing
    pad = torch.full((block,), W * H, dtype=torch.int32)
    assert not render_samples_wavefront(bs, cd, W, H, 0, 1, max_depth=DEPTH,
                                        pix_slots=pad).any()


@pytest.mark.parametrize("mode", sorted(RENDERS))
def test_port_num_real_renders_only_the_passes_that_count(mode):
    W, H = 32, 24
    set_cls, render = RENDERS[mode]
    scene, cd = blob(W, H, set_cls)
    ref_stats, stats = {}, {}
    ref = render(scene, cd, W, H, 5, 1, max_depth=DEPTH, stats=ref_stats)
    got = render(scene, cd, W, H, 5, 3, max_depth=DEPTH, num_real=1,
                 stats=stats)
    assert torch.equal(got, ref)
    # the passes past num_real are not rendered: the same waves and rays
    assert stats["waves"] == ref_stats["waves"]
    assert stats["rays"] == ref_stats["rays"]
    assert not render(scene, cd, W, H, 5, 3, max_depth=DEPTH,
                      num_real=0).any()
