"""Progressive renderer: accumulation + camera-reset controller.

The port of ``pathtracer_cuda_interactive_tpu/render/renderer.py``, the
equivalent of the reference's frame loop state machine (main.cu:272-344,
C26/C27 in SURVEY.md): keep a running radiance sum in a device buffer, add
``samples_per_frame`` fresh samples per step, divide by the count for
display, and zero everything when the camera (or the spf setting) changes —
camera compare with epsilon 1e-5 (main.cu:297-312).

``_render_mode`` picks one of six compute paths, as the JAX package's
does: the megakernel (ops/megakernel.py) for scenes of at most
``MEGAKERNEL_MAX_PRIMS`` primitives; for larger scenes with triangles the
sorted wavefront (ops/wavefront.py; kernel B2, or B4 or B5 by
``config.wavefront_trace``) or, by ``config.large_scene_mode``, the
persistent brick render ("bricks": ops/brickkernel.py, kernel B6) or one of
the Plucker-matmul paths ("mx": experiments/mxtrace.py, library products;
"mx2": experiments/mx2.py, kernel B7); and the plain integrator
(ops/integrator.py, the JAX package's "xla" mode) for the rest, which are
large sphere-only scenes.  On a card the paths with a kernel launch it; on
the CPU they run the kernels' plain versions.  The JAX
package's executable cache (utils/aotcache.py) has no counterpart: it
worked around a TPU-backend recompile, and the kernels here are built once
per source hash into the package's _build/ directory.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..experiments.mx2 import render_samples_mx2
from ..experiments.mx2set import MX2Set
from ..experiments.mxset import MXSet
from ..experiments.mxtrace import render_samples_mx
from ..models.bricks import BrickSet
from ..models.device_scene import DeviceScene
from ..models.scenepack import load_scene
from ..ops import integrator
from ..ops.brickkernel import render_samples_bricks
from ..ops.camera import Camera, camera_ray_data
from ..ops.megakernel import MEGAKERNEL_MAX_PRIMS, render_samples_megakernel
from ..ops.wavefront import (WaveCache, render_samples_wavefront,
                             trace_kernels)
from ..utils import image as img_util
from ..utils.config import RenderConfig
from ..utils.trace import setup_span, span


# the large-scene paths and the set of tensors each one renders
_LARGE_SETS = {"wavefront": BrickSet, "bricks": BrickSet, "mx": MXSet,
               "mx2": MX2Set}


def _render_mode(scene, large_scene_mode: str = "wavefront") -> str:
    """The compute path for a scene: a ScenePack, a prebuilt DeviceScene
    (the megakernel's or the plain integrator's tensors: "megakernel" at up
    to MEGAKERNEL_MAX_PRIMS primitives, "plain" above, as the JAX package
    sends one to "xla" there), or a prebuilt BrickSet, MXSet or MX2Set,
    which pins the large-scene path:
      * "megakernel" — at most MEGAKERNEL_MAX_PRIMS primitives;
      * "wavefront"  — larger scenes with triangles and at most
                       MEGAKERNEL_MAX_PRIMS spheres, the sorted wavefront;
      * "bricks"     — the same scenes with ``large_scene_mode="bricks"``,
                       the persistent brick render;
      * "mx", "mx2"  — the same scenes with that ``large_scene_mode``, or a
                       prebuilt MXSet / MX2Set whatever the mode: the
                       Plucker-matmul paths (experiments/);
      * "plain"      — the rest (large sphere-only scenes): the plain
                       integrator with the BVH walk, the JAX package's "xla".
    A prebuilt BrickSet takes "bricks" or, for every other mode, the
    wavefront, as in the JAX package."""
    if large_scene_mode not in _LARGE_SETS:
        raise ValueError(f"unknown large_scene_mode {large_scene_mode!r}")
    if isinstance(scene, MX2Set):
        return "mx2"
    if isinstance(scene, MXSet):
        return "mx"
    if isinstance(scene, BrickSet):
        return "bricks" if large_scene_mode == "bricks" else "wavefront"
    if isinstance(scene, DeviceScene):
        return ("megakernel" if scene.num_prims <= MEGAKERNEL_MAX_PRIMS
                else "plain")
    if (scene.num_prims > MEGAKERNEL_MAX_PRIMS and scene.num_triangles > 0
            and scene.num_spheres <= MEGAKERNEL_MAX_PRIMS):
        return large_scene_mode
    if scene.num_prims <= MEGAKERNEL_MAX_PRIMS:
        return "megakernel"
    return "plain"


class ProgressiveRenderer:
    """Host-side controller.  Owns the device scene, current camera, the
    accumulation buffer and the sample count.

    ``accum`` is a [H, W, 3] float32 tensor on ``device``, updated in place
    (``accum += new``) each step — the analog of the reference's persistent
    ``accumulationBuffer`` (main.cu:213-218).  ``scene`` is a ScenePack or
    a prebuilt DeviceScene, BrickSet, MXSet or MX2Set; ``mode`` is the
    compute path (``_render_mode``; "bricks" with ``enable_nee`` takes
    "wavefront").
    ``stats`` holds what the wavefront, "mx" and "mx2" paths have counted so
    far: the waves traced ("waves", also ``waves``) and their rays ("rays"),
    and on "mx" the rounds run ("rounds") and the packet-and-brick products
    made ("products")."""

    def __init__(self, scene, camera: Camera, width: int,
                 height: int, config: RenderConfig = RenderConfig(),
                 device="cuda"):
        self.mode = _render_mode(scene, config.large_scene_mode)
        if config.enable_nee and self.mode == "bricks":
            # the persistent brick render has no NEE hook; the sorted
            # wavefront (same BrickSet) has
            self.mode = "wavefront"
        walks = self.mode == "bricks" or (
            # raises on a bad engine name
            self.mode == "wavefront" and "B2" in trace_kernels(
                config.wavefront_trace, config.wavefront_tail_trace))
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            # never fall back to another device
            raise RuntimeError(f"device {self.device} requested but CUDA "
                               "is not available")
        if isinstance(scene, (DeviceScene, BrickSet, MXSet, MX2Set)):
            host = scene
        elif self.mode in _LARGE_SETS:
            host = _LARGE_SETS[self.mode].from_pack(scene)
        else:
            host = DeviceScene.from_pack(scene)
        self.stats = {}
        self.camera = camera
        self.initial_camera = camera
        self.width = width
        self.height = height
        self.config = config
        self.samples_per_frame = config.samples_per_frame
        with setup_span("setup.upload"):
            self.scene = host.to(self.device)
            self._cam_data = self._upload_camera(camera)
            self.accum = torch.zeros((height, width, 3), dtype=torch.float32,
                                     device=self.device)
        if walks and self.device.type == "cuda":
            # kernels B2 and B6 read the set's walk table: build it now,
            # as set-up, not inside the first frame
            self.scene.walk_table()
        self.sample_count = 0
        self.frame_ms = 0.0
        # the wave loop's chunks kept from frame to frame (slot map, ray
        # tables, captured graphs), rebuilt when their key changes
        self._wave_cache = WaveCache()

    @classmethod
    def from_xml(cls, xml_path: str,
                 config: RenderConfig = RenderConfig(),
                 width: Optional[int] = None,
                 height: Optional[int] = None,
                 device="cuda") -> "ProgressiveRenderer":
        pack, parsed = load_scene(xml_path)
        cam = Camera.from_parsed(parsed.camera)
        return cls(pack, cam, width or parsed.camera.width,
                   height or parsed.camera.height, config, device)

    @property
    def waves(self) -> int:
        return self.stats.get("waves", 0)

    def _upload_camera(self, camera: Camera) -> torch.Tensor:
        return torch.as_tensor(
            camera_ray_data(camera, self.width, self.height),
            device=self.device)

    # -- camera interaction (main.cu:297-324 semantics) -----------------
    def set_camera(self, camera: Camera) -> None:
        if not camera.almost_equal(self.camera, self.config.camera_epsilon):
            self.camera = camera
            self._cam_data = self._upload_camera(camera)
            self.reset_accumulation()

    def reset_camera(self) -> None:
        """'R' key / Reset button (imgui_manager.cpp:289-307)."""
        self.set_camera(self.initial_camera)

    def set_samples_per_frame(self, spf: int) -> None:
        spf = int(np.clip(spf, self.config.spf_min, self.config.spf_max))
        if spf != self.samples_per_frame:
            self.samples_per_frame = spf
            self.reset_accumulation()  # main.cu:328-332

    def reset_accumulation(self) -> None:
        self.accum.zero_()
        self.sample_count = 0

    # -- the frame step (main.cu:333-337) --------------------------------
    def step(self, num_samples: Optional[int] = None,
             sync: Optional[bool] = None) -> None:
        """Add ``num_samples`` fresh samples to the accumulation buffer.

        ``sync=True`` waits for the device to finish (the reference's
        per-frame cudaDeviceSynchronize, main.cu:336, via
        ``torch.cuda.synchronize``), which is what makes ``frame_ms`` the
        frame's time.  ``sync=False`` lets successive steps queue on the
        stream.  Default comes from ``config.sync_each_frame``."""
        ns = num_samples or self.samples_per_frame
        if sync is None:
            sync = self.config.sync_each_frame
        cfg = self.config
        t0 = time.perf_counter()
        if self.mode == "megakernel":
            with span("frame.launch"):
                new = render_samples_megakernel(
                    self.scene, self._cam_data, self.width, self.height,
                    self.sample_count, ns, cfg.seed, cfg.max_depth,
                    cfg.rr_start_depth, cfg.enable_nee)
        elif self.mode == "wavefront":
            new = render_samples_wavefront(
                self.scene, self._cam_data, self.width, self.height,
                self.sample_count, ns, cfg.seed, cfg.max_depth,
                cfg.rr_start_depth, nee=cfg.enable_nee,
                trace=cfg.wavefront_trace, stats=self.stats,
                compact_tail=cfg.wavefront_compact_tail,
                tail_trace=cfg.wavefront_tail_trace,
                wave_cache=self._wave_cache)
        elif self.mode in ("mx", "mx2"):
            render = render_samples_mx if self.mode == "mx" \
                else render_samples_mx2
            new = render(self.scene, self._cam_data, self.width, self.height,
                         self.sample_count, ns, cfg.seed, cfg.max_depth,
                         cfg.rr_start_depth, nee=cfg.enable_nee,
                         stats=self.stats)
        elif self.mode == "bricks":
            with span("frame.launch"):
                new = render_samples_bricks(
                    self.scene, self._cam_data, self.width, self.height,
                    self.sample_count, ns, cfg.seed, cfg.max_depth,
                    cfg.rr_start_depth)
        else:
            new = integrator.render_samples(
                self.scene, self._cam_data, self.width, self.height,
                self.sample_count, ns, cfg.seed, cfg.max_depth,
                cfg.enable_nee, cfg.rr_start_depth)
        with span("frame.accumulate"):
            self.accum += new
        if sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.frame_ms = (time.perf_counter() - t0) * 1e3
        self.sample_count += ns

    # -- output ----------------------------------------------------------
    def hdr(self) -> np.ndarray:
        return self.accum.cpu().numpy() / max(self.sample_count, 1)

    def framebuffer(self) -> np.ndarray:
        """Tonemapped uint8 [H,W,3] (UpdateTexture semantics)."""
        return img_util.tonemap(self.accum.cpu().numpy(), self.sample_count)

    def save_png(self, path: str) -> None:
        img_util.write_png(path, self.framebuffer())

    # -- checkpoint / resume (capability beyond the reference; SURVEY §5) -
    def save_checkpoint(self, path: str) -> None:
        img_util.save_exr_like_npz(
            path, self.accum.cpu().numpy(), self.sample_count,
            camera=np.array(self.camera.lookfrom + self.camera.lookat
                            + self.camera.up + (self.camera.vfov,)))

    def load_checkpoint(self, path: str) -> None:
        with np.load(path) as data:
            accum = data["accum"]
            cam = data["camera"]
            sample_count = int(data["sample_count"])
        if accum.shape != (self.height, self.width, 3):
            raise ValueError("checkpoint resolution mismatch")
        self.set_camera(Camera(tuple(cam[0:3]), tuple(cam[3:6]),
                               tuple(cam[6:9]), float(cam[9])))
        self.accum = torch.as_tensor(accum, dtype=torch.float32,
                                     device=self.device).clone()
        self.sample_count = sample_count
