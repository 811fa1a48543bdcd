"""The system under test: the port's scene build, its ``ProgressiveRenderer``
and the timed window of synced frames.

Only here does the benchmark import ``pathtracer_cuda_interactive_tpu_torch``,
and only its host scene build (``io``, ``models``) and the renderer.  The
spans around those calls are the benchmark's own:

* ``scene_build_s``: parse, subdivision, pack and the host-side set (the
  BVH, or the SAH treelets and bricks), on the host;
* ``scene_upload_s``: the renderer built from that set: upload, the walk
  table, the camera and the accumulation buffer, synced.
"""

from __future__ import annotations

import random
import statistics
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import BENCH_DIR

# the traced run profiles steady frames from the middle of its window on,
# at least TRACE_MIN_FRAMES and TRACE_MIN_S seconds of them, and at most
# TRACE_MAX_FRAMES
TRACE_MIN_FRAMES = 5
TRACE_MIN_S = 0.25
TRACE_MAX_FRAMES = 400


@dataclass
class Session:
    renderer: object
    initial_camera: object
    width: int
    height: int
    spf: int
    spans: dict = field(default_factory=dict)


def sizes(cell, overrides: dict | None = None) -> dict:
    """The configuration's sizes, with ``overrides`` (a smaller frame for
    the CPU tests) on top."""
    cfg = cell.config
    out = {k: cfg[k] for k in ("width", "height", "max_depth",
                               "rr_start_depth", "subdivide_levels")}
    out.update(overrides or {})
    return out


def render_config(cell, seed: int, size: dict):
    from pathtracer_cuda_interactive_tpu_torch.utils.config import (
        RenderConfig)
    return RenderConfig(max_depth=size["max_depth"],
                        rr_start_depth=size["rr_start_depth"], seed=seed,
                        **cell.render_config)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(cell, seed: int, device: str = "cuda",
          overrides: dict | None = None) -> Session:
    """Build the cell's scene and renderer, timing the two spans."""
    from pathtracer_cuda_interactive_tpu_torch.io.xml_scene import (
        parse_scene)
    from pathtracer_cuda_interactive_tpu_torch.models.bricks import BrickSet
    from pathtracer_cuda_interactive_tpu_torch.models.device_scene import (
        DeviceScene)
    from pathtracer_cuda_interactive_tpu_torch.models.scenepack import (
        pack_scene)
    from pathtracer_cuda_interactive_tpu_torch.models.subdivide import (
        subdivide_scene)
    from pathtracer_cuda_interactive_tpu_torch.ops.camera import Camera
    from pathtracer_cuda_interactive_tpu_torch.render.renderer import (
        ProgressiveRenderer, _render_mode)

    size = sizes(cell, overrides)
    rc = render_config(cell, seed, size)
    dev = torch.device(device)
    t0 = time.perf_counter()
    parsed = parse_scene(str(BENCH_DIR / cell.config["scene"]))
    if size["subdivide_levels"]:
        parsed = subdivide_scene(parsed, levels=size["subdivide_levels"])
    pack = pack_scene(parsed)
    mode = _render_mode(pack, rc.large_scene_mode)
    if mode in ("wavefront", "bricks"):
        host_set = BrickSet.from_pack(pack)
    elif mode in ("megakernel", "plain"):
        host_set = DeviceScene.from_pack(pack)
    else:
        host_set = pack     # "mx" / "mx2" build their own sets
    t1 = time.perf_counter()
    r = ProgressiveRenderer(host_set, Camera.from_parsed(parsed.camera),
                            size["width"], size["height"], rc, device=dev)
    _sync(dev)
    t2 = time.perf_counter()
    return Session(r, r.camera, size["width"], size["height"],
                   rc.samples_per_frame,
                   {"scene_build_s": t1 - t0, "scene_upload_s": t2 - t1})


def warm_up(s: Session, frames: int) -> None:
    for _ in range(frames):
        s.renderer.step(sync=True)


def _traced_frame(r, move, record_function) -> float:
    """One frame as the camera's ``move()``, ``step(sync=False)`` and a
    sync; returns the host ms of ``step`` until it returned."""
    with record_function("bench.frame"):
        with record_function("bench.move"):
            move()
        t0 = time.perf_counter()
        with record_function("bench.step"):
            r.step(sync=False)
        t1 = time.perf_counter()
        with record_function("bench.sync"):
            _sync(r.device)
    return (t1 - t0) * 1e3


def run_window(s: Session, cell, seed: int, seconds: float,
               traced: bool = False) -> dict:
    """Synced frames back to back for ``seconds``: a closed loop, as the
    viewer's and the reference's render loops run.  A frame is the
    traffic's camera move (``before_frame``, as the viewer applies a drag
    before it renders) and the synced step.  Returns the record the
    metrics read: every frame's host ms, the window's seconds, and with
    ``traced`` the host ms of every ``step`` call and the trace's events.

    The window keeps the whole accumulation as it stood before its first
    frame (``before``), so that what it added can be compared."""
    r = s.renderer
    motion_rng = random.Random(seed)
    before = r.accum.clone()
    first_sample = r.sample_count
    camera = r.camera
    frames_ms, step_ms, events = [], [], None
    _sync(r.device)
    if traced:
        from torch.autograd.profiler import record_function
        from torch.profiler import ProfilerActivity, profile

        from .tracing import events_from_profiler
        activities = [ProfilerActivity.CPU]
        if r.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        profiled, prof_t0 = 0, None
    t_start = time.perf_counter()
    deadline = t_start + seconds
    frame = 0
    while True:
        t0 = time.perf_counter()
        if not traced:
            cell.motion.before_frame(r, frame, motion_rng)
            r.step(sync=True)
        else:
            if prof_t0 is None and t0 - t_start >= 0.5 * seconds \
                    and events is None:
                prof.start()
                prof_t0 = t0
            host = _traced_frame(
                r, lambda: cell.motion.before_frame(r, frame, motion_rng),
                record_function)
            if prof_t0 is None:
                step_ms.append(host)
            else:
                profiled += 1
                if profiled >= TRACE_MAX_FRAMES or (
                        profiled >= TRACE_MIN_FRAMES
                        and time.perf_counter() - prof_t0 >= TRACE_MIN_S):
                    prof.stop()
                    events = events_from_profiler(prof)
                    prof_t0 = None
        t1 = time.perf_counter()
        frames_ms.append((t1 - t0) * 1e3)
        frame += 1
        if t1 >= deadline and (not traced or events is not None):
            break
    window_s = t1 - t_start
    added = len(frames_ms) * s.spf
    if r.sample_count == first_sample + added and r.camera == camera:
        start, base = first_sample, before
    else:       # the camera moved: compare the accumulation since its reset
        start, base = 0, torch.zeros_like(before)
    moved = r.camera != s.initial_camera
    return {"frames_ms": frames_ms, "window_s": window_s,
            "step_host_ms": step_ms, "events": events,
            "first_sample": start, "samples": r.sample_count - start,
            "added": r.accum - base,
            "camera": (r.camera.lookfrom, r.camera.lookat, r.camera.up,
                       r.camera.vfov) if moved else None}


def frame_summary(frames_ms: list) -> str:
    return (f"frames {len(frames_ms)}, median "
            f"{statistics.median(frames_ms)!r} ms")


def tile_sums(added: torch.Tensor, pix: np.ndarray) -> np.ndarray:
    """[P, 3] float64 of the window's added sums at flat pixels ``pix``."""
    flat = added.reshape(-1, 3)
    idx = torch.as_tensor(pix, dtype=torch.int64, device=flat.device)
    return flat[idx].to(torch.float64).cpu().numpy()
