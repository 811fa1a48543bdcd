"""Runtime configuration.

The port of ``pathtracer_cuda_interactive_tpu/utils/config.py``.  The
reference scatters its knobs across compile-time constants (SURVEY.md §5
"Config/flag system": MAX_DEPTH 50 radiance.cuh:12, RR start depth 5
radiance.cuh:68, camera epsilon 1e-5 main.cu:298, default 2 samples/frame
main.cu:131, RNG seed 1984 main.cu:61, UI ranges imgui_manager.cpp:101-105).
Here they live in one dataclass, with the JAX package's defaults; its
``setup_jax`` has no counterpart.  The port runs every value of
``wavefront_trace`` (ops/wavefront.py::parse_engine) and of
``large_scene_mode`` (render/renderer.py), and the JAX package's
compaction-ladder knobs ``wavefront_compact_tail`` and
``wavefront_tail_trace`` with its semantics (ops/wavefront.py::
render_waves).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RenderConfig:
    max_depth: int = 50            # radiance.cuh:12
    rr_start_depth: int = 5        # radiance.cuh:68
    camera_epsilon: float = 1e-5   # main.cu:298
    samples_per_frame: int = 2     # main.cu:131
    seed: int = 1984               # main.cu:61
    fov_min: float = 10.0          # imgui_manager.cpp:101
    fov_max: float = 120.0
    spf_min: int = 1               # imgui_manager.cpp:105
    spf_max: int = 10
    move_speed: float = 0.5        # imgui_manager.cpp WASD speed (:143)
    mouse_sensitivity: float = 0.1  # imgui_manager.cpp orbit (:254)
    # block on the device each frame (cudaDeviceSynchronize analog,
    # main.cu:336), which makes frame_ms the frame's device time.  False
    # lets frames queue on the stream, for throughput runs.
    sync_each_frame: bool = True
    # next-event estimation for point lights — beyond the reference, which
    # parses point lights but never samples them (SURVEY.md §3.5)
    enable_nee: bool = False
    # large-triangle-scene compute path: "wavefront", the sorted wavefront
    # (ops/wavefront.py, kernel B2), or "bricks", the persistent brick
    # render (ops/brickkernel.py, kernel B6; with enable_nee the renderer
    # takes "wavefront", since B6 has no NEE), or one of the Plucker-matmul
    # paths of experiments/: "mx" (library products over 128-triangle
    # bricks, experiments/mxtrace.py) or "mx2" (kernel B7 over superbricks,
    # experiments/mx2.py, csrc/mx2_trace.cu).  A prebuilt BrickSet takes
    # the wavefront for "mx" and "mx2".
    large_scene_mode: str = "wavefront"
    # per-wave closest-hit engine of the wavefront (ops/wavefront.py::
    # parse_engine): "slim", kernel B2 (csrc/brick_trace.cu; "slim[N]" and
    # "slimg[N]" run it too: a per-ray walk has no packet to size); "slim2",
    # kernel B4, the walk that fetches the next leaf before it tests this
    # one (csrc/brick_trace_slim2.cu); "pairs[N]", kernel B5, visit lists
    # from torch ops for packets of N x 128 rays, default 32
    # (ops/pairtrace.py, csrc/pair_trace.cu).
    wavefront_trace: str = "slim"
    # the JAX package's compaction ladder (ops/wavefront.py::render_waves):
    # its chunk count, 0 turns it off; the port compacts after every wave,
    # so any value above 0 renders the same image
    wavefront_compact_tail: int = 8
    # with the ladder on, the engine of the waves from depth 2 on ("" = the
    # same as wavefront_trace)
    wavefront_tail_trace: str = ""
