"""Profile of the large-scene main path on one CUDA card.

Builds scenes/blob_box.xml subdivided three levels (327,692 triangles),
renders it with ``ProgressiveRenderer`` (the sorted wavefront: kernel B2
and the bounce step's W1-W3, or the ``--trace`` engine or
``--mode`` path given) at the chip smoke's main-path shape, 640x480, 2
samples per frame, depth 50, and prints:

* the host build, split into parse + subdivide, pack + BVH, SAH + bricks;
* 30 untraced synced frames after 3 warmup (median, min, max, waves per
  frame) and 10 frames queued back to back;
* 5 synced frames under ``torch.profiler``: their host-clock
  time, the device time of all their kernels and the device busy share,
  all three from the same frames; the kernel launches per frame; the
  ``wavefront.*`` ranges of ops/wavefront.py per frame (host time
  inclusive, device time of the kernels launched inside, and the range's
  span on the device's timeline, idle gaps included); peak device memory.

The profiler slows the host's dispatch, so the traced frames are longer
than untraced ones and their busy share is lower.  The device time of the
traced frames over the untraced median is printed as an estimate of the
untraced busy share, and is named so.

Usage, from the root of a checkout:

    python -m pathtracer_cuda_interactive_tpu_torch.render.profile_wavefront \
        [--trace slim|slim2|pairs[N]] [--mode wavefront|mx2|mx] [--out DIR]

``--out DIR`` writes the results as JSON and the profiler's tables as text
into DIR.  No chrome trace is written: a few large-scene frames make one
of hundreds of MB.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

WIDTH, HEIGHT, SPF, LEVELS = 640, 480, 2, 3
WARMUP, FRAMES, UNSYNCED, TRACED = 3, 30, 10, 5


def _device_us(event) -> float:
    """Device microseconds of a profiler key average (torch renamed the
    field from cuda to device)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def _range_device_us(event) -> float:
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def profile_frames(r, n: int, untraced: float, tables: bool = False) -> dict:
    """``n`` synced frames of renderer ``r`` under ``torch.profiler``: their
    host-clock time, the device time of their kernels and the busy share,
    the kernel launches per frame, the ``wavefront.*`` ranges per frame and
    the peak device memory, printed and returned (with ``tables`` also the
    profiler's key averages, under "key_averages").  ``untraced``, the
    median ms of untraced synced frames, is the denominator of the
    estimated untraced busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            r.step(sync=True)
        traced = (time.perf_counter() - t0) / n * 1e3
    peak = torch.cuda.max_memory_allocated()
    ka = prof.key_averages()
    cuda_type = torch.autograd.DeviceType.CUDA

    def is_range(e):
        # record_function ranges appear twice: on the host, and as an
        # annotation spanning their kernels on the device's timeline
        return (getattr(e, "is_user_annotation", False)
                or e.key.startswith("wavefront."))

    device_ms = sum(_device_us(e) for e in ka
                    if e.device_type == cuda_type
                    and not is_range(e)) / n / 1e3
    if device_ms <= 0.0:
        raise SystemExit("profile_wavefront: the profiler saw no device "
                         "time; time the kernels with CUDA events instead")
    launches = sum(e.count for e in ka
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC")) / n
    ranges = {}
    for e in ka:
        if e.key.startswith("wavefront."):
            row = ranges.setdefault(e.key, {"calls": e.count / n})
            if e.device_type == cuda_type:
                row["device_span_ms"] = _device_us(e) / n / 1e3
            else:
                row["host_ms"] = e.cpu_time_total / n / 1e3
                row["device_ms"] = _range_device_us(e) / n / 1e3
    res = dict(traced_frame_ms=traced, traced_device_ms=device_ms,
               traced_busy_share=device_ms / traced,
               estimated_untraced_busy_share=device_ms / untraced,
               launches_per_frame=launches, ranges=ranges,
               peak_device_bytes=peak)
    print(f"traced synced frames: n {n}, {traced:.4f} ms each; device time "
          f"of their kernels {device_ms:.4f} ms per frame; busy share "
          f"{device_ms / traced:.4f} (same frames); estimated untraced busy "
          f"share {device_ms / untraced:.4f} (device time of the traced "
          f"frames over the untraced median, an estimate); {launches:.0f} "
          f"kernel launches per frame; peak device memory {peak} bytes")
    print("range, calls per frame, host ms per frame (inclusive), device ms "
          "of its kernels per frame, device span ms per frame")
    for key in sorted(ranges):
        row = ranges[key]
        print(f"  {key} {row['calls']:.1f} {row.get('host_ms', 0.0):.4f} "
              f"{row.get('device_ms', 0.0):.4f} "
              f"{row.get('device_span_ms', 0.0):.4f}")
    if tables:
        res["key_averages"] = ka
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default="slim",
                    help="the wavefront's engine (RenderConfig."
                         "wavefront_trace)")
    ap.add_argument("--mode", default="wavefront",
                    help="the large-scene path (RenderConfig."
                         "large_scene_mode)")
    ap.add_argument("--out", default=None,
                    help="also write the results and tables into this "
                         "directory")
    args = ap.parse_args(argv)

    import torch

    from .. import SCENES_DIR
    from ..io.xml_scene import parse_scene
    from ..models.bricks import BrickSet
    from ..models.scenepack import pack_scene
    from ..models.subdivide import subdivide_scene
    from ..ops import wave_step
    from ..ops import wavefront as wf
    from ..ops.camera import Camera
    from ..utils.config import RenderConfig
    from .renderer import ProgressiveRenderer

    if not torch.cuda.is_available():
        raise SystemExit("profile_wavefront: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card)
    res = {"card": card, "width": WIDTH, "height": HEIGHT,
           "spf": SPF, "levels": LEVELS, "trace": args.trace,
           "mode": args.mode}

    t0 = time.perf_counter()
    parsed = subdivide_scene(parse_scene(str(SCENES_DIR / "blob_box.xml")),
                             levels=LEVELS)
    t1 = time.perf_counter()
    pack = pack_scene(parsed)
    t2 = time.perf_counter()
    bricks = BrickSet.from_pack(pack)
    t3 = time.perf_counter()
    res.update(triangles=pack.num_triangles, bricks=bricks.num_bricks,
               parse_subdivide_s=t1 - t0, pack_bvh_s=t2 - t1,
               sah_bricks_s=t3 - t2)
    print(f"blob_box x{LEVELS}: {pack.num_triangles} triangles, "
          f"{bricks.num_bricks} bricks; host build: parse+subdivide "
          f"{t1 - t0:.3f} s, pack+BVH {t2 - t1:.3f} s, SAH+bricks "
          f"{t3 - t2:.3f} s")

    wf.load_library()
    wave_step.load_library()
    # the Plucker paths build their own sets from the pack
    r = ProgressiveRenderer(
        bricks if args.mode in ("wavefront", "bricks") else pack,
        Camera.from_parsed(parsed.camera), WIDTH, HEIGHT,
        RenderConfig(samples_per_frame=SPF, wavefront_trace=args.trace,
                     large_scene_mode=args.mode), device="cuda")
    print(f"path {r.mode}, engine {args.trace}")
    for _ in range(WARMUP):
        r.step(sync=True)

    w0 = r.waves
    ms = []
    for _ in range(FRAMES):
        r.step(sync=True)
        ms.append(r.frame_ms)
    waves_per_frame = (r.waves - w0) / FRAMES
    median = statistics.median(ms)
    res.update(frame_ms=ms, median_frame_ms=median,
               waves_per_frame=waves_per_frame)
    print(f"untraced synced frames: n {FRAMES}, median {median:.4f} ms, "
          f"min {min(ms):.4f}, max {max(ms):.4f}; waves per frame "
          f"{waves_per_frame:.2f}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(UNSYNCED):
        r.step(sync=False)
    torch.cuda.synchronize()
    unsynced = (time.perf_counter() - t0) / UNSYNCED * 1e3
    res["unsynced_frame_ms"] = unsynced
    print(f"unsynced frames: n {UNSYNCED}, {unsynced:.4f} ms each")

    res.update(profile_frames(r, TRACED, median, tables=args.out is not None))
    ka = res.pop("key_averages", None)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    res["clocks_power_after"] = clocks
    print(f"after the traced frames: {clocks}")

    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "profile_wavefront.json").write_text(json.dumps(res, indent=1))
        sort_key = ("self_device_time_total"
                    if hasattr(ka[0], "self_device_time_total")
                    else "self_cuda_time_total")
        (out / "profile_wavefront_tables.txt").write_text(
            ka.table(sort_by=sort_key, row_limit=30) + "\n"
            + ka.table(sort_by="cpu_time_total", row_limit=30))
    return 0


if __name__ == "__main__":
    sys.exit(main())
