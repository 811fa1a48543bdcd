"""Each wave's live count and device times in the wave loop's uncounted
schedule on one CUDA card: the size of the wave loop's tail.

The large scene (scenes/blob_box.xml subdivided three levels, 327,692
triangles) at 640x480, depth 50, through the uncounted schedule
(``render_samples_wavefront`` without a wave cache): a 2-sample frame, and
the first chunk of a 10-sample frame (6 samples, 1,843,200 camera rays).
CUDA events around each wave's trace (kernel B2) and its step (before the
trace: W3's key, the stable sort and the gather; after it: W1 and W2),
the median of ``--repeats`` frames at one sample index after a warm-up
frame.  Then the drain's resident lanes (``wave_step.drain_lanes``) and,
for a drain at a live count of at most one round of them and for the
counted schedule's rule (``wavefront._drains``), what the counted schedule
would leave to the drain: the waves from its first host read (before
waves 1, 5, 9, ...: one a group of ``GROUP_WAVES``) that drains, their
rays, B2 and step times, and every wave that would drain at its own
depth wherever it falls.

    python -m pathtracer_cuda_interactive_tpu_torch.render.wave_times \\
        [--repeats 3] [--out DIR]

Prints one line a wave and a summary a frame; ``--out DIR`` also writes
them as JSON (``wave_times.json``).
"""

from __future__ import annotations

import argparse
import json
import statistics
from pathlib import Path

import torch

from .. import SCENES_DIR
from ..io.xml_scene import parse_scene
from ..models.bricks import BrickSet
from ..models.scenepack import pack_scene
from ..models.subdivide import subdivide_scene
from ..ops import wave_step, wavefront
from ..ops.camera import Camera, camera_ray_data
from ..ops.integrator import RR_START_DEPTH

WIDTH, HEIGHT, LEVELS = 640, 480, 3
FRAMES = {"spf2 frame": 2, "spf10 first chunk": 6}


def wave_times(bricks, cd, samples: int) -> list:
    """[{rays, b2_ms, step_ms}] of each wave of one frame of ``samples``
    samples (one chunk) through the uncounted schedule."""
    waves, cur = [], {}

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def key(*args):
        cur["step0"] = event()
        return wave_step.STEPS.key(*args)

    def tracer(scene, org, dirn, tnear):
        cur.setdefault("step0", event())     # the primary wave has no sort
        cur["trace0"] = event()
        hit = wavefront.trace_wave_slim(scene, org, dirn, tnear)
        cur["trace1"] = event()
        cur["rays"] = int(org.x.numel())
        return hit

    def shade(*args):
        new = wave_step.STEPS.shade(*args)
        cur["step1"] = event()
        waves.append(dict(cur))
        cur.clear()
        return new

    steps = wave_step.WaveSteps(wave_step.STEPS.record,
                                wave_step.STEPS.shadow_rays, shade, key)
    wavefront.render_samples_wavefront(bricks, cd, WIDTH, HEIGHT, 0, samples,
                                       tracer=tracer, steps=steps)
    torch.cuda.synchronize()
    return [{"rays": w["rays"],
             "b2_ms": w["trace0"].elapsed_time(w["trace1"]),
             "step_ms": (w["step0"].elapsed_time(w["trace0"])
                         + w["trace1"].elapsed_time(w["step1"]))}
            for w in waves]


def tail(rows: list, rule: str, drains) -> dict:
    """What the counted schedule would leave to the drain under ``rule``
    (``drains(live, depth) -> bool``): the waves from the first host read
    (before wave 1 + k GROUP_WAVES) that drains, and every wave that would
    drain at its own depth."""
    reads = range(1, len(rows), wavefront.GROUP_WAVES)
    first = next((w for w in reads if drains(rows[w]["rays"], w)),
                 len(rows))

    def total(waves):
        return {"waves": len(waves),
                "rays": sum(rows[w]["rays"] for w in waves),
                "b2_ms": sum(rows[w]["b2_ms"] for w in waves),
                "step_ms": sum(rows[w]["step_ms"] for w in waves)}

    return {"rule": rule, "from_wave": first,
            "drained": total(range(first, len(rows))),
            "under": total([w for w, r in enumerate(rows)
                            if drains(r["rays"], w)])}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args(argv)
    parsed = subdivide_scene(parse_scene(str(SCENES_DIR / "blob_box.xml")),
                             levels=LEVELS)
    bricks = BrickSet.from_pack(pack_scene(parsed)).to("cuda")
    cam = Camera.from_parsed(parsed.camera)
    cd = torch.as_tensor(camera_ray_data(cam, WIDTH, HEIGHT), device="cuda")
    lanes = wave_step.drain_lanes("cuda")
    print(f"{torch.cuda.get_device_name()}: drain resident lanes {lanes}")
    report = {"device": torch.cuda.get_device_name(), "drain_lanes": lanes}
    for label, samples in FRAMES.items():
        wave_times(bricks, cd, samples)          # warm-up
        runs = [wave_times(bricks, cd, samples) for _ in range(args.repeats)]
        rows = [{"rays": runs[0][w]["rays"],
                 **{k: statistics.median(r[w][k] for r in runs)
                    for k in ("b2_ms", "step_ms")}}
                for w in range(len(runs[0]))]
        for w, row in enumerate(rows):
            print(f"{label} wave {w}: {row['rays']} rays, B2 "
                  f"{row['b2_ms']:.4f} ms, step {row['step_ms']:.4f} ms")
        tails = [tail(rows, f"at most {lanes} live",
                      lambda live, depth: live <= lanes),
                 tail(rows, "wavefront._drains",
                      lambda live, depth: wavefront._drains(
                          live, depth, lanes, RR_START_DEPTH))]
        for t in tails:
            d, u = t["drained"], t["under"]
            print(f"{label}, a drain {t['rule']}: from wave "
                  f"{t['from_wave']}: {d['waves']} waves, {d['rays']} rays, "
                  f"B2 {d['b2_ms']:.4f} ms, steps {d['step_ms']:.4f} ms; "
                  f"all waves it drains: {u['waves']} waves, "
                  f"{u['rays']} rays, B2 {u['b2_ms']:.4f} ms, steps "
                  f"{u['step_ms']:.4f} ms")
        print(f"{label}: {len(rows)} waves, "
              f"{sum(r['rays'] for r in rows)} rays, B2 "
              f"{sum(r['b2_ms'] for r in rows):.4f} ms, steps "
              f"{sum(r['step_ms'] for r in rows):.4f} ms")
        report[label] = {"waves": rows, "tails": tails}
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "wave_times.json").write_text(json.dumps(report,
                                                             indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
