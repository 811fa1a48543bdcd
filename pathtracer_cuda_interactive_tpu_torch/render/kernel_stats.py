"""Traversal counters of the large-scene brick walk on one CUDA card.

The port's counterpart of the JAX package's tools/kernel_stats.py.  It
builds scenes/blob_box.xml subdivided three levels (327,692 triangles) and
takes three waves of the main path's 640x480, 2-sample frame:

* "primary": the camera rays, in the wave layout's screen-tile order;
* "bounce 1 fixed": the first-bounce rays of the live paths, in the
  primary wave's order (the wavefront with sort_mode "none");
* "bounce 1 sorted": the same rays sorted by the wavefront's "sig_mort"
  key, the wave the main path traces.

For each wave it prints the device ms, by CUDA events, of kernel B3 (the
full record, with and without counters), of kernel B2 (the slim walk), of
kernel B4 (B2's walk with the deferred leaf) and of kernel B5 (the pair
lists of 32-row and 8-row packets: the kernel, and the cull and sort in
torch ops apart) and of kernel B7 (the superbrick packet trace of
large_scene_mode "mx2" over the same triangles as an MX2Set: the kernel, and
its cull and sort apart), the kernels in turns with B2 before and after; for
B5 the pairs per packet, the share of the pairs listed to a warp that the
walk's end at the entry bound skips, the share of its visits that end at
the brick's own box and the chunks tested per visit; for B7 the superbricks
listed and visited per packet of 128 rays, the share of listed visits its
early-out skips and the subs voted in per visit; and B3's per-ray
counters: nodes popped, bricks entered and chunk gates passed,
each as the per-ray mean and max and as the mean over warps (32
consecutive rays, one warp of the kernels' launch) of the warp's per-ray
maximum.  A warp's loop runs as long as its longest walk, so the per-ray
mean over that warp-max mean estimates how much of each warp's loop does
useful work for a lane.  The TPU counts per packet of 2048 rays; these are
per ray (ROADMAP C4).

Usage, from the root of a checkout:

    python -m pathtracer_cuda_interactive_tpu_torch.render.kernel_stats \\
        [--out DIR]

``--out DIR`` writes the results as JSON into DIR.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

WIDTH, HEIGHT, SPF, LEVELS = 640, 480, 2, 3
WARP = 32
REPEATS = 10
COUNTERS = ("nodes", "bricks", "chunks")


def counter_summary(counts: torch.Tensor) -> dict:
    """Summary of per-ray counters [3, N] (nodes, bricks, chunks, in the
    rays' launch order): for each counter the per-ray mean and max, the
    mean over warps of 32 consecutive rays of the warp's max, and the
    per-ray mean over that (the estimated useful share of a warp's loop)."""
    c = counts.to(torch.float64)
    warp_max = torch.nn.functional.pad(
        c, (0, -c.shape[1] % WARP)).view(3, -1, WARP).amax(dim=-1)
    out = {}
    for k, name in enumerate(COUNTERS):
        mean = float(c[k].mean())
        wmax = float(warp_max[k].mean())
        out[name] = {"mean": mean, "max": float(c[k].max()),
                     "warp_max_mean": wmax,
                     "useful_share": mean / wmax if wmax > 0 else 0.0}
    return out


def capture_waves(bricks, cam_data, width: int, height: int, spp: int,
                  sort_mode: str):
    """The primary and first-bounce waves of a wavefront render of ``spp``
    samples with ``sort_mode``, as (org, dirn, tnear), traced with B2."""
    from ..ops import wavefront as wf
    waves = []

    def recording(b, org, dirn, tnear):
        waves.append((org, dirn, tnear))
        return wf.trace_wave_slim(b, org, dirn, tnear)

    wf.render_samples_wavefront(bricks, cam_data, width, height, 0, spp,
                                max_depth=2, sort_mode=sort_mode,
                                tracer=recording)
    return waves


def _cuda_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPEATS):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / REPEATS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the results into this directory")
    args = ap.parse_args(argv)

    from .. import SCENES_DIR
    from ..experiments import mx2
    from ..experiments.mx2set import MX2Set
    from ..io.xml_scene import parse_scene
    from ..models.bricks import BrickSet
    from ..models.scenepack import pack_scene
    from ..models.subdivide import subdivide_scene
    from ..ops import pairtrace as pt
    from ..ops import wavefront as wf
    from ..ops.camera import Camera, camera_ray_data

    if not torch.cuda.is_available():
        raise SystemExit("kernel_stats: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card)
    res = {"card": card, "width": WIDTH, "height": HEIGHT, "spf": SPF,
           "levels": LEVELS, "waves": {}}

    t0 = time.perf_counter()
    parsed = subdivide_scene(parse_scene(str(SCENES_DIR / "blob_box.xml")),
                             levels=LEVELS)
    pack = pack_scene(parsed)
    bricks = BrickSet.from_pack(pack).to("cuda")
    print(f"blob_box x{LEVELS}: {bricks.num_bricks} bricks, top depth "
          f"{bricks.top_depth}; host build {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    superbricks = MX2Set.from_pack(pack).to("cuda")
    print(f"as an MX2Set: {superbricks.num_bricks} superbricks; host build "
          f"{time.perf_counter() - t0:.2f} s")
    wf.load_library()
    wf.load_slim2_library()
    pt.load_library()
    mx2.load_library()
    cd = torch.from_numpy(camera_ray_data(Camera.from_parsed(parsed.camera),
                                          WIDTH, HEIGHT)).to("cuda")
    sorted_waves = capture_waves(bricks, cd, WIDTH, HEIGHT, SPF, "sig_mort")
    fixed_waves = capture_waves(bricks, cd, WIDTH, HEIGHT, SPF, "none")
    waves = {"primary": sorted_waves[0], "bounce 1 fixed": fixed_waves[1],
             "bounce 1 sorted": sorted_waves[1]}

    for name, (org, dirn, tnear) in waves.items():
        b3_ms = _cuda_ms(lambda: wf.trace_bricks_full_cuda(
            bricks, *org, *dirn, tnear))
        b3_stats_ms = _cuda_ms(lambda: wf.trace_bricks_full_cuda(
            bricks, *org, *dirn, tnear, collect_stats=True))
        b2 = lambda: wf.trace_bricks_cuda(bricks, *org, *dirn, tnear)
        b2_ms = _cuda_ms(b2)
        b4_ms = _cuda_ms(lambda: wf.trace_bricks_slim2_cuda(
            bricks, *org, *dirn, tnear))
        pairs = {}
        for rows in (pt.PACKET_ROWS, 8):
            brk, ent, cnt = pt.visit_lists(bricks, org, dirn, tnear, rows)
            _, _, seen = pt.trace_pairs_cuda(bricks, *org, *dirn, tnear, brk,
                                             ent, cnt, rows * pt.LANES,
                                             collect_stats=True)
            listed, skipped, tested, boxed_out = seen.tolist()
            visits = max(listed - skipped, 1)
            pairs[f"pairs{rows}"] = {
                "kernel_ms": _cuda_ms(lambda: pt.trace_pairs_cuda(
                    bricks, *org, *dirn, tnear, brk, ent, cnt,
                    rows * pt.LANES)),
                "lists_ms": _cuda_ms(lambda: pt.visit_lists(
                    bricks, org, dirn, tnear, rows)),
                "packets": int(cnt.numel()),
                "pairs_per_packet": float(cnt.float().mean()),
                "max_pairs": int(cnt.max()),
                "skipped_share": skipped / max(listed, 1),
                "boxed_out_share": boxed_out / visits,
                "chunks_per_visit": tested / visits}
        brk, ent, cnt = pt.visit_lists(superbricks, org, dirn, tnear, 1)
        _, _, seen = mx2.trace_mx2_cuda(superbricks, *org, *dirn, tnear, brk,
                                        ent, cnt, collect_stats=True)
        listed, visited, voted, tested, boxed_out = seen.tolist()
        b7 = {"kernel_ms": _cuda_ms(lambda: mx2.trace_mx2_cuda(
                  superbricks, *org, *dirn, tnear, brk, ent, cnt)),
              "lists_ms": _cuda_ms(lambda: pt.visit_lists(
                  superbricks, org, dirn, tnear, 1)),
              "packets": int(cnt.numel()),
              "listed_per_packet": listed / cnt.numel(),
              "visited_per_packet": visited / cnt.numel(),
              "max_listed": int(cnt.max()),
              "skipped_share": 1.0 - visited / max(listed, 1),
              "subs_per_visit": voted / max(visited, 1),
              "subs_tested_per_visit": tested / max(visited, 1),
              "boxed_out_share": boxed_out / max(visited, 1)}
        b2_again_ms = _cuda_ms(b2)
        _, counts = wf.trace_bricks_full_cuda(bricks, *org, *dirn, tnear,
                                              collect_stats=True)
        summary = counter_summary(counts)
        res["waves"][name] = {"rays": int(org.x.numel()), "b3_ms": b3_ms,
                              "b3_counters_ms": b3_stats_ms, "b2_ms": b2_ms,
                              "b2_again_ms": b2_again_ms, "b4_ms": b4_ms,
                              "b5": pairs, "b7": b7, "counters": summary}
        print(f"{name} wave, {org.x.numel()} rays: B3 {b3_ms:.4f} ms "
              f"({b3_stats_ms:.4f} with counters), B2 {b2_ms:.4f} ms "
              f"(again {b2_again_ms:.4f}), B4 {b4_ms:.4f} ms")
        for key, p in pairs.items():
            print(f"  B5 {key}: kernel {p['kernel_ms']:.4f} ms, cull + sort "
                  f"{p['lists_ms']:.4f} ms; {p['packets']} packets, "
                  f"{p['pairs_per_packet']:.2f} pairs per packet (max "
                  f"{p['max_pairs']} of {bricks.num_bricks} bricks); the "
                  f"entry bound skips {p['skipped_share']:.4f} of the pairs "
                  f"listed to a warp, {p['boxed_out_share']:.4f} of its "
                  f"visits end at the brick's box, "
                  f"{p['chunks_per_visit']:.4f} chunks tested per visit")
        print(f"  B7: kernel {b7['kernel_ms']:.4f} ms, cull + sort "
              f"{b7['lists_ms']:.4f} ms; {b7['packets']} packets, "
              f"{b7['listed_per_packet']:.2f} superbricks listed per packet "
              f"(max {b7['max_listed']} of {superbricks.num_bricks}), "
              f"{b7['visited_per_packet']:.2f} visited, early-out skips "
              f"{b7['skipped_share']:.4f} of the listed visits, "
              f"{b7['subs_per_visit']:.4f} subs voted in per visit of "
              f"{b7['subs_tested_per_visit']:.4f} valid, "
              f"{b7['boxed_out_share']:.4f} of the visits ended at the "
              f"superbrick's own box")
        for key in COUNTERS:
            s = summary[key]
            print(f"  {key} per ray: mean {s['mean']:.4f}, max "
                  f"{s['max']:.0f}, warp-max mean {s['warp_max_mean']:.4f}, "
                  f"useful share {s['useful_share']:.4f}")

    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "kernel_stats.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
