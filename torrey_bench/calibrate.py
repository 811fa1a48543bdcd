"""The readings that a configuration's check limits are set from.

    python3 -m torrey_bench.calibrate --workload <cell> --seconds <s> \\
        --seeds 1,2,... --control-seeds 7,8,9 [--out DIR]

On the card, in one process: the cell's scene is built and uploaded once;
then for each of ``--seeds`` a renderer of that seed on the uploaded set is
warmed up and driven for ``--seconds`` as a run drives it, and what its
window added is compared with the reference (check.py): the sound runs,
whose largest ``z_rms`` and ``z_max`` are the lower readings.  For each of
``--control-seeds`` the same, and then the control: the reference rounded
through bfloat16 after every bounce (the nearest precision below the
configuration's float32), put in the program's place over the same pixels
and samples; its smallest readings are the upper ones.  The benchmark's
own runs never run the control.  One JSON line a reading on stdout (and in
``DIR/<cell>.jsonl``), then the summary.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from . import check, program, spec


def _reading(cell, r, size, seed, seconds, device, control):
    from pathtracer_cuda_interactive_tpu_torch.render.renderer import (
        ProgressiveRenderer)
    rc = program.render_config(cell, seed, size)
    renderer = ProgressiveRenderer(r.scene, r.initial_camera, size["width"],
                                   size["height"], rc, device=device)
    s = program.Session(renderer, renderer.camera, size["width"],
                        size["height"], rc.samples_per_frame)
    program.warm_up(s, int(cell.traffic["warmup_frames"]))
    rec = program.run_window(s, cell, seed, seconds)
    pix = check.pick_tiles(cell, size, rec["samples"], seed)
    prog = program.tile_sums(rec.pop("added"), pix)
    del s, renderer
    t0 = time.perf_counter()
    ref_sum, ref_sq = check.reference_sums(
        cell, size, pix, rec["first_sample"], rec["samples"], seed, device,
        rec["camera"])
    ref_s = time.perf_counter() - t0
    out = [dict(kind="sound", seed=seed, frames=len(rec["frames_ms"]),
                samples=rec["samples"], pixels=len(pix), reference_s=ref_s,
                **check.gaps(prog, ref_sum, ref_sq, rec["samples"]))]
    if control:
        ctl, _ = check.reference_sums(
            cell, size, pix, rec["first_sample"], rec["samples"], seed,
            device, rec["camera"], store_dtype=torch.bfloat16)
        out.append(dict(kind="control", seed=seed, samples=rec["samples"],
                        pixels=len(pix),
                        **check.gaps(ctl, ref_sum, ref_sq, rec["samples"])))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    spec.check_scene_files(cell.config)
    size = program.sizes(cell)
    base = program.setup(cell, 0, "cuda")
    r = base.renderer
    seeds = [int(x) for x in args.seeds.split(",") if x]
    controls = [int(x) for x in args.control_seeds.split(",") if x]
    rows = []
    out = None
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        out = open(Path(args.out) / f"{args.workload}.jsonl", "a")
    try:
        for seed in seeds + controls:
            for row in _reading(cell, r, size, seed, args.seconds, "cuda",
                                seed in controls):
                row["workload"] = args.workload
                rows.append(row)
                line = json.dumps(row)
                print(line, flush=True)
                if out:
                    print(line, file=out, flush=True)
    finally:
        if out:
            out.close()
    summary = {"workload": args.workload}
    for kind, pick in (("sound", max), ("control", min)):
        got = [row for row in rows if row["kind"] == kind]
        if got:
            summary[kind] = {k: pick(row[k] for row in got)
                             for k in ("z_rms", "z_max")}
            summary[kind]["seeds"] = len(got)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
