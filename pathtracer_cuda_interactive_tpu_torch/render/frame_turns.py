"""Synced large-scene frames of this checkout and another, in turns, on one
CUDA card.

For a change whose effect is end to end (the wave loop, the bounce step)
rather than inside one kernel: each turn is a fresh process started in one
checkout's root, which builds scenes/blob_box.xml subdivided three levels
(327,692 triangles) and renders it through ``ProgressiveRenderer`` at the
chip smoke's main-path shape (640x480, 2 samples per frame, depth 50) with
each configuration asked for ("slim", "slim2" and "pairs[N]" name the
wavefront's engine; "bricks", "mx2" and "mx" the large-scene path): 2
warmup frames, then 10 synced frames, host clock.  The process uses only
the renderer's public interface, which the other commit shares, so the
other checkout runs its own code.  Turns go other, this, this, other, so a
drift of the card's clocks falls on both alike.

Usage, from the root of a checkout, with the other commit's port package
unpacked into a git-ignored directory (``mkdir -p .chip_checkout/parent &&
git archive <commit> pathtracer_cuda_interactive_tpu_torch | tar -x -C
.chip_checkout/parent``):

    python -m pathtracer_cuda_interactive_tpu_torch.render.frame_turns \\
        --other .chip_checkout/parent [--configs slim,slim2,pairs,mx2] \\
        [--out DIR]

Prints each turn's median frame per configuration, then per configuration
the median of this checkout's turns over the other's; ``--out DIR`` also
writes them as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

WIDTH, HEIGHT, SPF, LEVELS, WARMUP, FRAMES = 640, 480, 2, 3, 2, 10

# one turn: run in a checkout's root with that checkout on the path
_TURN = f"""
import json, sys
from pathtracer_cuda_interactive_tpu_torch import SCENES_DIR
from pathtracer_cuda_interactive_tpu_torch.io.xml_scene import parse_scene
from pathtracer_cuda_interactive_tpu_torch.models.bricks import BrickSet
from pathtracer_cuda_interactive_tpu_torch.models.scenepack import pack_scene
from pathtracer_cuda_interactive_tpu_torch.models.subdivide import (
    subdivide_scene)
from pathtracer_cuda_interactive_tpu_torch.ops.camera import Camera
from pathtracer_cuda_interactive_tpu_torch.render.renderer import (
    ProgressiveRenderer)
from pathtracer_cuda_interactive_tpu_torch.utils.config import RenderConfig

parsed = subdivide_scene(parse_scene(str(SCENES_DIR / "blob_box.xml")),
                         levels={LEVELS})
pack = pack_scene(parsed)
bricks = BrickSet.from_pack(pack).to("cuda")
cam = Camera.from_parsed(parsed.camera)
out = {{}}
for name in sys.argv[1].split(","):
    mode = name if name in ("bricks", "mx2", "mx") else "wavefront"
    config = RenderConfig(samples_per_frame={SPF}, large_scene_mode=mode,
                          wavefront_trace=name if mode == "wavefront"
                          else "slim")
    r = ProgressiveRenderer(bricks if mode in ("wavefront", "bricks")
                            else pack, cam, {WIDTH}, {HEIGHT}, config,
                            device="cuda")
    for _ in range({WARMUP}):
        r.step(sync=True)
    ms = []
    for _ in range({FRAMES}):
        r.step(sync=True)
        ms.append(r.frame_ms)
    out[name] = ms
    del r
print(json.dumps(out))
"""


def _turn(root: Path, configs: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, "-c", _TURN, configs], cwd=root,
                          env=env, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"frame_turns: the turn in {root} failed:\n"
                         f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="the root of the other checkout (it holds "
                         "pathtracer_cuda_interactive_tpu_torch/)")
    ap.add_argument("--configs", default="slim,slim2,pairs,mx2",
                    help="engines and paths, comma-separated")
    ap.add_argument("--out", default=None,
                    help="also write the results into this directory")
    args = ap.parse_args(argv)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card)
    roots = {"other": Path(args.other).resolve(),
             "this": Path(__file__).resolve().parents[2]}
    turns = []
    for which in ("other", "this", "this", "other"):
        frames = _turn(roots[which], args.configs)
        turns.append({"checkout": which, "frames_ms": frames})
        print(f"{which}: " + ", ".join(
            f"{name} {statistics.median(ms):.4f} ms"
            for name, ms in frames.items()))
    ratios = {}
    for name in args.configs.split(","):
        med = {which: statistics.median(
            statistics.median(t["frames_ms"][name]) for t in turns
            if t["checkout"] == which) for which in roots}
        ratios[name] = {"this_ms": med["this"], "other_ms": med["other"],
                        "this_over_other": med["this"] / med["other"]}
        print(f"{name}: this {med['this']:.4f} ms, other {med['other']:.4f} "
              f"ms, {med['this'] / med['other']:.3f} of the other's")
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "frame_turns.json").write_text(json.dumps(
            {"card": card, "turns": turns, "ratios": ratios}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
