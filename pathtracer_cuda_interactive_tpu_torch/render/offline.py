"""Offline render CLI — the ``./torrey SCENE_FILE.xml`` analog.

The port of ``pathtracer_cuda_interactive_tpu/render/offline.py``, with a
``--device`` flag (default ``cuda``).  The reference CLI is exactly one
positional scene argument (main.cu:152-157); output/spp/resolution flags
are added since there is no window to show the result in.  Prints the
init-stage timing report the reference prints (main.cu:174-201, 262-266).

Usage:
    python -m pathtracer_cuda_interactive_tpu_torch.render.offline scene.xml \
        [-o out.png] [--spp N] [--width W --height H] [--device cuda|cpu] \
        [--checkpoint ck.npz]
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="torrey-torch")
    ap.add_argument("scene", help="Mitsuba-0.6 scene XML")
    ap.add_argument("-o", "--output", default=None, help="output PNG path")
    ap.add_argument("--spp", type=int, default=None,
                    help="samples per pixel (default: scene sampleCount)")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8,
                    help="samples per kernel launch")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: cuda)")
    ap.add_argument("--checkpoint", default=None,
                    help="save accumulation checkpoint npz here")
    ap.add_argument("--resume", default=None,
                    help="resume from an accumulation checkpoint")
    ap.add_argument("--max-depth", type=int, default=None)
    ap.add_argument("--nee", action="store_true",
                    help="sample point lights with shadow rays (beyond-"
                         "reference capability; the reference never samples "
                         "its parsed point lights)")
    args = ap.parse_args(argv)

    from ..models.scenepack import load_scene
    from ..ops.camera import Camera
    from ..utils.config import RenderConfig
    from .renderer import ProgressiveRenderer

    t0 = time.time()
    pack, parsed = load_scene(args.scene)
    parse_s = time.time() - t0
    print(f"Scene parsing and construction done: took {parse_s:.4f} seconds.")
    print(f"BVH: {pack.num_nodes} nodes, depth {pack.bvh_depth}, "
          f"{pack.num_prims} primitives "
          f"({pack.num_spheres} spheres, {pack.num_triangles} triangles)")

    kw = {"enable_nee": args.nee}
    if args.max_depth:
        kw["max_depth"] = args.max_depth
    cfg = RenderConfig(**kw)
    renderer = ProgressiveRenderer(
        pack, Camera.from_parsed(parsed.camera),
        args.width or parsed.camera.width,
        args.height or parsed.camera.height, cfg, device=args.device)

    if args.resume:
        renderer.load_checkpoint(args.resume)
        print(f"Resumed at {renderer.sample_count} spp from {args.resume}")

    spp = args.spp or parsed.samples_per_pixel
    t0 = time.time()
    first = True
    while renderer.sample_count < spp:
        ns = min(args.batch, spp - renderer.sample_count)
        renderer.step(ns, sync=True)
        if first:
            print(f"First frame (kernel build + {ns} spp): "
                  f"took {time.time() - t0:.4f} seconds.")
            first = False
    total_s = time.time() - t0
    n_samples = renderer.sample_count * renderer.width * renderer.height
    print(f"Rendered {renderer.sample_count} spp at "
          f"{renderer.width}x{renderer.height} on {renderer.device} in "
          f"{total_s:.2f} s ({n_samples / max(total_s, 1e-9) / 1e6:.1f} "
          f"Msamples/s)")

    out = args.output or os.path.splitext(os.path.basename(args.scene))[0] + ".png"
    renderer.save_png(out)
    print(f"Wrote {out}")
    if args.checkpoint:
        renderer.save_checkpoint(args.checkpoint)
        print(f"Wrote checkpoint {args.checkpoint}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
