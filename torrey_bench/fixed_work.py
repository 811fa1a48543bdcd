"""Count a configuration's fixed work with the plain reference, once.

    python3 -m torrey_bench.fixed_work <config> [--pixels N] [--device D]

prints the ``fixed_work`` object that the configuration's file keeps for
``kernel_roofline`` (roofline.py): the rays a camera sample traces, the box,
triangle and sphere tests a ray's closest hit makes in the reference's own
search (brute force up to 512 primitives, its BVH walk above), counted over
``N`` pixels drawn from seed 1984 at samples 0 and 1, and the bytes of the
reference's scene tables that search and shading read.  Where the
configuration samples its point lights (``render_config.enable_nee``), also
the shadow rays a camera sample casts, one a hit a light, and the box,
triangle and sphere tests a shadow ray's any-hit search makes.  These are
the configuration's, not the program's: whatever implements a frame, it
needs at least this work.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import BENCH_DIR
from . import reference as ref
from .reference.bruteforce import BRUTE_FORCE_MAX_PRIMS

SEED = 1984
SAMPLES = 2


def count(config: dict, pixels: int, device: str = "cpu") -> dict:
    scene, cam, _ = ref.build_scene(str(BENCH_DIR / config["scene"]),
                                    config["subdivide_levels"])
    w, h = config["width"], config["height"]
    pix = np.random.default_rng(SEED).choice(w * h, size=pixels,
                                             replace=False)
    nee = bool(config.get("render_config", {}).get("enable_nee", False))
    counts = {}
    cam_data = torch.as_tensor(ref.camera_ray_data(cam, w, h), device=device)
    ref.pixel_sample_sums(scene.to(device), cam_data, pix, w, h, 0, SAMPLES,
                          SEED, config["max_depth"], config["rr_start_depth"],
                          nee=nee, counts=counts)
    rays = counts["rays"]
    tables = {name: value for name, value in vars(scene).items()
              if isinstance(value, torch.Tensor)}
    if scene.num_prims <= BRUTE_FORCE_MAX_PRIMS:
        tables.pop("bvh_nodes")         # brute force reads no tree
    out = {
        "rays_per_sample": rays / (pixels * SAMPLES),
        "box_tests_per_ray": counts.get("box", 0) / rays,
        "tri_tests_per_ray": counts.get("tri", 0) / rays,
        "sphere_tests_per_ray": counts.get("sphere", 0) / rays,
    }
    counted = f"{rays} rays"
    if nee:
        shadow = counts.get("shadow_rays", 0)
        per = max(shadow, 1)
        out.update({
            "shadow_rays_per_sample": shadow / (pixels * SAMPLES),
            "shadow_box_tests_per_ray": counts.get("shadow_box", 0) / per,
            "shadow_tri_tests_per_ray": counts.get("shadow_tri", 0) / per,
            "shadow_sphere_tests_per_ray":
                counts.get("shadow_sphere", 0) / per,
        })
        counted += f", {shadow} shadow rays"
    out["scene_bytes"] = int(sum(t.numel() * t.element_size()
                                 for t in tables.values()))
    out["counted_over"] = (f"{pixels} pixels drawn from seed {SEED}, "
                           f"samples 0-{SAMPLES - 1}, {counted}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("--pixels", type=int, default=8192)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    config = json.loads(
        (BENCH_DIR / "configs" / f"{args.config}.json").read_text())
    print(json.dumps(count(config, args.pixels, args.device), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
