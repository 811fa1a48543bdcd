"""Smoke test of the PyTorch and CUDA port on one NVIDIA card.

Run from the root of a checkout:

    python3 chip_smoke.py [--out DIR]

It imports the port (pathtracer_cuda_interactive_tpu_torch) and nothing of
JAX, and fails with a non-zero exit code if any phase fails:

1. the card's name and power limit (nvidia-smi);
2. the megakernel build (csrc/megakernel.cu, nvcc for sm_90a) and its time;
3. the kernel against its plain torch version on the card, on the in-repo
   sphere, Cornell-box and point-light scenes at 160x120 and on the Cornell
   box at the main path's 640x480, each at depth 4 (shallow criterion) and
   depth 12 (statistical criterion), with both versions timed at the main
   path's shape;
4. the main path: ProgressiveRenderer on the rect Cornell box at 640x480,
   2 samples per frame, depth 50, on cuda — 30 synced frames after warmup,
   the launch counter, the camera and samples-per-frame resets, a finite
   non-flat image and a PNG;
5. the offline CLI on cuda.

Its last two lines are a JSON object describing each kernel and then
{"ok": true, "device": {...}}.  ``--out DIR`` also writes the PNGs and a
results JSON into DIR.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

MAIN_W, MAIN_H = 640, 480
SMALL_W, SMALL_H = 160, 120
SPP = 2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def shallow_check(got: np.ndarray, ref: np.ndarray) -> dict:
    """tests/test_megakernel.py:57-60: at most max(1e-4 of the elements, 2)
    outside rtol = atol = 1e-4, and a mean absolute error below 1e-4."""
    bad = ~np.isclose(got, ref, rtol=1e-4, atol=1e-4)
    err = np.abs(got - ref)
    ok = bad.sum() <= max(1e-4 * bad.size, 2) and err.mean() < 1e-4
    return {"criterion": "shallow", "ok": bool(ok),
            "mismatch_share": float(bad.mean()),
            "mean_abs_err": float(err.mean()),
            "max_abs_err": float(err.max())}


def deep_check(got: np.ndarray, ref: np.ndarray) -> dict:
    """tests/test_megakernel.py:74-77: under 0.2% of pixels off by more
    than 1e-3, mean absolute error and mean difference below 1e-3."""
    err = np.abs(got - ref)
    flipped = err.max(axis=-1) > 1e-3
    ok = (flipped.mean() < 2e-3 and err.mean() < 1e-3
          and abs(float(got.mean() - ref.mean())) < 1e-3)
    return {"criterion": "statistical", "ok": bool(ok),
            "mismatch_share": float(flipped.mean()),
            "mean_abs_err": float(err.mean()),
            "max_abs_err": float(err.max())}


def cuda_ms(fn, repeats: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``repeats`` back-to-back
    calls, by CUDA events, after one warmup call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / repeats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write PNGs and results.json into this directory")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from pathtracer_cuda_interactive_tpu_torch import SCENES_DIR
    from pathtracer_cuda_interactive_tpu_torch.models.device_scene import (
        DeviceScene)
    from pathtracer_cuda_interactive_tpu_torch.models.scenepack import (
        load_scene)
    from pathtracer_cuda_interactive_tpu_torch.ops import integrator
    from pathtracer_cuda_interactive_tpu_torch.ops import megakernel as mk
    from pathtracer_cuda_interactive_tpu_torch.ops.camera import (
        Camera, camera_ray_data)
    from pathtracer_cuda_interactive_tpu_torch.render import offline
    from pathtracer_cuda_interactive_tpu_torch.render.renderer import (
        ProgressiveRenderer)

    dev = torch.device("cuda")
    results = {}

    # -- 1. the card ------------------------------------------------------
    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device 0: {kind}")
    results["card"] = card

    # -- 2. the kernel build ----------------------------------------------
    t0 = time.perf_counter()
    mk.load_library()
    build_s = time.perf_counter() - t0
    print(f"megakernel build+load: {build_s:.2f} s")
    results["build_s"] = build_s

    # -- 3. kernel against its plain version on the card ------------------
    def load(name, width, height):
        pack, parsed = load_scene(str(SCENES_DIR / f"{name}.xml"))
        cd = camera_ray_data(Camera.from_parsed(parsed.camera), width, height)
        return DeviceScene.from_pack(pack).to(dev), torch.from_numpy(cd).to(dev)

    comparisons = []
    cases = [("spheres", False, SMALL_W, SMALL_H),
             ("cbox_rect", False, SMALL_W, SMALL_H),
             ("pointlight", True, SMALL_W, SMALL_H),
             ("cbox_rect", False, MAIN_W, MAIN_H)]
    for name, nee, width, height in cases:
        scene, cd = load(name, width, height)
        for depth, check in ((4, shallow_check), (12, deep_check)):
            got = mk.render_samples_megakernel(scene, cd, width, height, 0,
                                               SPP, max_depth=depth, nee=nee)
            ref = integrator.render_samples(scene, cd, width, height, 0, SPP,
                                            max_depth=depth, nee=nee)
            torch.cuda.synchronize()
            res = check(got.cpu().numpy(), ref.cpu().numpy())
            res.update(scene=name, nee=nee, width=width, height=height,
                       spp=SPP, depth=depth)
            comparisons.append(res)
            print(f"kernel vs plain {name} nee={nee} {width}x{height} "
                  f"depth {depth} ({res['criterion']}): "
                  f"mismatch share {res['mismatch_share']:.3e}, "
                  f"max abs err {res['max_abs_err']:.3e}, "
                  f"mean abs err {res['mean_abs_err']:.3e} "
                  f"-> {'ok' if res['ok'] else 'FAIL'}")
    results["comparisons"] = comparisons
    failed = [c for c in comparisons if not c["ok"]]
    if failed:
        raise SystemExit(f"chip_smoke: kernel disagrees with its plain "
                         f"version: {failed}")
    main_err = next(c["max_abs_err"] for c in comparisons
                    if c["width"] == MAIN_W and c["depth"] == 4)

    # both versions timed at the main path's shape: 640x480, 2 spp, depth 50
    scene, cd = load("cbox_rect", MAIN_W, MAIN_H)
    sample = [0]

    def kernel_frame():
        sample[0] += SPP
        mk.render_samples_megakernel(scene, cd, MAIN_W, MAIN_H, sample[0], SPP)

    def plain_frame():
        sample[0] += SPP
        integrator.render_samples(scene, cd, MAIN_W, MAIN_H, sample[0], SPP)

    timings = {"kernel_ms": [], "plain_ms": []}
    for which in ("plain", "kernel", "kernel", "plain", "plain", "kernel"):
        timings[f"{which}_ms"].append(
            cuda_ms(kernel_frame, 20) if which == "kernel"
            else cuda_ms(plain_frame, 3))
    kernel_ms = statistics.median(timings["kernel_ms"])
    plain_ms = statistics.median(timings["plain_ms"])
    rays, samples = integrator.measure_path_stats(scene, cd, MAIN_W, MAIN_H,
                                                  0, SPP)
    path_len = float(rays) / samples
    print(f"timing {MAIN_W}x{MAIN_H} {SPP} spp depth 50: kernel "
          f"{kernel_ms:.4f} ms {timings['kernel_ms']}, plain {plain_ms:.2f} ms "
          f"{timings['plain_ms']}; avg path length {path_len:.4f} rays/sample")
    results.update(kernel_ms=kernel_ms, plain_ms=plain_ms, timings=timings,
                   avg_path_length=path_len)
    del scene, cd

    # -- 4. the main path ---------------------------------------------------
    mk.megakernel_cuda.launches = 0
    renderer = ProgressiveRenderer.from_xml(
        str(SCENES_DIR / "cbox_rect.xml"), width=MAIN_W, height=MAIN_H,
        device="cuda")
    warmup, frames = 5, 30
    for _ in range(warmup):
        renderer.step(sync=True)
    frame_ms = []
    for _ in range(frames):
        renderer.step(sync=True)
        frame_ms.append(renderer.frame_ms)
    launches = mk.megakernel_cuda.launches
    if launches != warmup + frames:
        raise SystemExit(f"chip_smoke: {launches} kernel launches for "
                         f"{warmup + frames} frames")
    median_ms = statistics.median(frame_ms)
    # the highest percentile with ten frames beyond it
    tail_ms = sorted(frame_ms)[frames - 11]
    msamples = MAIN_W * MAIN_H * SPP / (median_ms * 1e-3) / 1e6
    print(f"main path {MAIN_W}x{MAIN_H} spf {SPP} depth 50: {frames} synced "
          f"frames, median {median_ms:.4f} ms, {frames - 10}/{frames} "
          f"quantile {tail_ms:.4f} ms (min {min(frame_ms):.4f}, max "
          f"{max(frame_ms):.4f}), {msamples:.2f} Msamples/s, "
          f"{msamples * path_len:.2f} Mrays/s, kernel share of the frame "
          f"{kernel_ms / median_ms:.3f}; launches {launches}")
    img = renderer.hdr()
    if not (img.shape == (MAIN_H, MAIN_W, 3) and np.isfinite(img).all()
            and img.mean() > 0 and img.std() > 0):
        raise SystemExit("chip_smoke: main-path image is not finite and "
                         "non-flat")
    print(f"image after {renderer.sample_count} spp: mean {img.mean():.5f} "
          f"std {img.std():.5f}")
    mk.BUILD_DIR.mkdir(exist_ok=True)
    png = mk.BUILD_DIR / "chip_smoke_cbox_rect.png"
    renderer.save_png(str(png))

    cam = renderer.camera
    renderer.set_camera(Camera(cam.lookfrom, (0.1, 1.0, 0.0), cam.up,
                               cam.vfov))
    if renderer.sample_count != 0:
        raise SystemExit("chip_smoke: a camera move did not reset")
    renderer.step()
    renderer.set_samples_per_frame(4)
    if renderer.sample_count != 0 or renderer.samples_per_frame != 4:
        raise SystemExit("chip_smoke: an spf change did not reset")
    renderer.step()
    if renderer.sample_count != 4 or not np.isfinite(renderer.hdr()).all():
        raise SystemExit("chip_smoke: step after the resets failed")
    results.update(frame_ms=frame_ms, median_frame_ms=median_ms,
                   tail_frame_ms=tail_ms,
                   msamples_per_s=msamples, launches=launches,
                   image_mean=float(img.mean()))

    # -- 5. the offline CLI on cuda -----------------------------------------
    cli_png = mk.BUILD_DIR / "chip_smoke_cli.png"
    before = mk.megakernel_cuda.launches
    if offline.main([str(SCENES_DIR / "spheres.xml"), "--device", "cuda",
                     "--spp", "8", "--batch", "4", "-o", str(cli_png)]) != 0:
        raise SystemExit("chip_smoke: offline CLI failed")
    if mk.megakernel_cuda.launches != before + 2 or not cli_png.exists():
        raise SystemExit("chip_smoke: offline CLI did not run the kernel")

    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        shutil.copy(png, out / png.name)
        shutil.copy(cli_png, out / cli_png.name)
        (out / "chip_smoke_results.json").write_text(
            json.dumps(results, indent=1))

    src = Path(mk.__file__).resolve().parent.parent / "csrc" / "megakernel.cu"
    print(json.dumps({"kernels": [{
        "name": "megakernel",
        "route": "cuda",
        "source": str(src.relative_to(Path(__file__).resolve().parent)),
        "replaces": "pathtracer_cuda_interactive_tpu/ops/megakernel.py:440",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
