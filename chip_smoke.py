"""Smoke test of the PyTorch and CUDA port on one NVIDIA card.

Run from the root of a checkout:

    python3 chip_smoke.py [--out DIR]

It imports the port (pathtracer_cuda_interactive_tpu_torch) and nothing of
JAX, and fails with a non-zero exit code if any phase fails:

1. the card's name and power limit (nvidia-smi);
2. the megakernel build (csrc/megakernel.cu, nvcc for sm_90a) and its time;
2b. the brick-trace build (csrc/brick_trace.cu, kernels B2 and B3 on the
   walk of csrc/brick_walk.cuh), started at the same time as the
   megakernel's, with its time and ptxas report;
2c. the brick-render build (csrc/brick_render.cu, kernel B6), in the same
   parallel build;
2d. the builds of csrc/brick_trace_slim2.cu (kernel B4) and
   csrc/pair_trace.cu (kernel B5), in the same parallel build, with their
   times and ptxas reports;
2e. the build of csrc/mx2_trace.cu (kernel B7), the sixth source of the
   same parallel build, with its time and ptxas report;
3. the megakernel against its plain torch version on the card, on the
   in-repo sphere, Cornell-box and point-light scenes and on two larger
   tables made from the Cornell box (models/subdivide.py::table_scenes: 42
   spheres with 128 triangles, which a warp takes lane by lane while most
   of its lanes hold a ray and together after, and 512 triangles, which it
   always takes together) at 160x120, and on the
   Cornell box at the main path's 640x480, each at depth 4 (shallow
   criterion) and depth 12 (statistical criterion), with both versions
   timed at the main path's shape;
3b. kernel B2 against its plain version: on the primary wave and a sorted
   first-bounce wave of a 640x480, 2-sample render of scenes/blob_box.xml;
   in whole wavefront renders at 160x120, depth 4 (shallow) and 12
   (statistical), NEE off and on; then the large scene is built (blob_box
   subdivided three levels, 327,692 triangles) with its walk table (the
   compact table kernels B2, B3 and B6 read: its bytes and build time are
   printed), and on its primary and first-bounce waves of a 640x480,
   2-sample render, the waves the main path launches, both versions are
   compared and timed; on all four waves t and slot equal the plain
   version's bit for bit on every ray;
3c. kernel B3 (the full record with per-ray counters) against its plain
   version on the same four waves: all 16 channels and the three counters
   equal on all but at most 1e-4 of the rays; B3 timed against B2 and its
   plain version on the large scene's waves;
3d. kernel B6 against its plain version: blob_box at 160x120, 2 samples,
   depth 4 (shallow criterion) and 12 (statistical), and the large scene at
   640x480, 2 samples, depth 4; B6 timed at the main path's shape (640x480,
   2 samples, depth 50) by CUDA events, its plain version once;
3e. kernel B4 (the slim walk with the deferred leaf, engine "slim2") on
   the four waves of 3b: t and slot equal to its plain version and to
   kernel B2 bit for bit; whole wavefront renders at 160x120 with
   trace="slim2", depth 4 (shallow) and 12 (statistical), NEE off and on;
   B4, B2 (in turns) and plain B4 timed on the large scene's waves;
3f. kernel B5 (the pair lists, engines "pairs" and "pairs8") likewise:
   against its plain version t and slot equal on all but 1e-4 of the rays,
   against B2 t bit for bit on every ray and slot on all but 1e-4; the
   renders; timed, with the pairs per packet, and the cull and sort (torch
   ops) timed apart from the kernel;
3g. kernel B7 (the superbrick packet trace of large_scene_mode "mx2") on
   the primary and first-bounce waves of the same two 640x480, 2-sample
   renders through render_samples_mx2 (its own waves: the "mx2" path sorts
   a bounce wave by "mort_oct", the wavefront by "sig_mort"): t, slot and
   the four counters equal to its plain version bit for bit, and on
   blob_box also equal, with the fifth counter (the visits that ended at
   the superbrick's own box), to the plain version with the kernel's early
   votes switched on; against kernel B2, t within rtol 1e-4 on all but
   1e-3 of the rays (the Plucker form rounds otherwise; slots are not
   compared, the two sets order triangles differently); whole "mx2"
   renders at 160x120, depth 4 (shallow) and 12 (statistical), NEE off and
   on, against the same renders through the plain version; B7, B2 on the
   same rays (in turns) and plain B7 timed on the large scene's "mx2"
   waves, the cull and sort apart, with the superbricks listed and visited
   per packet;
3h. the "mx" path (library products in torch ops, no kernel) at 160x120
   on blob_box, depth 4 (the criterion of tests/test_mxtrace.py:62-64) and
   12 (statistical), against the plain integrator;
4. the small-scene main path: ProgressiveRenderer on the rect Cornell box
   at 640x480, 2 samples per frame, depth 50, on cuda — 30 synced frames
   after warmup, the launch counters, the camera and samples-per-frame
   resets, a finite non-flat image and a PNG;
4b. the large-scene main path: ProgressiveRenderer on the subdivided
   blob_box at 640x480, 2 samples per frame, depth 50, on cuda (the
   sorted wavefront) — 10 synced frames after warmup, B2's launches
   against the waves the renderer traced, a camera reset, a finite
   non-flat image and a PNG;
4c. the large scene's "bricks" path in the same call:
   ProgressiveRenderer with RenderConfig(large_scene_mode="bricks") at the
   same shape — 10 synced frames after warmup, one B6 launch per frame and
   no B2 launch, a camera reset, a finite non-flat image and a PNG, NEE
   rerouted to the wavefront, the median frame beside 4b's;
4d. the kernel-stats entry point (render/kernel_stats.py): B3's per-ray
   counters and B3 against B2 on the large scene's waves, with B3's
   launches counted;
4e, 4f. the large scene through ProgressiveRenderer with
   RenderConfig(wavefront_trace="slim2") and then "pairs", same shape —
   10 synced frames after warmup, B4's (B5's) launches against the waves
   traced and no B2 launch, a camera reset, a finite non-flat image that
   meets the statistical criterion against 4b's at the same frame count, a
   PNG, the median frame beside 4b's;
4g. the large scene through ProgressiveRenderer with
   RenderConfig(large_scene_mode="mx2"), same shape and frame counts: B7's
   launches against the waves traced and no launch of another kernel, a
   camera reset, a finite non-flat image that meets the statistical
   criterion against 4b's at the same frame count, a PNG, the median frame
   beside 4b's and 4c's;
4h. the same scene with large_scene_mode="mx" at 640x480, 2 samples per
   frame: one synced frame, timed, at depth 4 (a depth-50 frame takes
   minutes: a bounce packet takes a round for nearly every one of the
   scene's bricks), no kernel launch, a finite non-flat image that meets
   the statistical criterion against the wavefront's at that depth;
5. the offline CLI on cuda.

Its last two lines are a JSON object describing each kernel (with its
bound: the larger of the bytes the function must move over the card's
memory rate and the operations this run's data need over its FP32 rate)
and then {"ok": true, "device": {...}}.  Lines of the form ``[123.4 s]
phase`` give the seconds since the start at the end of each phase.
``--out DIR`` also writes the PNGs and a results JSON into DIR.
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
# Published peaks of one NVIDIA H100 SXM at a 700 W power limit: float32
# outside the tensor cores, and HBM3.
PEAK_FP32_OPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# float32 operations of one slab test (6 subtractions, 6 products, 12
# min/max, 2 comparisons) and of one Moller-Trumbore test (two cross
# products, four dot products, a reciprocal, a subtraction, three scalings
# and the range checks), as csrc/brick_walk.cuh and csrc/pt_common.cuh do
# them; a bounce's shading is small beside its walk and is not counted.
BOX_OPS = 26
TRI_OPS = 52


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the FP32 rate, in ms."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_FP32_OPS * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


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


def wave_check(got: np.ndarray, ref: np.ndarray) -> dict:
    """tests/test_wavefront.py:37-39: fewer than 1e-3 of the elements
    outside rtol = atol = 1e-4, and a mean absolute error below 1e-3."""
    bad = ~np.isclose(got, ref, rtol=1e-4, atol=1e-4)
    err = np.abs(got - ref)
    ok = bad.mean() < 1e-3 and err.mean() < 1e-3
    return {"criterion": "wavefront shallow", "ok": bool(ok),
            "mismatch_share": float(bad.mean()),
            "mean_abs_err": float(err.mean()),
            "max_abs_err": float(err.max())}


def mx_check(got: np.ndarray, ref: np.ndarray) -> dict:
    """tests/test_mxtrace.py:62-64: fewer than 2e-3 of the elements off by
    more than 1e-3, and a mean absolute error below 1e-3."""
    err = np.abs(got - ref)
    bad = err > 1e-3
    ok = bad.mean() < 2e-3 and err.mean() < 1e-3
    return {"criterion": "mx shallow", "ok": bool(ok),
            "mismatch_share": float(bad.mean()),
            "mean_abs_err": float(err.mean()),
            "max_abs_err": float(err.max())}


def trace_check(t, slot, ref_t, ref_slot) -> dict:
    """Kernel B2 against its plain version on one wave: the two walk the
    same per-ray order with the same arithmetic, so slot and the bits of t
    are equal on every ray."""
    t, slot = t.cpu().numpy(), slot.cpu().numpy()
    ref_t, ref_slot = ref_t.cpu().numpy(), ref_slot.cpu().numpy()
    differ = (slot != ref_slot) | (t.view(np.int32) != ref_t.view(np.int32))
    both = (slot == ref_slot) & np.isfinite(t) & np.isfinite(ref_t)
    err = float(np.abs(t[both] - ref_t[both]).max()) if both.any() else 0.0
    return {"ok": not differ.any(), "rays": int(len(t)),
            "mismatch_share": float(differ.mean()),
            "hit_share": float((slot >= 0).mean()), "max_abs_err": err}


def record_check(rec, counts, ref, ref_counts) -> dict:
    """Kernel B3 against its plain version on one wave: all 16 channels and
    the three counters equal on all but at most 1e-4 of the rays (equal-t
    ties on shared edges)."""
    got = torch.stack(rec).cpu().numpy()
    want = torch.stack(ref).cpu().numpy()
    same = (got == want).all(axis=0) & \
        (counts == ref_counts).all(dim=0).cpu().numpy()
    both = same[None, :] & np.isfinite(got) & np.isfinite(want)
    err = float(np.abs(got[both] - want[both]).max()) if both.any() else 0.0
    return {"ok": bool((~same).mean() <= 1e-4), "rays": int(len(same)),
            "mismatch_share": float((~same).mean()),
            "hit_share": float(np.isfinite(got[0]).mean()),
            "max_abs_err": err}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write PNGs and results.json into this directory")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    try:
        from pathtracer_cuda_interactive_tpu_torch import SCENES_DIR
    except ImportError as exc:
        raise SystemExit("chip_smoke: the port package "
                         "pathtracer_cuda_interactive_tpu_torch is not "
                         "importable; run this script from the root of a "
                         f"checkout of the repository ({exc})")
    from pathtracer_cuda_interactive_tpu_torch.experiments import (
        mx2, mxtrace)
    from pathtracer_cuda_interactive_tpu_torch.experiments.mx2set import (
        MX2Set)
    from pathtracer_cuda_interactive_tpu_torch.experiments.mxset import MXSet
    from pathtracer_cuda_interactive_tpu_torch.io.xml_scene import (
        parse_scene)
    from pathtracer_cuda_interactive_tpu_torch.models.bricks import BrickSet
    from pathtracer_cuda_interactive_tpu_torch.models.device_scene import (
        DeviceScene)
    from pathtracer_cuda_interactive_tpu_torch.models.scenepack import (
        load_scene, pack_scene)
    from pathtracer_cuda_interactive_tpu_torch.models.subdivide import (
        subdivide_scene, table_scenes)
    from pathtracer_cuda_interactive_tpu_torch.ops import brickkernel as bk
    from pathtracer_cuda_interactive_tpu_torch.ops import cuda_build
    from pathtracer_cuda_interactive_tpu_torch.ops import integrator
    from pathtracer_cuda_interactive_tpu_torch.ops import megakernel as mk
    from pathtracer_cuda_interactive_tpu_torch.ops import pairtrace as pt
    from pathtracer_cuda_interactive_tpu_torch.ops import wavefront as wf
    from pathtracer_cuda_interactive_tpu_torch.ops.brickkernel import (
        trace_bricks_full_plain, trace_bricks_pipelined_plain,
        trace_bricks_plain)
    from pathtracer_cuda_interactive_tpu_torch.ops.camera import (
        Camera, camera_ray_data)
    from pathtracer_cuda_interactive_tpu_torch.render import (
        kernel_stats, offline)
    from pathtracer_cuda_interactive_tpu_torch.render.renderer import (
        ProgressiveRenderer)
    from pathtracer_cuda_interactive_tpu_torch.utils.config import (
        RenderConfig)

    dev = torch.device("cuda")
    results = {}
    started = time.perf_counter()

    def stamp(phase):
        """Where the run's time goes: seconds since the start, by phase."""
        print(f"[{time.perf_counter() - started:.1f} s] {phase}")

    # -- 1. the card ------------------------------------------------------
    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device 0: {kind}")
    results["card"] = card

    # -- 2, 2b, 2c, 2d and 2e. the kernel builds: one nvcc per source,
    # started together
    t0 = time.perf_counter()
    built = cuda_build.build_all([mk.SOURCE, wf.SOURCE, bk.SOURCE,
                                  wf.SLIM2_SOURCE, pt.SOURCE, mx2.SOURCE])
    mk.load_library()
    wf.load_library()
    bk.load_library()
    wf.load_slim2_library()
    pt.load_library()
    mx2.load_library()
    build_s = time.perf_counter() - t0
    print(f"megakernel build {built[mk.SOURCE]:.2f} s, brick_trace build "
          f"{built[wf.SOURCE]:.2f} s, brick_render build "
          f"{built[bk.SOURCE]:.2f} s, brick_trace_slim2 build "
          f"{built[wf.SLIM2_SOURCE]:.2f} s, pair_trace build "
          f"{built[pt.SOURCE]:.2f} s, mx2_trace build "
          f"{built[mx2.SOURCE]:.2f} s (in parallel); build+load "
          f"{build_s:.2f} s")
    results.update(build_s=build_s, megakernel_build_s=built[mk.SOURCE],
                   brick_trace_build_s=built[wf.SOURCE],
                   brick_render_build_s=built[bk.SOURCE],
                   brick_trace_slim2_build_s=built[wf.SLIM2_SOURCE],
                   pair_trace_build_s=built[pt.SOURCE],
                   mx2_trace_build_s=built[mx2.SOURCE])

    stamp("builds done")
    # -- 3. kernel against its plain version on the card ------------------
    # the two larger tables: 42 spheres with 128 triangles (more than one
    # primitive of each kind a lane; a warp mixes lane by lane and together)
    # and 512 triangles (the limit; always together)
    tables = table_scenes(parse_scene(str(SCENES_DIR / "cbox_rect.xml")))

    def load(name, width, height):
        parsed = tables.get(name) or parse_scene(
            str(SCENES_DIR / f"{name}.xml"))
        cd = camera_ray_data(Camera.from_parsed(parsed.camera), width, height)
        return (DeviceScene.from_pack(pack_scene(parsed)).to(dev),
                torch.from_numpy(cd).to(dev))

    comparisons = []
    cases = [("spheres", False, SMALL_W, SMALL_H),
             ("cbox_rect", False, SMALL_W, SMALL_H),
             ("pointlight", True, SMALL_W, SMALL_H),
             ("mixed", False, SMALL_W, SMALL_H),
             ("full", False, SMALL_W, SMALL_H),
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
            print(f"kernel vs plain {name} ({scene.num_spheres} spheres, "
                  f"{scene.num_triangles} triangles) nee={nee} "
                  f"{width}x{height} depth {depth} ({res['criterion']}): "
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
    # B1 tests every ray of the frame against every primitive; it reads the
    # primitive table and the camera and writes the image
    b1_bound = bound(
        scene.num_prims * 128 + cd.numel() * 4 + MAIN_W * MAIN_H * 12,
        float(rays) * scene.num_prims * TRI_OPS)
    del scene, cd

    stamp("3 done")
    # -- 3b. kernel B2 against its plain version on the card ---------------
    def capture_waves(bricks, cd, width, height, n_waves):
        """The first waves of a plain-traced wavefront render of SPP
        samples, as (org, dirn, tnear): the primary wave, then sorted bounce
        waves, at the size the main path's frames launch them."""
        waves = []

        def recording(b, org, dirn, tnear):
            waves.append((org, dirn, tnear))
            return trace_bricks_plain(b, org, dirn, tnear)

        wf.render_samples_wavefront(bricks, cd, width, height, 0, SPP,
                                    max_depth=n_waves, tracer=recording)
        return waves[:n_waves]

    def capture_mx2_waves(mxs, cd, width, height, n_waves):
        """The first waves of an "mx2" render of SPP samples, as
        ``capture_waves``: the waves that path launches kernel B7 on (a
        bounce wave sorted by "mort_oct").  Traced by B7 itself, which 3g
        then holds to its plain version on these same waves."""
        waves = []

        def recording(m, org, dirn, tnear):
            waves.append((org, dirn, tnear))
            return mx2.trace_wave_mx2(m, org, dirn, tnear)

        mx2.render_samples_mx2(mxs, cd, width, height, 0, SPP,
                               max_depth=n_waves, tracer=recording)
        return waves[:n_waves]

    def compare_waves(bricks, waves, label):
        out = []
        for (org, dirn, tnear), name in zip(waves, ("primary", "bounce 1")):
            t, slot = wf.trace_bricks_cuda(bricks, *org, *dirn, tnear)
            ref_t, ref_slot = trace_bricks_plain(bricks, org, dirn, tnear)
            torch.cuda.synchronize()
            res = trace_check(t, slot, ref_t, ref_slot)
            res.update(scene=label, wave=name)
            out.append(res)
            print(f"B2 vs plain {label} {name} wave: {res['rays']} rays, "
                  f"hit share {res['hit_share']:.4f}, mismatch share "
                  f"{res['mismatch_share']:.3e}, max abs err "
                  f"{res['max_abs_err']:.3e} -> "
                  f"{'ok' if res['ok'] else 'FAIL'}")
        return out

    def compare_full(bricks, waves, label):
        """3c: B3 and its counters against the plain version."""
        out = []
        for (org, dirn, tnear), name in zip(waves, ("primary", "bounce 1")):
            rec, counts = wf.trace_bricks_full_cuda(bricks, *org, *dirn, tnear,
                                                    collect_stats=True)
            ref, ref_counts = trace_bricks_full_plain(bricks, org, dirn,
                                                      tnear,
                                                      collect_stats=True)
            torch.cuda.synchronize()
            res = record_check(rec, counts, ref, ref_counts)
            res.update(scene=label, wave=name,
                       counters=kernel_stats.counter_summary(counts))
            out.append(res)
            per_ray = ", ".join(
                f"{k} {v['mean']:.2f} (max {v['max']:.0f})"
                for k, v in res["counters"].items())
            print(f"B3 vs plain {label} {name} wave: {res['rays']} rays, "
                  f"hit share {res['hit_share']:.4f}, mismatch share "
                  f"{res['mismatch_share']:.3e}, max abs err "
                  f"{res['max_abs_err']:.3e} -> "
                  f"{'ok' if res['ok'] else 'FAIL'}; per ray {per_ray}")
        return out

    def compare_render(bricks, cd, width, height, depth, check, label):
        """3d: one B6 render against its plain version."""
        got = bk.render_samples_bricks(bricks, cd, width, height, 0, SPP,
                                       max_depth=depth)
        ref = bk.render_tiles_bricks_plain(bricks, cd, width, height, 0,
                                           bk.tile_grid(width, height), 0,
                                           SPP, max_depth=depth)
        torch.cuda.synchronize()
        res = check(got.cpu().numpy(), ref.cpu().numpy())
        res.update(scene=label, width=width, height=height, spp=SPP,
                   depth=depth)
        print(f"B6 vs plain {label} {width}x{height} depth {depth} "
              f"({res['criterion']}): mismatch share "
              f"{res['mismatch_share']:.3e}, max abs err "
              f"{res['max_abs_err']:.3e}, mean abs err "
              f"{res['mean_abs_err']:.3e} -> {'ok' if res['ok'] else 'FAIL'}")
        return res

    def require_agreement(kernel, checks):
        failed = [c for c in checks if not c["ok"]]
        if failed:
            raise SystemExit(f"chip_smoke: kernel {kernel} disagrees with its "
                             f"plain version: {failed}")

    def plain_engine(engine):
        """The plain version of a wavefront engine's per-wave trace."""
        if engine == "slim2":
            return trace_bricks_pipelined_plain
        rows = wf.parse_engine(engine)[1]

        def plain_pairs(b, org, dirn, tnear):
            brk, ent, cnt = pt.visit_lists(b, org, dirn, tnear, rows)
            return pt.trace_pairs_plain(b, org, dirn, tnear, brk, ent, cnt,
                                        rows * pt.LANES)
        return plain_pairs

    def compare_engine(bricks, waves, label, engine):
        """3e, 3f: an engine's kernel on each wave against its plain version
        and against kernel B2.  "slim2" must equal both bit for bit;
        "pairs[N]" must give B2's t on every ray, and B2's and its plain
        version's slot on all but 1e-4 of the rays (equal-t ties)."""
        kernel, plain = wf.engine_tracer(engine), plain_engine(engine)
        limit = 0.0 if engine == "slim2" else 1e-4
        out = []
        for (org, dirn, tnear), name in zip(waves, ("primary", "bounce 1")):
            t, slot = kernel(bricks, org, dirn, tnear)
            b2_t, b2_slot = wf.trace_bricks_cuda(bricks, *org, *dirn, tnear)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            ref_t, ref_slot = plain(bricks, org, dirn, tnear)
            stop.record()
            stop.synchronize()
            vs_plain = float(((t != ref_t) | (slot != ref_slot)).float().mean())
            t_differs = int((t != b2_t).sum())
            vs_b2 = float((slot != b2_slot).float().mean())
            both = torch.isfinite(t) & torch.isfinite(ref_t)
            err = float((t[both] - ref_t[both]).abs().max()) if both.any() \
                else 0.0
            res = {"ok": vs_plain <= limit and t_differs == 0
                   and vs_b2 <= limit, "engine": engine, "scene": label,
                   "wave": name, "rays": int(t.numel()),
                   "mismatch_share": vs_plain, "t_differs_from_b2": t_differs,
                   "slot_mismatch_share_vs_b2": vs_b2, "max_abs_err": err,
                   "plain_ms": start.elapsed_time(stop)}
            out.append(res)
            print(f"{engine} vs plain {label} {name} wave: {res['rays']} "
                  f"rays, mismatch share {vs_plain:.3e}, max abs err "
                  f"{err:.3e}; vs B2: t differs on {t_differs} rays, slot "
                  f"mismatch share {vs_b2:.3e} -> "
                  f"{'ok' if res['ok'] else 'FAIL'}")
        return out

    def engine_renders(bricks, cd, engine):
        """3e, 3f: whole wavefront renders through an engine's kernel
        against the same renders through its plain version."""
        out = []
        for nee in (False, True):
            for depth, check in ((4, wave_check), (12, deep_check)):
                got = wf.render_samples_wavefront(
                    bricks, cd, SMALL_W, SMALL_H, 0, SPP, max_depth=depth,
                    nee=nee, trace=engine)
                ref = wf.render_samples_wavefront(
                    bricks, cd, SMALL_W, SMALL_H, 0, SPP, max_depth=depth,
                    nee=nee, tracer=plain_engine(engine))
                torch.cuda.synchronize()
                res = check(got.cpu().numpy(), ref.cpu().numpy())
                res.update(engine=engine, scene="blob_box", nee=nee,
                           width=SMALL_W, height=SMALL_H, spp=SPP,
                           depth=depth)
                out.append(res)
                print(f"wavefront {engine} vs plain blob_box nee={nee} "
                      f"{SMALL_W}x{SMALL_H} depth {depth} "
                      f"({res['criterion']}): mismatch share "
                      f"{res['mismatch_share']:.3e}, max abs err "
                      f"{res['max_abs_err']:.3e}, mean abs err "
                      f"{res['mean_abs_err']:.3e} "
                      f"-> {'ok' if res['ok'] else 'FAIL'}")
        return out

    def compare_b7(mxs, bricks, waves, label, early=False):
        """3g: kernel B7 on each wave (of ``capture_mx2_waves``) against its
        plain version (t, slot and the four counters bit for bit; with
        ``early`` also against the plain version with the kernel's early
        votes switched on, whose fifth counter, the visits that ended at the
        superbrick's own box, must be the kernel's) and against kernel B2's
        t on the same rays over the same triangles in a BrickSet (rtol 1e-4
        on all but 1e-3 of the rays)."""
        out = []
        for (org, dirn, tnear), name in zip(waves, ("primary", "bounce 1")):
            brk, ent, cnt = pt.visit_lists(mxs, org, dirn, tnear, 1)
            t, slot, seen = mx2.trace_mx2_cuda(mxs, *org, *dirn, tnear, brk,
                                               ent, cnt, collect_stats=True)
            b2_t, _ = wf.trace_bricks_cuda(bricks, *org, *dirn, tnear)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            ref_t, ref_slot, ref_seen = mx2.trace_mx2_plain(
                mxs, org, dirn, tnear, brk, ent, cnt, collect_stats=True)
            stop.record()
            stop.synchronize()
            vs_plain = float(((t != ref_t) | (slot != ref_slot)).float().mean())
            vs_b2 = float((~torch.isclose(t, b2_t, rtol=1e-4, atol=0.0))
                          .float().mean())
            both = torch.isfinite(t) & torch.isfinite(ref_t)
            err = float((t[both] - ref_t[both]).abs().max()) if both.any() \
                else 0.0
            listed, visited, voted, tested, boxed_out = seen.tolist()
            same = seen[:4].tolist() == ref_seen.tolist()
            if early:
                early_t, early_slot, early_seen = mx2.trace_mx2_plain(
                    mxs, org, dirn, tnear, brk, ent, cnt, collect_stats=True,
                    early_votes=True)
                same = (same and early_seen.tolist() == seen.tolist()
                        and torch.equal(early_slot, slot)
                        and torch.equal(early_t.view(torch.int32),
                                        t.view(torch.int32)))
            packets = int(cnt.numel())
            res = {"ok": vs_plain == 0.0 and same
                   and vs_b2 <= 1e-3, "scene": label, "wave": name,
                   "rays": int(t.numel()), "packets": packets,
                   "mismatch_share": vs_plain, "t_off_share_vs_b2": vs_b2,
                   "max_abs_err": err, "plain_ms": start.elapsed_time(stop),
                   "listed": listed, "visited": visited, "voted": voted,
                   "tested": tested, "boxed_out": boxed_out,
                   "plain_counters": ref_seen.tolist(),
                   "max_listed": int(cnt.max())}
            out.append(res)
            print(f"B7 vs plain {label} {name} wave: {res['rays']} rays in "
                  f"{packets} packets, mismatch share {vs_plain:.3e}, max abs "
                  f"err {err:.3e}, counters {seen.tolist()} against "
                  f"{ref_seen.tolist()}; vs B2: t off on {vs_b2:.3e} of the "
                  f"rays; per packet {listed / packets:.2f} superbricks "
                  f"listed (max {res['max_listed']} of {mxs.num_bricks}), "
                  f"{visited / packets:.2f} visited, "
                  f"{voted / max(visited, 1):.4f} subs voted in per visit "
                  f"of {tested / max(visited, 1):.4f} valid, {boxed_out} "
                  f"visits ({boxed_out / max(visited, 1):.4f}) ended at the "
                  f"superbrick's own box"
                  f"{' (as in the plain version with early votes)' * early} "
                  f"-> {'ok' if res['ok'] else 'FAIL'}")
        return out

    def mx_renders(label, render, plain_render, shallow):
        """3g, 3h: whole renders of blob_box at 160x120 through
        ``render(nee, depth)`` against ``plain_render(nee, depth)``, at the
        criterion ``shallow`` for depth 4 and statistically for depth 12."""
        out = []
        for nee in (False, True):
            for depth, check in ((4, shallow), (12, deep_check)):
                got, ref = render(nee, depth), plain_render(nee, depth)
                torch.cuda.synchronize()
                res = check(got.cpu().numpy(), ref.cpu().numpy())
                res.update(path=label, scene="blob_box", nee=nee,
                           width=SMALL_W, height=SMALL_H, spp=SPP,
                           depth=depth)
                out.append(res)
                print(f"{label} vs plain blob_box nee={nee} "
                      f"{SMALL_W}x{SMALL_H} depth {depth} "
                      f"({res['criterion']}): mismatch share "
                      f"{res['mismatch_share']:.3e}, max abs err "
                      f"{res['max_abs_err']:.3e}, mean abs err "
                      f"{res['mean_abs_err']:.3e} "
                      f"-> {'ok' if res['ok'] else 'FAIL'}")
        return out

    ENGINES = ("slim2", "pairs", "pairs8")

    blob_pack, blob_parsed = load_scene(str(SCENES_DIR / "blob_box.xml"))
    blob_cam = Camera.from_parsed(blob_parsed.camera)
    blob = BrickSet.from_pack(blob_pack).to(dev)
    cd = torch.from_numpy(camera_ray_data(blob_cam, MAIN_W, MAIN_H)).to(dev)
    blob_waves = capture_waves(blob, cd, MAIN_W, MAIN_H, 2)
    b2_checks = compare_waves(blob, blob_waves, "blob_box")
    b3_checks = compare_full(blob, blob_waves, "blob_box")
    engine_checks = {engine: compare_engine(blob, blob_waves, "blob_box",
                                            engine) for engine in ENGINES}
    blob_mx2 = MX2Set.from_pack(blob_pack).to(dev)
    b7_checks = compare_b7(
        blob_mx2, blob, capture_mx2_waves(blob_mx2, cd, MAIN_W, MAIN_H, 2),
        "blob_box", early=True)
    del blob_waves
    b2_renders = []
    cd = torch.from_numpy(camera_ray_data(blob_cam, SMALL_W, SMALL_H)).to(dev)
    for nee in (False, True):
        for depth, check in ((4, wave_check), (12, deep_check)):
            got = wf.render_samples_wavefront(blob, cd, SMALL_W, SMALL_H, 0,
                                              SPP, max_depth=depth, nee=nee)
            ref = wf.render_samples_wavefront(blob, cd, SMALL_W, SMALL_H, 0,
                                              SPP, max_depth=depth, nee=nee,
                                              tracer=trace_bricks_plain)
            torch.cuda.synchronize()
            res = check(got.cpu().numpy(), ref.cpu().numpy())
            res.update(scene="blob_box", nee=nee, width=SMALL_W,
                       height=SMALL_H, spp=SPP, depth=depth)
            b2_renders.append(res)
            print(f"wavefront B2 vs plain blob_box nee={nee} "
                  f"{SMALL_W}x{SMALL_H} depth {depth} ({res['criterion']}): "
                  f"mismatch share {res['mismatch_share']:.3e}, "
                  f"max abs err {res['max_abs_err']:.3e}, "
                  f"mean abs err {res['mean_abs_err']:.3e} "
                  f"-> {'ok' if res['ok'] else 'FAIL'}")
    b6_checks = [compare_render(blob, cd, SMALL_W, SMALL_H, depth, check,
                                "blob_box")
                 for depth, check in ((4, wave_check), (12, deep_check))]
    engine_render_checks = {engine: engine_renders(blob, cd, engine)
                            for engine in ENGINES}
    b7_renders = mx_renders(
        "mx2 B7",
        lambda nee, depth: mx2.render_samples_mx2(
            blob_mx2, cd, SMALL_W, SMALL_H, 0, SPP, max_depth=depth,
            nee=nee),
        lambda nee, depth: mx2.render_samples_mx2(
            blob_mx2, cd, SMALL_W, SMALL_H, 0, SPP, max_depth=depth,
            nee=nee, tracer=mx2.trace_wave_mx2_plain), wave_check)
    # 3h: the "mx" path against the plain integrator
    blob_mx = MXSet.from_pack(blob_pack).to(dev)
    blob_scene = DeviceScene.from_pack(blob_pack).to(dev)
    mx_render_checks = mx_renders(
        "mx",
        lambda nee, depth: mxtrace.render_samples_mx(
            blob_mx, cd, SMALL_W, SMALL_H, 0, SPP, max_depth=depth,
            nee=nee),
        lambda nee, depth: integrator.render_samples(
            blob_scene, cd, SMALL_W, SMALL_H, 0, SPP, max_depth=depth,
            nee=nee), mx_check)
    del blob, blob_mx2, blob_mx, blob_scene
    require_agreement("B2", b2_checks + b2_renders)
    require_agreement("B3", b3_checks)
    require_agreement("B6", b6_checks)
    for engine in ENGINES:
        require_agreement(engine, engine_checks[engine]
                          + engine_render_checks[engine])
    require_agreement("B7", b7_checks + b7_renders)
    require_agreement("mx", mx_render_checks)

    stamp("3b-3h on blob_box done")
    # the large scene of the main path: blob_box subdivided three levels
    t0 = time.perf_counter()
    big_parsed = subdivide_scene(parse_scene(str(SCENES_DIR / "blob_box.xml")),
                                 levels=3)
    big_pack = pack_scene(big_parsed)
    big_host = BrickSet.from_pack(big_pack)
    scene_build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    big = big_host.to(dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    # what kernels B2, B3 and B6 read: built once per set and device, kept
    # with the set through every later .to(device)
    walk_table = big.walk_table()
    big_cam = Camera.from_parsed(big_parsed.camera)
    print(f"large scene: {big_pack.num_triangles} triangles, "
          f"{big.num_bricks} bricks, {big.num_top} top nodes, depth "
          f"{big.top_depth}; parse+subdivide+pack+SAH+bricks "
          f"{scene_build_s:.2f} s; upload {big.nbytes} bytes "
          f"(brick_data {big.brick_data.numel() * 4}) in {upload_s:.4f} s")
    print(f"walk table of kernels B2, B3 and B6: {walk_table.nbytes} bytes "
          f"({walk_table.nodes.numel() * 4} of node records, "
          f"{walk_table.tris.numel() * 4} of triangle test data) beside "
          f"{big.sub_boxes.numel() * 4} bytes of chunk gates, built on the "
          f"card in {walk_table.build_s * 1e3:.2f} ms (set-up); the node "
          f"records are read from global memory, not staged in shared "
          f"memory")
    cd = torch.from_numpy(camera_ray_data(big_cam, MAIN_W, MAIN_H)).to(dev)
    big_waves = capture_waves(big, cd, MAIN_W, MAIN_H, 2)
    if big_waves[0][0].x.numel() != MAIN_W * MAIN_H * SPP:
        raise SystemExit("chip_smoke: the captured primary wave is not the "
                         "main path's")
    b2_checks += compare_waves(big, big_waves, "blob_box x3")
    require_agreement("B2", b2_checks)
    b3_checks += compare_full(big, big_waves, "blob_box x3")
    require_agreement("B3", b3_checks)
    for engine in ENGINES:
        engine_checks[engine] += compare_engine(big, big_waves, "blob_box x3",
                                                engine)
        require_agreement(engine, engine_checks[engine])
    t0 = time.perf_counter()
    big_mx2 = MX2Set.from_pack(big_pack).to(dev)
    torch.cuda.synchronize()
    mx2_build_s = time.perf_counter() - t0
    print(f"large scene as an MX2Set: {big_mx2.num_bricks} superbricks, "
          f"{big_mx2.nbytes} bytes (coeff {big_mx2.coeff.numel() * 4}); "
          f"host build and upload {mx2_build_s:.2f} s")
    mx2_waves = capture_mx2_waves(big_mx2, cd, MAIN_W, MAIN_H, 2)
    if mx2_waves[0][0].x.numel() != MAIN_W * MAIN_H * SPP:
        raise SystemExit("chip_smoke: the captured mx2 primary wave is not "
                         "the main path's")
    b7_checks += compare_b7(big_mx2, big, mx2_waves, "blob_box x3")
    require_agreement("B7", b7_checks)
    wave_ms = {}
    for (org, dirn, tnear), mx2_wave, name in zip(big_waves, mx2_waves,
                                                  ("primary", "bounce 1")):
        # B2 and its plain version in turns, B3 between, B3's plain once
        runs = {"kernel": (lambda: wf.trace_bricks_cuda(big, *org, *dirn,
                                                        tnear), 20),
                "plain": (lambda: trace_bricks_plain(big, org, dirn, tnear),
                          1),
                "b3": (lambda: wf.trace_bricks_full_cuda(big, *org, *dirn,
                                                         tnear), 20),
                "b3_plain": (lambda: trace_bricks_full_plain(big, org, dirn,
                                                             tnear), 1)}
        timings = {f"{which}_ms": [] for which in runs}
        for which in ("plain", "kernel", "b3", "b3", "kernel", "plain",
                      "b3_plain"):
            fn, repeats = runs[which]
            timings[f"{which}_ms"].append(cuda_ms(fn, repeats))
        wave_ms[name] = dict(rays=int(org.x.numel()), timings=timings,
                             **{key: statistics.median(v)
                                for key, v in timings.items()})
        row = wave_ms[name]
        print(f"B2 timing blob_box x3 {MAIN_W}x{MAIN_H} {name} wave "
              f"({org.x.numel()} rays): kernel {row['kernel_ms']:.4f} ms "
              f"{timings['kernel_ms']}, plain {row['plain_ms']:.2f} ms "
              f"{timings['plain_ms']}")
        print(f"B3 timing blob_box x3 {MAIN_W}x{MAIN_H} {name} wave: kernel "
              f"{row['b3_ms']:.4f} ms {timings['b3_ms']} (B2 "
              f"{row['kernel_ms']:.4f} ms), plain {row['b3_plain_ms']:.2f} ms")

        # 3e, 3f: B4 and B5 in turns with B2; B5's lists (cull and sort in
        # torch ops) are made once and timed apart from the kernel
        lists = {engine: pt.visit_lists(big, org, dirn, tnear,
                                        wf.parse_engine(engine)[1])
                 for engine in ("pairs", "pairs8")}
        runs = {"b2": lambda: wf.trace_bricks_cuda(big, *org, *dirn, tnear),
                "slim2": lambda: wf.trace_bricks_slim2_cuda(big, *org, *dirn,
                                                            tnear)}
        for engine, (brk, ent, cnt) in lists.items():
            rows = wf.parse_engine(engine)[1]
            runs[engine] = (lambda brk=brk, ent=ent, cnt=cnt, rows=rows:
                            pt.trace_pairs_cuda(big, *org, *dirn, tnear, brk,
                                                ent, cnt, rows * pt.LANES))
            runs[engine + "_lists"] = (
                lambda rows=rows: pt.visit_lists(big, org, dirn, tnear, rows))
        # 3g: B7 likewise, over the superbrick lists of 128-ray packets, on
        # the "mx2" path's own wave (the same rays for the primary wave, a
        # "mort_oct"-sorted wave for the bounce), with B2 on those rays
        m_org, m_dirn, m_tnear = mx2_wave
        sb_lists = pt.visit_lists(big_mx2, m_org, m_dirn, m_tnear, 1)
        runs["mx2"] = lambda: mx2.trace_mx2_cuda(big_mx2, *m_org, *m_dirn,
                                                 m_tnear, *sb_lists)
        runs["mx2_lists"] = lambda: pt.visit_lists(big_mx2, m_org, m_dirn,
                                                   m_tnear, 1)
        runs["b2_mx2_wave"] = lambda: wf.trace_bricks_cuda(big, *m_org,
                                                           *m_dirn, m_tnear)
        timings = {which: [] for which in runs}
        for which in ("b2", "slim2", "pairs", "pairs8", "b2_mx2_wave", "mx2",
                      "pairs_lists", "pairs8_lists", "mx2_lists", "mx2",
                      "b2_mx2_wave", "pairs8", "pairs", "slim2", "b2"):
            timings[which].append(cuda_ms(runs[which], 10))
        row["engines"] = {which: statistics.median(v)
                          for which, v in timings.items()}
        row["engine_timings"] = timings
        row["pairs_per_packet"] = {
            engine: {"packets": int(cnt.numel()),
                     "mean": float(cnt.float().mean()), "max": int(cnt.max())}
            for engine, (_, _, cnt) in lists.items()}
        e = row["engines"]
        print(f"B4 timing blob_box x3 {MAIN_W}x{MAIN_H} {name} wave: kernel "
              f"{e['slim2']:.4f} ms {timings['slim2']} beside B2 "
              f"{e['b2']:.4f} ms {timings['b2']} in turns")
        for engine in ("pairs", "pairs8"):
            ppp = row["pairs_per_packet"][engine]
            print(f"B5 timing blob_box x3 {MAIN_W}x{MAIN_H} {name} wave, "
                  f"{engine}: kernel {e[engine]:.4f} ms {timings[engine]}, "
                  f"cull + sort {e[engine + '_lists']:.4f} ms; "
                  f"{ppp['packets']} packets, {ppp['mean']:.2f} pairs per "
                  f"packet (max {ppp['max']} of {big.num_bricks} bricks)")
        print(f"B7 timing blob_box x3 {MAIN_W}x{MAIN_H} {name} wave of the "
              f"mx2 path ({m_org.x.numel()} rays, sorted by mort_oct): kernel "
              f"{e['mx2']:.4f} ms {timings['mx2']} beside B2 on the same "
              f"rays {e['b2_mx2_wave']:.4f} ms {timings['b2_mx2_wave']} in "
              f"turns, cull + sort {e['mx2_lists']:.4f} ms")
        del lists, sb_lists, runs
    for engine in ENGINES:
        for check in engine_checks[engine]:
            if check["scene"] == "blob_box x3":
                wave_ms[check["wave"]][engine + "_plain_ms"] = \
                    check["plain_ms"]
                print(f"{engine} plain version blob_box x3 {check['wave']} "
                      f"wave: {check['plain_ms']:.2f} ms (one run)")
    for check in b7_checks:
        if check["scene"] == "blob_box x3":
            wave_ms[check["wave"]]["mx2_plain_ms"] = check["plain_ms"]
            print(f"B7 plain version blob_box x3 {check['wave']} wave: "
                  f"{check['plain_ms']:.2f} ms (one run)")
    del big_waves, mx2_waves
    b2_err = max(c["max_abs_err"] for c in b2_checks)
    b3_err = max(c["max_abs_err"] for c in b3_checks)

    # Bounds of the per-wave traces on the sorted first-bounce wave, the
    # wave their times are of.  Operations: what this wave's rays need, from
    # B3's per-ray counters on it (a box test per node popped and per gate
    # of each brick entered, 32 triangle tests per gate passed).  Bytes: the
    # scene as the kernel reads it once, the rays in (24 bytes each) and the
    # result out (8 bytes; B3's record 64).  B2, B3 and B6 read the walk
    # table and the chunk gates (B3 and B6 also the 128-byte record of each
    # hit's winner, what this wave's hits need); B4 and B5 the bricks and
    # the top tree.
    def walk_ops(counters):
        return ((counters["nodes"]["mean"] + 16 * counters["bricks"]["mean"])
                * BOX_OPS + counters["chunks"]["mean"] * 32 * TRI_OPS)

    big_counters = {c["wave"]: c["counters"] for c in b3_checks
                    if c["scene"] == "blob_box x3"}
    wave_rays = wave_ms["bounce 1"]["rays"]
    scene_bytes = (big.brick_data.numel() + big.top_boxes.numel()
                   + big.top_links.numel()) * 4
    walk_bytes = walk_table.nbytes + big.sub_boxes.numel() * 4
    wave_hits = next(c["hit_share"] for c in b3_checks
                     if c["scene"] == "blob_box x3"
                     and c["wave"] == "bounce 1") * wave_rays
    wave_ops = wave_rays * walk_ops(big_counters["bounce 1"])
    slim_bound = bound(walk_bytes + wave_rays * 32, wave_ops)
    full_bound = bound(walk_bytes + wave_hits * 128 + wave_rays * 88,
                       wave_ops)
    slim2_bound = bound(scene_bytes + wave_rays * 32, wave_ops)
    # B5 also reads its packets' lists (a brick id and a bound per pair)
    pair_bound = bound(
        scene_bytes + wave_rays * 32
        + 8 * wave_ms["bounce 1"]["pairs_per_packet"]["pairs"]["mean"]
        * wave_ms["bounce 1"]["pairs_per_packet"]["pairs"]["packets"],
        wave_ops)
    # B7 reads the slabs' rows that carry coefficients (mx2.FEATURES of a
    # sub's 16) and the sub boxes once, its packets' lists (a superbrick id
    # and a bound per listed entry) and the rays, and writes (t, slot).
    # Operations, from its counters on its own bounce wave: per ray a slab
    # test for each valid sub of a superbrick visited, and for each sub
    # voted in a product of depth mx2.FEATURES into 128 rows (FEATURES
    # multiplications and FEATURES - 1 additions a row).
    b7_wave = next(c for c in b7_checks if c["scene"] == "blob_box x3"
                   and c["wave"] == "bounce 1")
    b7_bound = bound(
        (big_mx2.num_bricks * 16 * mx2.FEATURES * 128
         + big_mx2.subbox.numel()) * 4
        + 8 * b7_wave["listed"] + b7_wave["rays"] * 32,
        128 * (b7_wave["tested"] * BOX_OPS
               + b7_wave["voted"] * (2 * mx2.FEATURES - 1) * 128))

    stamp("large-scene waves and timings done")
    # -- 3d. kernel B6 on the large scene: agreement at depth 4, and times
    # at the main path's shape
    b6_checks.append(compare_render(big, cd, MAIN_W, MAIN_H, 4, wave_check,
                                    "blob_box x3"))
    require_agreement("B6", b6_checks)
    b6_err = b6_checks[-1]["max_abs_err"]
    sample = [0]

    def b6_frame():
        sample[0] += SPP
        bk.render_samples_bricks(big, cd, MAIN_W, MAIN_H, sample[0], SPP)

    b6_timings = [cuda_ms(b6_frame, 5) for _ in range(3)]
    b6_ms = statistics.median(b6_timings)
    # the plain version costs tens of seconds: one run, by CUDA events
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    plain_img = bk.render_tiles_bricks_plain(
        big, cd, MAIN_W, MAIN_H, 0, bk.tile_grid(MAIN_W, MAIN_H), 0, SPP)
    stop.record()
    stop.synchronize()
    b6_plain_ms = start.elapsed_time(stop)
    deep = deep_check(bk.render_samples_bricks(big, cd, MAIN_W, MAIN_H, 0,
                                               SPP).cpu().numpy(),
                      plain_img.cpu().numpy())
    del plain_img
    print(f"B6 timing blob_box x3 {MAIN_W}x{MAIN_H} {SPP} spp depth 50: "
          f"kernel {b6_ms:.4f} ms {b6_timings}, plain {b6_plain_ms:.2f} ms "
          f"(one run); kernel vs that plain render, reported only: "
          f"mismatch share {deep['mismatch_share']:.3e}, mean abs err "
          f"{deep['mean_abs_err']:.3e} (statistical criterion "
          f"{'met' if deep['ok'] else 'not met'})")
    results.update(b2_waves=b2_checks, b2_renders=b2_renders,
                   b2_wave_ms=wave_ms, b3_waves=b3_checks,
                   b6_checks=b6_checks, b6_ms=b6_ms, b6_timings=b6_timings,
                   b6_plain_ms=b6_plain_ms, b6_depth50_vs_plain=deep,
                   large_scene_build_s=scene_build_s,
                   large_scene_upload_s=upload_s,
                   large_scene_bytes=big.nbytes,
                   brick_data_bytes=big.brick_data.numel() * 4,
                   walk_table_bytes=walk_table.nbytes,
                   walk_table_build_ms=walk_table.build_s * 1e3,
                   walk_nodes="global")

    counters = (mk.megakernel_cuda, wf.trace_bricks_cuda,
                wf.trace_bricks_full_cuda, bk.render_bricks_cuda,
                wf.trace_bricks_slim2_cuda, pt.trace_pairs_cuda,
                mx2.trace_mx2_cuda)

    def zero_counts():
        for wrapper in counters:
            wrapper.launches = 0

    stamp("3d done")
    # -- 4. the main path ---------------------------------------------------
    zero_counts()
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
    others = [w.launches for w in counters[1:]]
    if launches != warmup + frames or any(others):
        raise SystemExit(f"chip_smoke: {launches} kernel launches for "
                         f"{warmup + frames} frames, {others} launches of "
                         f"B2, B3, B6, B4, B5, B7")
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

    stamp("4 done")
    # -- 4b. the large-scene main path ----------------------------------------
    stats = {}
    wf.render_samples_wavefront(big, cd, MAIN_W, MAIN_H, 0, SPP, stats=stats)
    big_path_len = stats["rays"] / (MAIN_W * MAIN_H * SPP)
    # B6 walks every ray of the frame: the primary rays at the primary
    # wave's counters, the others at the first-bounce wave's; it reads the
    # scene once and writes the image
    frame_rays = MAIN_W * MAIN_H * SPP
    b6_bound = bound(
        walk_bytes + min(big.brick_data.numel() * 4, stats["rays"] * 128)
        + big.sph_rows.numel() * 4 + MAIN_W * MAIN_H * 12,
        frame_rays * walk_ops(big_counters["primary"])
        + (stats["rays"] - frame_rays) * walk_ops(big_counters["bounce 1"]))
    big_renderer = ProgressiveRenderer(big, big_cam, MAIN_W, MAIN_H,
                                       RenderConfig(), device="cuda")
    if big_renderer.mode != "wavefront":
        raise SystemExit(f"chip_smoke: large scene took {big_renderer.mode}")
    zero_counts()
    waves0 = big_renderer.waves
    warmup, big_frames = 2, 10
    for _ in range(warmup):
        big_renderer.step(sync=True)
    big_ms = []
    for _ in range(big_frames):
        big_renderer.step(sync=True)
        big_ms.append(big_renderer.frame_ms)
    b2_launches = wf.trace_bricks_cuda.launches
    waves = big_renderer.waves - waves0
    others = [w.launches for w in counters if w is not wf.trace_bricks_cuda]
    if b2_launches != waves or waves < warmup + big_frames or any(others):
        raise SystemExit(f"chip_smoke: {b2_launches} B2 launches for {waves} "
                         f"waves, {others} launches of B1, B3, B6, B4, B5, B7 on "
                         f"the large scene")
    big_median = statistics.median(big_ms)
    big_msamples = MAIN_W * MAIN_H * SPP / (big_median * 1e-3) / 1e6
    print(f"large main path {MAIN_W}x{MAIN_H} spf {SPP} depth 50: "
          f"{big_frames} synced frames, median {big_median:.4f} ms, max "
          f"{max(big_ms):.4f} ms (min {min(big_ms):.4f}), "
          f"{big_msamples:.4f} Msamples/s, "
          f"{big_msamples * big_path_len:.4f} Mrays/s, "
          f"{waves / (warmup + big_frames):.2f} waves per frame, avg path "
          f"length {big_path_len:.4f} rays/sample; B2 launches {b2_launches} "
          f"for {waves} waves; scene build {scene_build_s:.2f} s, "
          f"brick_data {big.brick_data.numel() * 4} bytes")
    big_img = big_renderer.hdr()
    if not (big_img.shape == (MAIN_H, MAIN_W, 3)
            and np.isfinite(big_img).all() and big_img.mean() > 0
            and big_img.std() > 0):
        raise SystemExit("chip_smoke: large-scene image is not finite and "
                         "non-flat")
    big_png = mk.BUILD_DIR / "chip_smoke_blob_box_x3.png"
    big_renderer.save_png(str(big_png))
    cam = big_renderer.camera
    big_renderer.set_camera(Camera((0.2,) + tuple(cam.lookfrom[1:]),
                                   cam.lookat, cam.up, cam.vfov))
    if big_renderer.sample_count != 0:
        raise SystemExit("chip_smoke: a camera move did not reset the large "
                         "scene")
    big_renderer.step()
    if big_renderer.sample_count != SPP \
            or not np.isfinite(big_renderer.hdr()).all():
        raise SystemExit("chip_smoke: large-scene step after the reset "
                         "failed")
    results.update(large_frame_ms=big_ms, large_median_frame_ms=big_median,
                   large_max_frame_ms=max(big_ms),
                   large_msamples_per_s=big_msamples,
                   large_waves_per_frame=waves / (warmup + big_frames),
                   large_avg_path_length=big_path_len,
                   b2_launches=b2_launches,
                   large_image_mean=float(big_img.mean()))
    del big_renderer

    stamp("4b done")
    # -- 4c. the large scene's "bricks" path (kernel B6), same shape --------
    bricks_config = RenderConfig(large_scene_mode="bricks")
    bricks_renderer = ProgressiveRenderer(big, big_cam, MAIN_W, MAIN_H,
                                          bricks_config, device="cuda")
    if bricks_renderer.mode != "bricks":
        raise SystemExit(f"chip_smoke: bricks mode took "
                         f"{bricks_renderer.mode}")
    zero_counts()
    for _ in range(warmup):
        bricks_renderer.step(sync=True)
    bricks_ms = []
    for _ in range(big_frames):
        bricks_renderer.step(sync=True)
        bricks_ms.append(bricks_renderer.frame_ms)
    b6_launches = bk.render_bricks_cuda.launches
    others = [w.launches for w in counters if w is not bk.render_bricks_cuda]
    if b6_launches != warmup + big_frames or any(others) \
            or bricks_renderer.waves != 0:
        raise SystemExit(f"chip_smoke: {b6_launches} B6 launches for "
                         f"{warmup + big_frames} frames, {others} launches "
                         f"of B1, B2, B3, B4, B5, B7 in bricks mode")
    bricks_median = statistics.median(bricks_ms)
    bricks_msamples = MAIN_W * MAIN_H * SPP / (bricks_median * 1e-3) / 1e6
    print(f"bricks path {MAIN_W}x{MAIN_H} spf {SPP} depth 50: {big_frames} "
          f"synced frames, median {bricks_median:.4f} ms, max "
          f"{max(bricks_ms):.4f} ms (min {min(bricks_ms):.4f}), "
          f"{bricks_msamples:.4f} Msamples/s; B6 launches {b6_launches}; "
          f"beside the wavefront's median {big_median:.4f} ms in this call "
          f"({big_median / bricks_median:.2f} times as long)")
    bricks_img = bricks_renderer.hdr()
    if not (bricks_img.shape == (MAIN_H, MAIN_W, 3)
            and np.isfinite(bricks_img).all() and bricks_img.mean() > 0
            and bricks_img.std() > 0):
        raise SystemExit("chip_smoke: bricks-mode image is not finite and "
                         "non-flat")
    bricks_png = mk.BUILD_DIR / "chip_smoke_blob_box_x3_bricks.png"
    bricks_renderer.save_png(str(bricks_png))
    cam = bricks_renderer.camera
    bricks_renderer.set_camera(Camera((0.2,) + tuple(cam.lookfrom[1:]),
                                      cam.lookat, cam.up, cam.vfov))
    if bricks_renderer.sample_count != 0:
        raise SystemExit("chip_smoke: a camera move did not reset bricks "
                         "mode")
    bricks_renderer.step()
    if bricks_renderer.sample_count != SPP \
            or not np.isfinite(bricks_renderer.hdr()).all():
        raise SystemExit("chip_smoke: bricks-mode step after the reset "
                         "failed")
    nee_mode = ProgressiveRenderer(
        big, big_cam, MAIN_W, MAIN_H,
        RenderConfig(large_scene_mode="bricks", enable_nee=True),
        device="cuda").mode
    if nee_mode != "wavefront":
        raise SystemExit(f"chip_smoke: bricks mode with NEE took {nee_mode}")
    results.update(bricks_frame_ms=bricks_ms,
                   bricks_median_frame_ms=bricks_median,
                   bricks_msamples_per_s=bricks_msamples,
                   b6_launches=b6_launches,
                   bricks_image_mean=float(bricks_img.mean()))
    del bricks_renderer

    stamp("4c done")
    # -- 4e, 4f, 4g. the large scene through the opt-in engines and through
    # "mx2", same shape
    def drive_engine(scene, config, mode, wrapper, kernel):
        """Drive ``scene`` through ProgressiveRenderer with ``config``,
        which must take ``mode`` and launch only ``wrapper``'s kernel, once
        per wave."""
        engine = config.wavefront_trace if mode == "wavefront" else mode
        renderer = ProgressiveRenderer(scene, big_cam, MAIN_W, MAIN_H, config,
                                       device="cuda")
        if renderer.mode != mode:
            raise SystemExit(f"chip_smoke: {engine} took {renderer.mode}")
        zero_counts()
        for _ in range(warmup):
            renderer.step(sync=True)
        ms = []
        for _ in range(big_frames):
            renderer.step(sync=True)
            ms.append(renderer.frame_ms)
        launches = wrapper.launches
        others = [w.launches for w in counters if w is not wrapper]
        if launches != renderer.waves or launches < warmup + big_frames \
                or any(others):
            raise SystemExit(f"chip_smoke: {launches} {kernel} launches for "
                             f"{renderer.waves} waves with {engine}, {others} "
                             f"launches of the other kernels")
        median = statistics.median(ms)
        img = renderer.hdr()
        if not (img.shape == (MAIN_H, MAIN_W, 3) and np.isfinite(img).all()
                and img.mean() > 0 and img.std() > 0):
            raise SystemExit(f"chip_smoke: the {engine} image is not finite "
                             f"and non-flat")
        # the same samples as 4b's image, through another engine
        against = deep_check(img, big_img)
        if not against["ok"]:
            raise SystemExit(f"chip_smoke: the {engine} image disagrees with "
                             f"the default engine's: {against}")
        print(f"{engine} path {MAIN_W}x{MAIN_H} spf {SPP} depth 50: "
              f"{big_frames} synced frames, median {median:.4f} ms, max "
              f"{max(ms):.4f} ms (min {min(ms):.4f}), "
              f"{MAIN_W * MAIN_H * SPP / (median * 1e-3) / 1e6:.4f} "
              f"Msamples/s, {renderer.waves / (warmup + big_frames):.2f} "
              f"waves per frame; {kernel} launches {launches} for "
              f"{renderer.waves} waves, no launch of another kernel; "
              f"against the default engine's image after "
              f"{renderer.sample_count} spp: mismatch "
              f"share {against['mismatch_share']:.3e}, mean abs err "
              f"{against['mean_abs_err']:.3e}; beside the default engine's "
              f"median {big_median:.4f} ms in this call "
              f"({median / big_median:.2f} times as long) and bricks mode's "
              f"{bricks_median:.4f} ms")
        path = mk.BUILD_DIR / f"chip_smoke_blob_box_x3_{engine}.png"
        renderer.save_png(str(path))
        cam = renderer.camera
        renderer.set_camera(Camera((0.2,) + tuple(cam.lookfrom[1:]),
                                   cam.lookat, cam.up, cam.vfov))
        if renderer.sample_count != 0:
            raise SystemExit(f"chip_smoke: a camera move did not reset "
                             f"{engine}")
        renderer.step()
        if renderer.sample_count != SPP \
                or not np.isfinite(renderer.hdr()).all():
            raise SystemExit(f"chip_smoke: the {engine} step after the reset "
                             f"failed")
        results[f"{engine}_path"] = {
            "frame_ms": ms, "median_frame_ms": median, "launches": launches,
            "waves": renderer.waves, "image_mean": float(img.mean()),
            "vs_default_engine": against}
        return launches, path

    b4_launches, slim2_png = drive_engine(
        big, RenderConfig(wavefront_trace="slim2"), "wavefront",
        wf.trace_bricks_slim2_cuda, "B4")
    b5_launches, pairs_png = drive_engine(
        big, RenderConfig(wavefront_trace="pairs"), "wavefront",
        pt.trace_pairs_cuda, "B5")
    del big_mx2
    b7_launches, mx2_png = drive_engine(
        big_pack, RenderConfig(large_scene_mode="mx2"), "mx2",
        mx2.trace_mx2_cuda, "B7")
    results.update(engine_checks=engine_checks,
                   engine_render_checks=engine_render_checks,
                   b7_checks=b7_checks, b7_renders=b7_renders,
                   mx_render_checks=mx_render_checks)

    stamp("4e-4g done")
    # -- 4h. the "mx" path (torch ops, no kernel), one frame at depth 4 -----
    mx_depth = 4
    mx_renderer = ProgressiveRenderer(
        big_pack, big_cam, MAIN_W, MAIN_H,
        RenderConfig(large_scene_mode="mx", max_depth=mx_depth),
        device="cuda")
    if mx_renderer.mode != "mx":
        raise SystemExit(f"chip_smoke: mx mode took {mx_renderer.mode}")
    zero_counts()
    mx_renderer.step(sync=True)
    mx_frame_ms = mx_renderer.frame_ms
    if any(w.launches for w in counters):
        raise SystemExit("chip_smoke: the mx path launched a kernel: "
                         f"{[w.launches for w in counters]}")
    mx_img = mx_renderer.hdr()
    wf_img = (wf.render_samples_wavefront(big, cd, MAIN_W, MAIN_H, 0, SPP,
                                          max_depth=mx_depth) / SPP)
    against = deep_check(mx_img, wf_img.cpu().numpy())
    if not (np.isfinite(mx_img).all() and mx_img.mean() > 0
            and mx_img.std() > 0 and against["ok"]):
        raise SystemExit(f"chip_smoke: the mx image is not finite and "
                         f"non-flat or disagrees with the wavefront's: "
                         f"{against}")
    mx_rounds = mx_renderer.stats["rounds"]
    mx_products = mx_renderer.stats["products"]
    mx_png = mk.BUILD_DIR / "chip_smoke_blob_box_x3_mx.png"
    mx_renderer.save_png(str(mx_png))
    print(f"mx path {MAIN_W}x{MAIN_H} spf {SPP} at depth {mx_depth}, not 50 "
          f"(a depth-50 frame traces these waves and 15 more): one synced "
          f"frame {mx_frame_ms:.1f} ms, "
          f"{mx_renderer.waves} waves of at most "
          f"{mxtrace.MX_MAX_RAYS_PER_WAVE} rays in "
          f"{mx_renderer.scene.num_bricks} bricks, "
          f"{mx_rounds / mx_renderer.waves:.1f} rounds per wave and "
          f"{mx_products} products of a packet with a brick in all, no "
          f"kernel launch; "
          f"against the wavefront's image at that depth: mismatch share "
          f"{against['mismatch_share']:.3e}, mean abs err "
          f"{against['mean_abs_err']:.3e}; beside the default engine's "
          f"depth-50 median {big_median:.4f} ms")
    results["mx_path"] = {"depth": mx_depth, "frame_ms": mx_frame_ms,
                          "waves": mx_renderer.waves,
                          "rays": mx_renderer.stats["rays"],
                          "rounds": mx_rounds, "products": mx_products,
                          "bricks": mx_renderer.scene.num_bricks,
                          "vs_wavefront": against}
    del big, mx_renderer

    stamp("4h done")
    # -- 4d. the kernel-stats entry point (kernel B3) ----------------------
    zero_counts()
    if kernel_stats.main(["--out", args.out] if args.out else []) != 0:
        raise SystemExit("chip_smoke: kernel_stats failed")
    b3_launches = wf.trace_bricks_full_cuda.launches
    if b3_launches == 0 or mk.megakernel_cuda.launches \
            or bk.render_bricks_cuda.launches:
        raise SystemExit(f"chip_smoke: kernel_stats launched B3 "
                         f"{b3_launches} times")
    print(f"kernel_stats: B3 launches {b3_launches}")
    results.update(b3_launches=b3_launches)

    stamp("4d done")
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
        for path in (png, big_png, bricks_png, slim2_png, pairs_png, mx2_png,
                     mx_png, cli_png):
            shutil.copy(path, out / path.name)
        (out / "chip_smoke_results.json").write_text(
            json.dumps(results, indent=1))

    root = Path(__file__).resolve().parent
    print(json.dumps({"kernels": [{
        "name": "megakernel",
        "route": "cuda",
        "source": str(mk.SOURCE.resolve().relative_to(root)),
        "replaces": "pathtracer_cuda_interactive_tpu/ops/megakernel.py:440",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        **b1_bound,
        "library_ms": None,
    }, {
        # times: one sorted first-bounce wave of the large main path
        "name": "brick_trace",
        "route": "cuda",
        "source": str(wf.SOURCE.resolve().relative_to(root)),
        "replaces": "pathtracer_cuda_interactive_tpu/ops/wavefront.py:115",
        "launches": b2_launches,
        "max_abs_err": b2_err,
        "ms": wave_ms["bounce 1"]["kernel_ms"],
        "plain_ms": wave_ms["bounce 1"]["plain_ms"],
        **slim_bound,
        "library_ms": None,
    }, {
        # launches: the kernel-stats entry point; times: the same wave as
        # brick_trace's
        "name": "brick_trace_full",
        "route": "cuda",
        "source": str(wf.SOURCE.resolve().relative_to(root)),
        "replaces": "pathtracer_cuda_interactive_tpu/ops/wavefront.py:77",
        "launches": b3_launches,
        "max_abs_err": b3_err,
        "ms": wave_ms["bounce 1"]["b3_ms"],
        "plain_ms": wave_ms["bounce 1"]["b3_plain_ms"],
        **full_bound,
        "library_ms": None,
    }, {
        # times: one 640x480, 2-spp, depth-50 frame of the large scene
        "name": "brick_render",
        "route": "cuda",
        "source": str(bk.SOURCE.resolve().relative_to(root)),
        "replaces": "pathtracer_cuda_interactive_tpu/ops/brickkernel.py:559",
        "launches": b6_launches,
        "max_abs_err": b6_err,
        "ms": b6_ms,
        "plain_ms": b6_plain_ms,
        **b6_bound,
        "library_ms": None,
    }, {
        # launches: the "slim2" path (4e); times: the same wave as
        # brick_trace's
        "name": "brick_trace_slim2",
        "route": "cuda",
        "source": str(wf.SLIM2_SOURCE.resolve().relative_to(root)),
        "replaces": "pathtracer_cuda_interactive_tpu/ops/wavefront.py:142",
        "launches": b4_launches,
        "max_abs_err": max(c["max_abs_err"] for c in engine_checks["slim2"]),
        "ms": wave_ms["bounce 1"]["engines"]["slim2"],
        "plain_ms": wave_ms["bounce 1"]["slim2_plain_ms"],
        **slim2_bound,
        "library_ms": None,
    }, {
        # launches: the "pairs" path (4f); times: the same wave, 32-row
        # packets, the kernel alone (lists_ms: the cull and sort before it)
        "name": "pair_trace",
        "route": "cuda",
        "source": str(pt.SOURCE.resolve().relative_to(root)),
        "replaces": "pathtracer_cuda_interactive_tpu/ops/pairtrace.py:151",
        "launches": b5_launches,
        "max_abs_err": max(c["max_abs_err"] for c in engine_checks["pairs"]
                           + engine_checks["pairs8"]),
        "ms": wave_ms["bounce 1"]["engines"]["pairs"],
        "lists_ms": wave_ms["bounce 1"]["engines"]["pairs_lists"],
        "plain_ms": wave_ms["bounce 1"]["pairs_plain_ms"],
        **pair_bound,
        "library_ms": None,
    }, {
        # launches: the "mx2" path (4g); times: that path's sorted
        # first-bounce wave ("mort_oct") in packets of 128 rays, the kernel
        # alone (lists_ms: the cull and sort before
        # it).  No one PyTorch call computes the function: a batched product
        # would be one step of it, without the lists, votes and tie rules.
        "name": "mx2_trace",
        "route": "cuda",
        "source": str(mx2.SOURCE.resolve().relative_to(root)),
        "replaces": "pathtracer_cuda_interactive_tpu/experiments/mx2.py:69",
        "launches": b7_launches,
        "max_abs_err": max(c["max_abs_err"] for c in b7_checks),
        "ms": wave_ms["bounce 1"]["engines"]["mx2"],
        "lists_ms": wave_ms["bounce 1"]["engines"]["mx2_lists"],
        "plain_ms": wave_ms["bounce 1"]["mx2_plain_ms"],
        **b7_bound,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
