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
2f. the build of csrc/wave_step.cu (the wavefront's bounce step: W1 the hit
   record, W2 the shading with its first half, the shadow rays, and W3 the
   sort key), the seventh source of the same parallel build;
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
   (statistical), NEE off and on; the same renders through W1-W3 against
   the same loop through their plain versions (ops/wave_step.py::
   PLAIN_STEPS), and one with every plain version of the bounce step made
   to raise; then the large scene is built (blob_box
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
   2 samples, depth 50) by CUDA events, its plain version once; that
   frame's image bit for bit the one B6 rendered before its bounce moved
   into csrc/bounce.cuh (a digest);
3i. the bounce step's kernels against their plain versions on every call
   of a 640x480, 2-sample render of the large scene (depth 50; and with NEE
   at depth 4): W1, W3 and the shadow rays bit for bit on every ray, W2's
   states, pixels, samples and live flags bit for bit and its floats within
   rtol 1e-4 on all but 1e-4 of the rays; each timed, with its plain
   version, on the primary and the sorted first-bounce wave;
3j. the main path's wave loop in its counted schedule (ops/wavefront.py::
   _ChunkWaves through a kept WaveCache, the wavefront's defaults at
   640x480, 2 samples, depth 50): two frames, the first capturing its CUDA
   graphs and the second replaying them alone, the drain engaged in each,
   each image and its waves and rays equal bit for bit to 3i's frame
   through the uncounted schedule (no cache kept), each
   graph holding one launch of B2, W1, W2 and W3 a wave and the drain's
   graph one launch of the drain, and a group captured for the chunk's
   full width alone (``wavefront._drains``: a read drains where its live
   paths fit GROUP_WAVES rounds of the drain's resident lanes, or where
   its group would run past the roulette's start); then B2 and W1-W3
   in their counted form (a device-side live count, ``ctl``) on the sorted
   first-bounce wave and on the first wave with fewer rays than the chunk,
   each laid in its capacity class: the live columns bit for bit the
   plain launch's, W3's keys past them INT32_MAX, each timed beside the
   plain launch;
3k. the drain (csrc/wave_step.cu::wave_drain) on the carried table of
   that frame at the first host read the rule drains: the radiance and
   the control block bit for bit ``drain_plain`` through the wave's own
   kernels (B2, W1, W2, level by level), the fully plain ``drain_plain``
   within W2's criterion (rtol 1e-4) on all but 1e-3 of the drained
   paths, and its largest difference; the kernel timed by CUDA events
   beside its bound and the plain version's time;
3e. kernel B4 (B2's walk with the deferred leaf, engine "slim2") on the
   four waves of 3b: t and slot equal to its plain version over the walk
   table and to kernel B2 bit for bit; whole wavefront renders at 160x120
   with trace="slim2", depth 4 (shallow) and 12 (statistical), NEE off and
   on; B4, B2 (in turns) and plain B4 timed on the large scene's waves;
3f. kernel B5 (the pair lists, engines "pairs" and "pairs8") likewise:
   t and slot equal to its plain version with the kernel's early votes
   bit for bit, and its four counters (pairs listed, skipped by the entry
   bound, chunks tested, visits ended at the brick's box) equal to that
   walk's; against B2 t bit for bit on every ray and slot on all but 1e-4;
   the renders; timed, with the pairs per packet, and the cull and sort
   (torch ops) timed apart from the kernel;
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
   sorted wavefront) — 10 synced frames after warmup with every plain
   version of the bounce step made to raise (the counted schedule, its
   graphs captured in warmup), B2's, W1's, W2's and W3's launches over
   the timed frames each one a primary graph replayed and GROUP_WAVES a
   group, the drain's one a drain replayed, the waves traced outside the
   drain no more than the first and at most GROUP_WAVES - 1 fewer a frame
   that did not drain, a camera reset, a finite non-flat image and a
   PNG;
4c. the large scene's "bricks" path in the same call:
   ProgressiveRenderer with RenderConfig(large_scene_mode="bricks") at the
   same shape — 10 synced frames after warmup, one B6 launch per frame and
   no B2 or bounce-step launch, a camera reset, a finite non-flat image and
   a PNG, NEE rerouted to the wavefront, the median frame beside 4b's;
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
   scene's bricks), no trace kernel launch (W2 and W3 on its waves), a
   finite non-flat image that meets
   the statistical criterion against the wavefront's at that depth;
4i. the tile and sample split (parallel/sharding.py) in a world of one
   rank, an nccl process group on this card: render_samples_sharded at 2
   spp, depth 50, against the unsharded function in the same call — "xla"
   on the rect Cornell box at 160x120 and "megakernel" at 640x480, on the
   large scene at 640x480 "bricks", "wavefront" with "slim", "slim2" and
   "pairs", and "mx2", and "mx" at 64x48, depth 4 — each image equal bit
   for bit, the launch counters equal to the unsharded frame's with the
   mode's kernel launched, and 5 synced frames of each in turns (1 of
   "mx"); then the same cases in two gloo worlds of spawned processes
   sharing this card with CUDA tensors, 2 ranks (two tile shards) and 4
   ranks (two tile shards by two sample shards), with "megakernel" and
   "bricks" also at 3 spp (the second sample shard renders 1 of its 2
   passes): every rank's image the
   same, equal bit for bit to the unsharded frame where a pixel's
   arithmetic is the same ("xla", "megakernel", "bricks") and within the
   wave paths' criterion otherwise, each rank launching its mode's kernel
   and no other, and one make_sharded_loss_and_grad step on
   scenes/pointlight.xml at 64x48 against loss_and_grad on the card; no
   multi-card number can be measured on one card;
4j. gradients on the card (grad/inverse.py): loss_and_grad on
   scenes/pointlight.xml at 64x48, 2 spp, 3 bounces against the CPU's
   (rtol 1e-3, atol 1e-6), no kernel launch, then one synced step at
   640x480, 2 spp, 6 bounces with its peak memory;
4k. the viewer (viewer/server.py): a Viewer on port 0 over
   ProgressiveRenderer on the rect Cornell box at 640x480 (kernel B1), then
   on the large scene's set in bricks mode (B6): the page, an orbit drag,
   /state until the camera moved and the sample count restarted, /frame a
   non-flat PNG of 640x480, the loop's FPS over 3 s beside the synced frame
   of phase 4 (4c), the wall time of 10 /frame requests while the loop runs
   (and of 10 reads through render_lock alone, the JAX viewer's read), the
   path's kernel launched and no other;
4l. the port's bench (bench.py --rows cbox,bunny) in a subprocess: exit 0
   and one JSON line with bench.py's keys, every rate and time positive,
   echoed;
4m. entry.entry() on cuda (a finite 160x120 image), print_scene on the
   rect Cornell box, and the native host builders (models/native.py): the
   large scene's pack (BVH) and brick set (SAH treelets) bit for bit those
   of the numpy builders, both timed;
5. the offline CLI on cuda.

The wave paths (4b, 4e-4h) launch W2 and W3 on every wave (W1 on the
brick engines' waves; 4b also on the dead waves that end a chunk's last
group), and the other paths none of them.

Its last two lines are a JSON object describing each kernel (with its
bound: the larger of the bytes the function must move over the card's
memory rate and the operations this run's data need over its FP32 rate)
and then {"ok": true, "device": {...}}.  Lines of the form ``[123.4 s]
phase`` give the seconds since the start at the end of each phase.
``--out DIR`` also writes the PNGs and a results JSON into DIR.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
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


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the FP32 rate (the benchmark's
    peaks, torrey_bench/roofline.py), in ms."""
    from torrey_bench.roofline import PEAK_BYTES_PER_S, PEAK_FP32_OPS
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


# float32 operations per ray of the bounce step's kernels, counted from
# csrc/wave_step.cu (the RNG's integer steps not counted): W1's (u, v) solve
# (two cross products, three dot products, two divisions) and triangle
# record (position, interpolated normal), and a sphere test with its record
# per resident sphere; W2's bounce (normalize, the BSDF's frame, sampled
# direction and evaluation, the throughput and roulette); a shadow ray's
# direction and distance per light; W3's "sig_mort" key adds a slab test
# (BOX_OPS) per coarse box to the Morton code's 21.
W1_OPS, SPHERE_OPS, W2_OPS, LIGHT_OPS, MORTON_OPS = 70, 50, 160, 14, 21


def wave_step_wrappers() -> tuple:
    """The bounce step's kernel wrappers (ops/wave_step.py), each counting
    its launches in ``launches``: W1, W2, W3 and W2's first half, the
    shadow rays."""
    from pathtracer_cuda_interactive_tpu_torch.ops import wave_step as ws
    return (ws.wave_record_cuda, ws.wave_shade_cuda, ws.wave_sort_key_cuda,
            ws.wave_shadow_rays_cuda)


def hold_wave_steps(log, label: str) -> list:
    """Each call of the bounce step that a render logged
    (ops/wave_step.py::recording_steps), through its kernel and through its
    plain version on the same inputs: W1 ("record"), W3 ("key") and the
    shadow rays bit for bit on every ray; W2 ("shade") its state, pixel,
    sample and live rows bit for bit on every ray and its floats (the new
    table's 12 float rows, and the radiance written where a path ended)
    within rtol 1e-4 on all but 1e-4 of the rays (the ulps of cosf, sinf
    and powf).  A key belongs to the wave it orders."""
    from pathtracer_cuda_interactive_tpu_torch.ops import wave_step as ws
    out, wave = [], 0
    for name, args in log:
        if name == "shade":
            got_out, ref_out = args[6].clone(), args[6].clone()
            got = ws.wave_shade_cuda(*args[:6], got_out, *args[7:])
            ref = ws.shade_plain(*args[:6], ref_out, *args[7:])
            _, pix, samp = ws.int_rows(ref)
            at = lambda o: o[samp.long(), pix.long()].T
            g = torch.cat([got[:12], at(got_out)])
            r = torch.cat([ref[:12], at(ref_out)])
            same_ints = torch.equal(got[12:].view(torch.int32),
                                    ref[12:].view(torch.int32))
            share = float((~torch.isclose(g, r, rtol=1e-4, atol=1e-6)
                           .all(0)).float().mean())
            ok = same_ints and share <= 1e-4
        else:
            got = getattr(ws.STEPS, name)(*args)
            ref = getattr(ws.PLAIN_STEPS, name)(*args)
            n = int(got.shape[-1])
            g, r = got.reshape(-1, n), ref.reshape(-1, n)
            share = float((g.view(torch.int32) != r.view(torch.int32))
                          .any(0).float().mean())
            ok = share == 0.0
        torch.cuda.synchronize()
        g, r = g.double(), r.double()
        both = torch.isfinite(g) & torch.isfinite(r)
        err = float((g - r).abs()[both].max()) if both.any() else 0.0
        out.append({"kernel": name, "scene": label, "wave": wave,
                    "rays": int(g.shape[-1]), "ok": bool(ok),
                    "mismatch_share": share, "max_abs_err": err})
        if name == "shade":
            wave += 1
    return out


@contextlib.contextmanager
def plain_versions_refused():
    """While it lasts, every plain version of the bounce step
    (ops/wave_step.py) raises: a render on the card inside runs none of
    their torch ops."""
    from pathtracer_cuda_interactive_tpu_torch.ops import wave_step as ws
    names = ("_record_from_slots", "_shade", "_nee_term", "_sig_key",
             "_sort_key", "_sphere_tmin", "_light_dir", "record_plain",
             "shade_plain", "sort_key_plain", "shadow_rays_plain")
    saved = {name: getattr(ws, name) for name in names}

    def refuse(*args, **kwargs):
        raise SystemExit("chip_smoke: a plain version of the bounce step "
                         "ran on the card's path")

    try:
        for name in names:
            setattr(ws, name, refuse)
        yield
    finally:
        for name, fn in saved.items():
            setattr(ws, name, fn)


def kernel_wrappers() -> tuple:
    """The seven kernels' wrappers, each counting its launches in
    ``launches``: B1, B2, B3, B6, B4, B5, B7."""
    from pathtracer_cuda_interactive_tpu_torch.experiments import mx2
    from pathtracer_cuda_interactive_tpu_torch.ops import brickkernel as bk
    from pathtracer_cuda_interactive_tpu_torch.ops import megakernel as mk
    from pathtracer_cuda_interactive_tpu_torch.ops import pairtrace as pt
    from pathtracer_cuda_interactive_tpu_torch.ops import wavefront as wf

    return (mk.megakernel_cuda, wf.trace_bricks_cuda,
            wf.trace_bricks_full_cuda, bk.render_bricks_cuda,
            wf.trace_bricks_slim2_cuda, pt.trace_pairs_cuda,
            mx2.trace_mx2_cuda)


# The digest (sha256 of the float32 bytes) of B6's 640x480, 2-sample,
# depth-50 frame of the large scene (phase 3d): the image B6 rendered before
# its bounce moved into csrc/bounce.cuh, on an NVIDIA H100 80GB HBM3.  A
# change that moves B6's bits on purpose updates it.
B6_DIGEST = "8540fd4481f1990d92004613fc24321c02a11801258b9472e734a195c5ed38ed"

GRAD_W, GRAD_H, GRAD_BOUNCES = 64, 48, 3


def grad_inputs(width, height, device):
    """scenes/pointlight.xml on ``device``: (scene, camera data, the pixel
    grid, the parameters)."""
    from pathtracer_cuda_interactive_tpu_torch import SCENES_DIR
    from pathtracer_cuda_interactive_tpu_torch.grad import inverse as inv
    from pathtracer_cuda_interactive_tpu_torch.models.device_scene import (
        DeviceScene)
    from pathtracer_cuda_interactive_tpu_torch.models.scenepack import (
        load_scene)
    from pathtracer_cuda_interactive_tpu_torch.ops.camera import (
        Camera, camera_ray_data)
    from pathtracer_cuda_interactive_tpu_torch.parallel.sharding import (
        _padded_grid)

    pack, parsed = load_scene(str(SCENES_DIR / "pointlight.xml"))
    scene = DeviceScene.from_pack(pack).to(device)
    cd = torch.as_tensor(camera_ray_data(Camera.from_parsed(parsed.camera),
                                         width, height), device=device)
    pix = torch.as_tensor(_padded_grid(width, height, 1)[0], device=device)
    params, _ = inv.split_params(scene)
    return scene, cd, pix, params


def grad_target(scene, cd, pix, params, width, height, spp, bounces):
    """The target grid: the render with half the red albedo, same RNG."""
    from pathtracer_cuda_interactive_tpu_torch.grad import inverse as inv

    return inv.render_pixels_diff(
        inv.merge_params(scene, dict(params, mat_r=params["mat_r"] * 0.5)),
        cd, pix, width, height, 0, spp, num_bounces=bounces) / spp


# the gloo worlds phase 4i starts on this one card: (ranks,
# sample_parallel) — two tile shards, and two tile by two sample shards
CARD_WORLDS = ((2, 1), (4, 2))


def world_rank(rank, world_size, sample_parallel, sets_file, cases):
    """One rank of a gloo world on card 0 (phase 4i).  ``sets_file`` holds
    the scenes and camera data on the host by name; per case ``(label,
    scene name, camera name, width, height, mode, kwargs, samples)`` it
    renders the sharded frame with the launch counters zeroed just before
    and read just after; then one sharded gradient step beside loss_and_grad on the card.
    Returns the images and gradients on the host, the devices they were
    computed on and the counts."""
    from pathtracer_cuda_interactive_tpu_torch.grad import inverse as inv
    from pathtracer_cuda_interactive_tpu_torch.parallel import sharding as sh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    counters = kernel_wrappers()
    held = torch.load(sets_file, weights_only=False)
    mesh = sh.make_mesh(sample_parallel=sample_parallel, device=dev)
    mesh.all_reduce(torch.zeros(1, device=dev))
    on_card = {}
    out = {"coords": (mesh.s_idx, mesh.t_idx), "frames": {}}
    for (label, scene_name, cam_name, width, height, mode, kwargs,
         spp) in cases:
        for name in (scene_name, cam_name):
            if name not in on_card:
                on_card[name] = sh.replicate_scene(held[name], mesh)
        for wrapper in counters:
            wrapper.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = sh.render_samples_sharded(
            on_card[scene_name], on_card[cam_name], width, height, 0, spp,
            mesh, mode=mode, **kwargs)
        torch.cuda.synchronize()
        out["frames"][label] = {
            "image": img.cpu(), "device": str(img.device),
            "launches": [w.launches for w in counters],
            "ms": (time.perf_counter() - t0) * 1e3}
    del on_card, held
    W, H = GRAD_W, GRAD_H
    scene, cd, pix, params = grad_inputs(W, H, dev)
    target = grad_target(scene, cd, pix, params, W, H, SPP, GRAD_BOUNCES)
    loss1, grads1 = inv.loss_and_grad(params, scene, cd, target, pix < W * H,
                                      pix, W, H, 0, SPP,
                                      num_bounces=GRAD_BOUNCES)
    img = target.reshape(-1, 3)[:W * H].reshape(H, W, 3)
    pix_m, tgt_m, valid_m = inv.shard_grid_inputs(mesh, img)
    step = inv.make_sharded_loss_and_grad(mesh, W, H, SPP,
                                          num_bounces=GRAD_BOUNCES)
    loss_n, grads_n = step(params, sh.replicate_scene(scene, mesh), cd,
                           tgt_m, valid_m, pix_m, 0)
    out["grad"] = {
        "devices": sorted({str(t.device) for t in
                           [loss_n, *grads_n.values()]}),
        "single": (float(loss1), {k: g.cpu() for k, g in grads1.items()}),
        "sharded": (float(loss_n), {k: g.cpu() for k, g in grads_n.items()})}
    return out


def card_worlds(sets: dict, cases, refs: dict, counters) -> list:
    """Phase 4i, second part: ``cases`` (see world_rank, plus the index of
    the mode's kernel in ``counters`` or None) in each world of
    CARD_WORLDS, gloo processes sharing this card; each image against the
    unsharded frame ``refs[label]``.  Returns a row per world and case."""
    import tempfile

    from pathtracer_cuda_interactive_tpu_torch.parallel.world import (
        run_world)

    rows = []
    with tempfile.TemporaryDirectory() as work:
        sets_file = Path(work) / "sets.pt"
        torch.save(sets, sets_file)
        for ranks, sp in CARD_WORLDS:
            name = f"{ranks} ranks, sample_parallel {sp}"
            t0 = time.perf_counter()
            per_rank = run_world(world_rank, ranks,
                                 Path(work) / f"world{ranks}x{sp}",
                                 args=(sp, str(sets_file),
                                       [c[:-1] for c in cases]),
                                 timeout=400)
            world_s = time.perf_counter() - t0
            for label, *_, mode, _kwargs, _spp, kernel in cases:
                frames = [r["frames"][label] for r in per_rank]
                got = frames[0]["image"]
                same = all(torch.equal(f["image"], got) for f in frames)
                on_card = all(f["device"] == "cuda:0" for f in frames)
                ref = refs[label]
                exact = torch.equal(got, ref)
                if mode in ("xla", "plain", "megakernel", "bricks"):
                    check = {"criterion": "bit for bit", "ok": exact}
                elif mode == "mx":
                    check = mx_check(got.numpy(), ref.numpy())
                else:
                    check = wave_check(got.numpy(), ref.numpy())
                counts = [f["launches"] for f in frames]
                counted = all(
                    all(n == 0 for i, n in enumerate(c) if i != kernel)
                    and (kernel is None or c[kernel] > 0) for c in counts)
                if not (same and on_card and check["ok"] and counted):
                    raise SystemExit(
                        f"chip_smoke: {label} in a world of {name}: every "
                        f"rank's image the same {same}, on cuda:0 "
                        f"{on_card}, against the unsharded frame {check}, "
                        f"launches per rank {counts}")
                print(f"sharded {label}, gloo world of {name} on this card: "
                      f"every rank's image the same, "
                      f"{'equal bit for bit to' if exact else 'within ' + check['criterion'] + ' of'} "
                      f"the unsharded frame (max abs err "
                      f"{float((got - ref).abs().max()):.3e}); launches per "
                      f"rank {counts} (B1, B2, B3, B6, B4, B5, B7); frame "
                      f"per rank {[round(f['ms'], 4) for f in frames]} ms "
                      f"(ranks time-slice the card)")
                rows.append({"world": [ranks, sp], "case": label,
                             "mode": mode, "bit_for_bit": exact,
                             "check": check, "launches": counts,
                             "rank_ms": [f["ms"] for f in frames]})
            rtol, atol = 2e-4, 1e-6
            for r, res in enumerate(per_rank):
                g = res["grad"]
                loss1, grads1 = g["single"]
                loss_n, grads_n = g["sharded"]
                close = abs(loss_n - loss1) <= 1e-4 * abs(loss1) and all(
                    torch.isfinite(grads_n[k]).all() and torch.allclose(
                        grads_n[k], grads1[k], rtol=rtol, atol=atol)
                    for k in grads1)
                if not close or g["devices"] != ["cuda:0"]:
                    raise SystemExit(
                        f"chip_smoke: sharded gradient step, rank {r} of "
                        f"{name}: loss {loss_n} against {loss1}, on "
                        f"{g['devices']}, gradients {grads_n} against "
                        f"{grads1}")
            worst = max(float((res["grad"]["sharded"][1][k]
                               - res["grad"]["single"][1][k]).abs().max())
                        for res in per_rank for k in res["grad"]["single"][1]
                        if res["grad"]["single"][1][k].numel())
            print(f"sharded gradient step, gloo world of {name} on this "
                  f"card, pointlight {GRAD_W}x{GRAD_H} spp {SPP} "
                  f"{GRAD_BOUNCES} bounces: every rank's loss within rtol "
                  f"1e-4 and gradients within rtol {rtol}, atol {atol} of "
                  f"loss_and_grad on the card (max abs err {worst:.3e}); "
                  f"world {world_s:.1f} s with its start")
            rows.append({"world": [ranks, sp], "case": "gradient step",
                         "grad_max_abs_err": worst,
                         "loss": per_rank[0]["grad"]["sharded"][0],
                         "single_loss": per_rank[0]["grad"]["single"][0],
                         "world_s": world_s})
    return rows


def synced_ms(fn) -> float:
    """Host milliseconds of ``fn()`` from a synced start to a synced end."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def sharded_phase(cases, counters) -> dict:
    """Phase 4i: render_samples_sharded in a world of one rank (an nccl
    process group on this card) against the unsharded function, per case
    ``(label, scene, cam, width, height, mode, kwargs, unsharded, kernel,
    repeats)``: the images equal bit for bit, the launch counters (zeroed
    just before each of the two frames, read just after) equal,
    ``kernel``'s nonzero (None: no kernel launched at all); those two
    synced frames and ``repeats`` more of each, in turns, are timed.
    Returns the rows and each counter's launches over the counted sharded
    frames, and the unsharded frames on the host by label."""
    import socket

    import torch.distributed as dist

    from pathtracer_cuda_interactive_tpu_torch.parallel import sharding as sh

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    rows, sharded_launches, refs = [], [0] * len(counters), {}
    try:
        mesh = sh.make_mesh()
        if not (mesh.collective and mesh.world_size == 1
                and mesh.device.type == "cuda"):
            raise SystemExit(f"chip_smoke: the one-rank mesh is {mesh}")
        # the communicator is set up at the first collective, not in a frame
        mesh.all_reduce(torch.zeros(1, device=mesh.device))

        def counted(fn):
            for wrapper in counters:
                wrapper.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return (out, [wrapper.launches for wrapper in counters],
                    (time.perf_counter() - t0) * 1e3)

        for (label, scene, cam, width, height, mode, kwargs, unsharded,
             kernel, repeats) in cases:
            replica = sh.replicate_scene(scene, mesh)

            def sharded():
                return sh.render_samples_sharded(
                    replica, cam, width, height, 0, SPP, mesh, mode=mode,
                    **kwargs)

            got, got_counts, got_ms = counted(sharded)
            ref, ref_counts, ref_ms = counted(unsharded)
            if got.device != cam.device or not torch.equal(got, ref):
                raise SystemExit(
                    f"chip_smoke: sharded {label} on {got.device} differs "
                    f"from the unsharded frame: max abs err "
                    f"{(got - ref).abs().max().item()}")
            expected = [c for c in counters if c is kernel]
            moved = [w for w, n in zip(counters, got_counts) if n]
            if got_counts != ref_counts or moved != expected:
                raise SystemExit(f"chip_smoke: sharded {label} launches "
                                 f"{got_counts}, unsharded {ref_counts}")
            sharded_launches = [a + b for a, b in zip(sharded_launches,
                                                      got_counts)]
            refs[label] = ref.cpu()
            ms = {"sharded": [got_ms], "unsharded": [ref_ms]}
            for _ in range(repeats):
                ms["sharded"].append(synced_ms(sharded))
                ms["unsharded"].append(synced_ms(unsharded))
            med = {k: statistics.median(v) for k, v in ms.items()}
            print(f"sharded {label} {width}x{height} spp {SPP}: equal bit "
                  f"for bit to the unsharded frame, launches {got_counts} "
                  f"(B1, B2, B3, B6, B4, B5, B7) as the unsharded frame's; "
                  f"median synced frame {med['sharded']:.4f} ms sharded, "
                  f"{med['unsharded']:.4f} ms unsharded ({repeats + 1} "
                  f"each, in turns)")
            rows.append({"case": label, "mode": mode, "width": width,
                         "height": height, "launches": got_counts,
                         "sharded_ms": ms["sharded"],
                         "unsharded_ms": ms["unsharded"],
                         "median_sharded_ms": med["sharded"],
                         "median_unsharded_ms": med["unsharded"]})
    finally:
        dist.destroy_process_group()
    print("sharded: a world of one rank on one card (gloo worlds of several "
          "ranks on it follow); no multi-card number (speed-up, efficiency, "
          "collective time across cards) can be measured on one card")
    return {"rows": rows, "launches": sharded_launches}, refs


def grad_phase(dev, counters) -> dict:
    """Phase 4j: loss_and_grad on the card against the CPU (pointlight.xml,
    64x48, 2 spp, 3 bounces), then one timed step at 640x480, 2 spp, 6
    bounces with its peak memory.  No hand-written kernel takes part."""
    from pathtracer_cuda_interactive_tpu_torch.grad import inverse as inv

    W, H, spp, bounces = GRAD_W, GRAD_H, SPP, GRAD_BOUNCES
    scene, cd, pix, params = grad_inputs(W, H, "cpu")
    target = grad_target(scene, cd, pix, params, W, H, spp, bounces)
    valid = pix < W * H
    cpu_loss, cpu_grads = inv.loss_and_grad(params, scene, cd, target, valid,
                                            pix, W, H, 0, spp,
                                            num_bounces=bounces)
    for wrapper in counters:
        wrapper.launches = 0
    scene, cd, pix, params = grad_inputs(W, H, dev)
    loss, grads = inv.loss_and_grad(params, scene, cd, target.to(dev),
                                    valid.to(dev), pix, W, H, 0, spp,
                                    num_bounces=bounces)
    # the plain ops differ from the CPU's only by float order and the
    # 1-2 ulp of the math library: rtol 1e-3; atol 1e-6 for the
    # gradients that are 0 or about 1e-10 on both
    rtol, atol = 1e-3, 1e-6
    worst = {}
    for k, g in grads.items():
        ref = cpu_grads[k]
        if g.device != cd.device or not torch.isfinite(g).all() \
                or not torch.allclose(g.cpu(), ref, rtol=rtol, atol=atol):
            raise SystemExit(f"chip_smoke: gradient {k} on {g.device} "
                             f"{g.cpu().tolist()} against the CPU's "
                             f"{ref.tolist()}")
        worst[k] = float((g.cpu() - ref).abs().max()) if g.numel() else 0.0
    loss_rel = abs(float(loss) - float(cpu_loss)) / float(cpu_loss)
    if loss_rel > rtol or not (grads["light_intensity"] != 0).any():
        raise SystemExit(f"chip_smoke: loss {float(loss)} against the CPU's "
                         f"{float(cpu_loss)}, or light_intensity's gradient "
                         "is zero")
    if any(w.launches for w in counters):
        raise SystemExit("chip_smoke: the gradient step launched a kernel")
    print(f"gradients on cuda, pointlight {W}x{H} spp {spp} {bounces} "
          f"bounces: loss {float(loss):.6e} against the CPU's "
          f"{float(cpu_loss):.6e} (rel err {loss_rel:.2e}); all "
          f"{len(grads)} gradients finite and within rtol {rtol}, atol "
          f"{atol} of the CPU's (max abs err "
          f"{max(worst.values()):.3e}); no kernel launch")

    W, H, bounces = MAIN_W, MAIN_H, 6
    scene, cd, pix, params = grad_inputs(W, H, dev)
    target, valid = inv.image_to_grid(torch.zeros((H, W, 3), device=dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    step_ms = synced_ms(lambda: inv.loss_and_grad(
        params, scene, cd, target, valid, pix, W, H, 0, spp,
        num_bounces=bounces))
    peak = torch.cuda.max_memory_allocated()
    print(f"gradient step {W}x{H} spp {spp} {bounces} bounces on cuda: "
          f"{step_ms:.1f} ms (one synced call), peak memory {peak} bytes "
          f"({peak - before} above the {before} held before it)")
    return {"loss": float(loss), "cpu_loss": float(cpu_loss),
            "loss_rel_err": loss_rel, "grad_max_abs_err": worst,
            "step_ms": step_ms, "peak_bytes": peak,
            "bytes_before": before}


VIEWER_FPS_S = 3.0       # seconds the loop's frames are counted over
VIEWER_FRAMES = 10       # /frame requests timed while the loop runs
VIEWER_DEADLINE_S = 60.0


def viewer_phase(label, renderer, kernel, counters, synced_ms) -> dict:
    """Phase 4k on one scene: a Viewer on ``renderer`` (port 0), the page,
    an orbit drag, /state until the camera moved and the sample count
    restarted, /frame as a PNG of the renderer's size that is not flat; the
    loop's FPS over VIEWER_FPS_S beside ``synced_ms`` (the synced frame of
    the same path in phase 4 or 4c), and the wall time of VIEWER_FRAMES
    /frame requests.  Beside them, the same number of reads through
    ``render_lock`` alone from this thread (the JAX viewer's read, which
    the port's /frame replaces), each given at most 10 s.  ``kernel`` must
    have launched and no other kernel.  The counters are read after
    ``Viewer.stop()`` has joined the render thread."""
    import urllib.request

    from pathtracer_cuda_interactive_tpu_torch.utils import image
    from pathtracer_cuda_interactive_tpu_torch.viewer.server import Viewer

    for wrapper in counters:
        wrapper.launches = 0
    v = Viewer(renderer, port=0)
    base = f"http://127.0.0.1:{v.port}"

    def get(path):
        with urllib.request.urlopen(base + path,
                                    timeout=VIEWER_DEADLINE_S) as resp:
            return resp.read()

    def post(ev):
        req = urllib.request.Request(base + "/event",
                                     data=json.dumps(ev).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=VIEWER_DEADLINE_S) as resp:
            return resp.read()

    def poll(until, what):
        deadline = time.monotonic() + VIEWER_DEADLINE_S
        while time.monotonic() < deadline:
            st = json.loads(get("/state"))
            if until(st):
                return st
            time.sleep(0.005)
        raise SystemExit(f"chip_smoke: viewer on {label}: {what} within "
                         f"{VIEWER_DEADLINE_S} s")

    png_path = png_file(label)
    v.start()
    try:
        if b"Scene Controls" not in get("/"):
            raise SystemExit(f"chip_smoke: viewer on {label}: no page")
        poll(lambda st: st["samples"] > 0, "no frame")
        f0, t0 = v.state.frames, time.perf_counter()
        time.sleep(VIEWER_FPS_S)
        fps = (v.state.frames - f0) / (time.perf_counter() - t0)
        frame_ms = []
        for _ in range(VIEWER_FRAMES):
            t0 = time.perf_counter()
            get("/frame")
            frame_ms.append((time.perf_counter() - t0) * 1e3)
        lock_ms = []
        for _ in range(VIEWER_FRAMES):
            t0 = time.perf_counter()
            if v.state.render_lock.acquire(timeout=10.0):
                try:
                    renderer.framebuffer()
                finally:
                    v.state.render_lock.release()
            lock_ms.append((time.perf_counter() - t0) * 1e3)
        before = json.loads(get("/state"))
        post({"type": "orbit_begin", "x": 320, "y": 240})
        post({"type": "orbit_drag", "x": 360, "y": 230})
        post({"type": "orbit_drag", "x": 400, "y": 220})
        post({"type": "orbit_end"})
        after = poll(lambda st: st["camera"]["lookfrom"]
                     != before["camera"]["lookfrom"]
                     and st["samples"] < before["samples"],
                     "the camera did not move or the count did not restart")
        png_path.write_bytes(get("/frame"))
    finally:
        v.stop()
    launches = [w.launches for w in counters]
    img = image.read_png(str(png_path))
    if img.shape != (renderer.height, renderer.width, 3) or not img.std() > 0:
        raise SystemExit(f"chip_smoke: viewer on {label}: /frame is "
                         f"{img.shape}, std {img.std()}")
    others = [n for w, n in zip(counters, launches) if w is not kernel]
    if kernel.launches == 0 or any(others):
        raise SystemExit(f"chip_smoke: viewer on {label}: "
                         f"{kernel.launches} launches of its kernel, "
                         f"{others} of the others")
    out = {"scene": label, "fps": fps, "loop_ms": 1e3 / fps,
           "synced_frame_ms": synced_ms,
           "frame_request_median_ms": statistics.median(frame_ms),
           "frame_request_max_ms": max(frame_ms),
           "lock_read_median_ms": statistics.median(lock_ms),
           "lock_read_max_ms": max(lock_ms),
           "samples_before_move": before["samples"],
           "samples_after_move": after["samples"],
           "launches": kernel.launches, "png": str(png_path)}
    print(f"viewer {label} {renderer.width}x{renderer.height}: loop "
          f"{fps:.1f} FPS over {VIEWER_FPS_S:.0f} s ({1e3 / fps:.4f} ms a "
          f"turn; synced frame {synced_ms:.4f} ms); /frame while the loop "
          f"runs: median {out['frame_request_median_ms']:.2f} ms, max "
          f"{out['frame_request_max_ms']:.2f} ms of {VIEWER_FRAMES}; a read "
          f"through render_lock alone: median "
          f"{out['lock_read_median_ms']:.2f} ms, max "
          f"{out['lock_read_max_ms']:.2f} ms; orbit: camera moved, samples "
          f"{before['samples']} -> {after['samples']}; launches "
          f"{kernel.launches} of {kernel.__name__} and no other")
    return out


def png_file(label: str) -> Path:
    from pathtracer_cuda_interactive_tpu_torch.ops.cuda_build import BUILD_DIR

    BUILD_DIR.mkdir(exist_ok=True)
    return BUILD_DIR / f"chip_smoke_viewer_{label.replace(' ', '_')}.png"


BENCH_KEYS = ("cbox_synced_latency_ms", "cbox_synced_latency_max_ms",
              "cbox_synced_fps", "cbox_batched16_msamples_s",
              "cbox_avg_path_len", "cbox_mrays_s", "bunny_avg_path_len",
              *(f"bunny_{mode}_{key}" for mode in ("wavefront", "bricks")
                for key in ("msamples_s", "init_s", "first_step_s",
                            "mrays_s")))
BENCH_TIMEOUT_S = 300


def bench_phase() -> dict:
    """Phase 4l: the port's bench with its cbox and bunny rows in a
    subprocess: exit 0 and one JSON line on stdout with bench.py's keys,
    every rate and time positive."""
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pathtracer_cuda_interactive_tpu_torch.bench",
         "--rows", "cbox,bunny"], cwd=root, capture_output=True, text=True,
        timeout=BENCH_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or len(lines) != 1:
        raise SystemExit(f"chip_smoke: bench exit {proc.returncode}, "
                         f"{len(lines)} stdout lines; stderr "
                         f"{proc.stderr[-2000:]}")
    out = json.loads(lines[0])
    extra = out["extra"]
    bad = [k for k in BENCH_KEYS if not extra.get(k, 0) > 0]
    if set(out) != {"metric", "value", "unit", "vs_baseline", "extra"} \
            or not out["value"] > 0 or not out["vs_baseline"] > 0 or bad \
            or extra["bunny_mode"] not in ("wavefront", "bricks"):
        raise SystemExit(f"chip_smoke: bench line lacks keys or values: "
                         f"{bad} {lines[0]}")
    print(f"bench (cbox,bunny) in {seconds:.1f} s:")
    print(lines[0])
    return {"seconds": seconds, "line": out}


def host_phase(big_parsed) -> dict:
    """Phase 4m's host builders: the large scene's pack (BVH) and brick set
    (SAH treelets) with the C++ builders and with PT_TPU_NO_NATIVE set
    (the numpy builders), every array bit for bit the same, both timed."""
    import dataclasses
    import os

    from pathtracer_cuda_interactive_tpu_torch.models import native
    from pathtracer_cuda_interactive_tpu_torch.models.bricks import BrickSet
    from pathtracer_cuda_interactive_tpu_torch.models.scenepack import (
        pack_scene)

    if not native.available():
        raise SystemExit("chip_smoke: the native builders did not build")

    def build():
        t0 = time.perf_counter()
        pack = pack_scene(big_parsed)
        t1 = time.perf_counter()
        bricks = BrickSet.from_pack(pack)
        return pack, bricks, t1 - t0, time.perf_counter() - t1

    pack, bricks, pack_s, bricks_s = build()
    os.environ["PT_TPU_NO_NATIVE"] = "1"
    try:
        ref_pack, ref_bricks, ref_pack_s, ref_bricks_s = build()
    finally:
        del os.environ["PT_TPU_NO_NATIVE"]

    def same(a, b):
        if isinstance(a, torch.Tensor):
            a, b = a.numpy(), b.numpy()
        if isinstance(a, np.ndarray):
            return a.dtype == b.dtype and a.shape == b.shape \
                and a.tobytes() == b.tobytes()
        return a == b

    differ = [f.name for f in dataclasses.fields(pack)
              if not same(getattr(pack, f.name), getattr(ref_pack, f.name))]
    differ += [f.name for f in dataclasses.fields(bricks)
               if not same(getattr(bricks, f.name),
                           getattr(ref_bricks, f.name))]
    if differ:
        raise SystemExit(f"chip_smoke: native and numpy builds differ in "
                         f"{differ}")
    print(f"host builders, {pack.num_triangles} triangles: pack (BVH) "
          f"{pack_s:.3f} s native against "
          f"{ref_pack_s:.3f} s numpy, brick set (SAH treelets) "
          f"{bricks_s:.3f} s against {ref_bricks_s:.3f} s; every array bit "
          f"for bit the same (numpy builders 4.03 s in all in PERF.md §5)")
    return {"pack_native_s": pack_s,
            "pack_numpy_s": ref_pack_s, "bricks_native_s": bricks_s,
            "bricks_numpy_s": ref_bricks_s}


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
    from pathtracer_cuda_interactive_tpu_torch import entry as entry_points
    from pathtracer_cuda_interactive_tpu_torch.experiments import (
        mx2, mxtrace)
    from pathtracer_cuda_interactive_tpu_torch.io import print_scene
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
    from pathtracer_cuda_interactive_tpu_torch.ops import wave_step as ws
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
    # float32 operations of a slab test and of a Moller-Trumbore test, as
    # csrc/brick_walk.cuh and csrc/pt_common.cuh do them
    from torrey_bench.roofline import BOX_OPS, TRI_OPS

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

    # -- 2, 2b, 2c, 2d, 2e and 2f. the kernel builds: one nvcc per source,
    # started together
    t0 = time.perf_counter()
    built = cuda_build.build_all([mk.SOURCE, wf.SOURCE, bk.SOURCE,
                                  wf.SLIM2_SOURCE, pt.SOURCE, mx2.SOURCE,
                                  ws.SOURCE])
    mk.load_library()
    wf.load_library()
    bk.load_library()
    wf.load_slim2_library()
    pt.load_library()
    mx2.load_library()
    ws.load_library()
    build_s = time.perf_counter() - t0
    print(f"megakernel build {built[mk.SOURCE]:.2f} s, brick_trace build "
          f"{built[wf.SOURCE]:.2f} s, brick_render build "
          f"{built[bk.SOURCE]:.2f} s, brick_trace_slim2 build "
          f"{built[wf.SLIM2_SOURCE]:.2f} s, pair_trace build "
          f"{built[pt.SOURCE]:.2f} s, mx2_trace build "
          f"{built[mx2.SOURCE]:.2f} s, wave_step build "
          f"{built[ws.SOURCE]:.2f} s (in parallel); build+load "
          f"{build_s:.2f} s")
    results.update(build_s=build_s, megakernel_build_s=built[mk.SOURCE],
                   brick_trace_build_s=built[wf.SOURCE],
                   brick_render_build_s=built[bk.SOURCE],
                   brick_trace_slim2_build_s=built[wf.SLIM2_SOURCE],
                   pair_trace_build_s=built[pt.SOURCE],
                   mx2_trace_build_s=built[mx2.SOURCE],
                   wave_step_build_s=built[ws.SOURCE])

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
        """The plain version of a wavefront engine's per-wave trace: B4's
        over the walk table the kernel reads, B5's with the kernel's early
        votes."""
        if engine == "slim2":
            return lambda b, org, dirn, tnear: trace_bricks_pipelined_plain(
                b, org, dirn, tnear, table=b.walk_table())
        rows = wf.parse_engine(engine)[1]

        def plain_pairs(b, org, dirn, tnear):
            brk, ent, cnt = pt.visit_lists(b, org, dirn, tnear, rows)
            return pt.trace_pairs_plain(b, org, dirn, tnear, brk, ent, cnt,
                                        rows * pt.LANES, early_votes=True)
        return plain_pairs

    def compare_engine(bricks, waves, label, engine):
        """3e, 3f: an engine's kernel on each wave against its plain version
        and against kernel B2.  Both engines must equal their plain versions
        bit for bit, B5 its four counters too; "slim2" must equal B2 bit for
        bit, "pairs[N]" give B2's t on every ray and B2's slot on all but
        1e-4 of the rays (equal-t ties, which the visit order decides)."""
        kernel, plain = wf.engine_tracer(engine), plain_engine(engine)
        limit = 0.0 if engine == "slim2" else 1e-4
        rows = wf.parse_engine(engine)[1]
        out = []
        for (org, dirn, tnear), name in zip(waves, ("primary", "bounce 1")):
            t, slot = kernel(bricks, org, dirn, tnear)
            b2_t, b2_slot = wf.trace_bricks_cuda(bricks, *org, *dirn, tnear)
            counters = same_counters = None
            if engine != "slim2":
                lists = pt.visit_lists(bricks, org, dirn, tnear, rows)
                _, _, seen = pt.trace_pairs_cuda(
                    bricks, *org, *dirn, tnear, *lists, rows * pt.LANES,
                    collect_stats=True)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            if engine == "slim2":
                ref_t, ref_slot = plain(bricks, org, dirn, tnear)
            else:
                # the plain walk with the kernel's early votes, and its
                # counters
                ref_t, ref_slot, ref_seen = pt.trace_pairs_plain(
                    bricks, org, dirn, tnear, *lists, rows * pt.LANES,
                    collect_stats=True, early_votes=True)
                counters = {"kernel": seen.tolist(),
                            "plain": ref_seen.tolist()}
                same_counters = counters["kernel"] == counters["plain"]
            stop.record()
            stop.synchronize()
            vs_plain = float(((t.view(torch.int32) != ref_t.view(torch.int32))
                              | (slot != ref_slot)).float().mean())
            t_differs = int((t.view(torch.int32)
                             != b2_t.view(torch.int32)).sum())
            vs_b2 = float((slot != b2_slot).float().mean())
            both = torch.isfinite(t) & torch.isfinite(ref_t)
            err = float((t[both] - ref_t[both]).abs().max()) if both.any() \
                else 0.0
            res = {"ok": vs_plain == 0.0 and t_differs == 0
                   and vs_b2 <= limit and same_counters is not False,
                   "engine": engine, "scene": label,
                   "wave": name, "rays": int(t.numel()),
                   "mismatch_share": vs_plain, "t_differs_from_b2": t_differs,
                   "slot_mismatch_share_vs_b2": vs_b2, "max_abs_err": err,
                   "plain_ms": start.elapsed_time(stop), "counters": counters}
            out.append(res)
            told = ""
            if counters is not None:
                listed, skipped, tested, boxed_out = counters["kernel"]
                visits = max(listed - skipped, 1)
                told = (f"; counters {counters['kernel']} against the plain "
                        f"walk's {counters['plain']}: of the pairs listed to "
                        f"a warp {skipped / max(listed, 1):.4f} skipped by "
                        f"the entry bound, of its visits "
                        f"{boxed_out / visits:.4f} ended at the brick's box, "
                        f"{tested / visits:.4f} chunks tested per visit")
            print(f"{engine} vs plain {label} {name} wave: {res['rays']} "
                  f"rays, mismatch share {vs_plain:.3e}, max abs err "
                  f"{err:.3e}; vs B2: t differs on {t_differs} rays, slot "
                  f"mismatch share {vs_b2:.3e}{told} -> "
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
    # the same renders through W1-W3 against the same loop through their
    # plain versions; the kernels' run with every plain version refused
    w_renders = []
    for nee in (False, True):
        for depth, check in ((4, wave_check), (12, deep_check)):
            with plain_versions_refused():
                got = wf.render_samples_wavefront(blob, cd, SMALL_W, SMALL_H,
                                                  0, SPP, max_depth=depth,
                                                  nee=nee)
                torch.cuda.synchronize()
            ref = wf.render_samples_wavefront(blob, cd, SMALL_W, SMALL_H, 0,
                                              SPP, max_depth=depth, nee=nee,
                                              steps=ws.PLAIN_STEPS)
            torch.cuda.synchronize()
            res = check(got.cpu().numpy(), ref.cpu().numpy())
            res.update(scene="blob_box", nee=nee, width=SMALL_W,
                       height=SMALL_H, spp=SPP, depth=depth)
            w_renders.append(res)
            print(f"wavefront W1-W3 vs plain steps blob_box nee={nee} "
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
    require_agreement("W1-W3", w_renders)
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
    # result out (8 bytes; B3's record 64).  B2, B3, B4, B5 and B6 read the
    # walk table and the chunk gates (B3 and B6 also the 128-byte record of
    # each hit's winner, what this wave's hits need; B5 not the node
    # records, but the bricks' visit boxes and its packets' lists).
    def walk_ops(counters):
        return ((counters["nodes"]["mean"] + 16 * counters["bricks"]["mean"])
                * BOX_OPS + counters["chunks"]["mean"] * 32 * TRI_OPS)

    big_counters = {c["wave"]: c["counters"] for c in b3_checks
                    if c["scene"] == "blob_box x3"}
    wave_rays = wave_ms["bounce 1"]["rays"]
    walk_bytes = walk_table.nbytes + big.sub_boxes.numel() * 4
    wave_hits = next(c["hit_share"] for c in b3_checks
                     if c["scene"] == "blob_box x3"
                     and c["wave"] == "bounce 1") * wave_rays
    wave_ops = wave_rays * walk_ops(big_counters["bounce 1"])
    slim_bound = bound(walk_bytes + wave_rays * 32, wave_ops)
    full_bound = bound(walk_bytes + wave_hits * 128 + wave_rays * 88,
                       wave_ops)
    # B4 is B2's function over the same bytes
    slim2_bound = slim_bound
    # B5 reads the triangles and gates of the walk table, the visit boxes
    # (32 bytes a brick) and its packets' lists (a brick id and a bound per
    # pair)
    pair_bound = bound(
        walk_table.tris.numel() * 4 + big.sub_boxes.numel() * 4
        + big.num_bricks * 32 + wave_rays * 32
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
    b6_img = bk.render_samples_bricks(big, cd, MAIN_W, MAIN_H, 0,
                                      SPP).cpu().numpy()
    deep = deep_check(b6_img, plain_img.cpu().numpy())
    b6_digest = hashlib.sha256(b6_img.tobytes()).hexdigest()
    if b6_digest != B6_DIGEST:
        raise SystemExit(f"chip_smoke: B6's depth-50 frame moved: digest "
                         f"{b6_digest}, not {B6_DIGEST}")
    print(f"B6 depth-50 frame digest {b6_digest}: bit for bit the frame "
          f"before csrc/bounce.cuh")
    del plain_img, b6_img
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

    stamp("3d done")
    # -- 3i. the bounce step's kernels (csrc/wave_step.cu) against their
    # plain versions on every call of two renders of the large scene at the
    # main path's shape, and their times on its primary and sorted
    # first-bounce waves
    w_wrappers = wave_step_wrappers()
    w_logs, w_frames = {}, {}
    for label, kw in (("blob_box x3", {}),
                      ("blob_box x3 nee depth 4", {"nee": True,
                                                   "max_depth": 4})):
        for wrapper in w_wrappers:
            wrapper.launches = 0
        w_logs[label], frame_stats = [], {}
        img = wf.render_samples_wavefront(
            big, cd, MAIN_W, MAIN_H, 0, SPP, stats=frame_stats,
            steps=ws.recording_steps(w_logs[label]), **kw)
        torch.cuda.synchronize()
        w_frames[label] = (img, frame_stats)
    # the NEE render's: its shadow rays ran on every wave
    shadow_launches = ws.wave_shadow_rays_cuda.launches
    w_checks = [c for label, log in w_logs.items()
                for c in hold_wave_steps(log, label)]
    for label in w_logs:
        for name in ("record", "shadow_rays", "shade", "key"):
            rows = [c for c in w_checks
                    if c["scene"] == label and c["kernel"] == name]
            if rows:
                print(f"{name} kernel vs plain {label} {MAIN_W}x{MAIN_H}: "
                      f"{len(rows)} calls over waves 0-{rows[-1]['wave']}, "
                      f"{sum(c['rays'] for c in rows)} rays, mismatch share "
                      f"at most {max(c['mismatch_share'] for c in rows):.3e}"
                      f", max abs err "
                      f"{max(c['max_abs_err'] for c in rows):.3e} -> "
                      f"{'ok' if all(c['ok'] for c in rows) else 'FAIL'}")
    require_agreement("W1-W3", w_checks)

    def wave_calls(log, wave):
        """{name: args} of the first logged call of each step of ``wave``
        (a key belongs to the wave it orders)."""
        found, at = {}, 0
        for name, args in log:
            if at == wave:
                found.setdefault(name, args)
            at += name == "shade"
        return found

    w_ms = {}
    for wave, wave_name in ((0, "primary"), (1, "bounce 1")):
        calls = wave_calls(w_logs["blob_box x3"], wave)
        nee_calls = wave_calls(w_logs["blob_box x3 nee depth 4"], wave)
        rec, shade = calls["record"], calls["shade"]
        shadow = nee_calls["shadow_rays"]
        scratch = shade[6].clone()
        shaded = (*shade[:6], scratch, *shade[7:])
        runs = {"W1": (lambda: ws.wave_record_cuda(*rec),
                       lambda: ws.record_plain(*rec)),
                "W2": (lambda: ws.wave_shade_cuda(*shaded),
                       lambda: ws.shade_plain(*shaded)),
                "shadow": (lambda: ws.wave_shadow_rays_cuda(*shadow),
                           lambda: ws.shadow_rays_plain(*shadow))}
        if "key" in calls:
            runs["W3"] = (lambda: ws.wave_sort_key_cuda(*calls["key"]),
                          lambda: ws.sort_key_plain(*calls["key"]))
        w_ms[wave_name] = {}
        for kernel, (fn, plain) in runs.items():
            times = {"kernel": [], "plain": []}
            for which in ("plain", "kernel", "kernel", "plain"):
                times[which].append(cuda_ms(fn, 20) if which == "kernel"
                                    else cuda_ms(plain, 3))
            w_ms[wave_name][kernel] = {
                "ms": statistics.median(times["kernel"]),
                "plain_ms": statistics.median(times["plain"]),
                "timings": times}
        new = ws.wave_shade_cuda(*shaded)
        torch.cuda.synchronize()
        rays = int(rec[1].numel())
        slot = rec[2]
        winners = int(torch.unique(slot[slot >= 0]).numel())
        ended = int((new[ws.LIVE] == 0).sum())
        row = w_ms[wave_name]
        row.update(rays=rays, winners=winners, ended=ended)
        print(f"W1-W3 timing blob_box x3 {MAIN_W}x{MAIN_H} {wave_name} wave "
              f"({rays} rays, {winners} distinct winners, {ended} paths "
              f"ended): " + ", ".join(
                  f"{k} {v['ms']:.4f} ms (plain {v['plain_ms']:.3f})"
                  for k, v in row.items() if isinstance(v, dict)))
    # Bounds on the sorted first-bounce wave: each input read once, each
    # output written once.  W1 reads the rays (24 bytes), t and slot (8),
    # each distinct winner's 128-byte record and slot 0's, the sphere table,
    # and writes the 64-byte record; W2 reads the table and the record (64
    # bytes each) and writes the new table (64) and 12 bytes a path that
    # ended; W3 reads the rays and the live flag (28) and the coarse boxes
    # and writes 4 bytes, and keys the live rays of the wave before; the
    # shadow rays read the hit position (12) and write 12 bytes a light.
    bounce = w_ms["bounce 1"]
    n_b, n_sph = bounce["rays"], big.num_spheres
    w1_bound = bound(n_b * 96 + (bounce["winners"] + 1 + n_sph) * 128,
                     n_b * (W1_OPS + n_sph * SPHERE_OPS))
    w2_bound = bound(n_b * 192 + bounce["ended"] * 12,
                     n_b * W2_OPS)
    key_args = wave_calls(w_logs["blob_box x3"], 1)["key"]
    n_key = int(key_args[0].shape[1])
    n_coarse = int(big.coarse_boxes.shape[0])
    w3_bound = bound(n_key * 32 + n_coarse * 32,
                     n_b * (n_coarse * BOX_OPS + MORTON_OPS))
    n_lights = int(big.light_pos.shape[0])
    nee_rays = int(wave_calls(w_logs["blob_box x3 nee depth 4"],
                              1)["shadow_rays"][0].shape[1])
    shadow_bound = bound(nee_rays * 12 * (1 + n_lights),
                         nee_rays * n_lights * LIGHT_OPS)
    w_err = {name: max(c["max_abs_err"] for c in w_checks
                       if c["kernel"] == name)
             for name in ("record", "shadow_rays", "shade", "key")}
    print(f"W1-W3 bounds (sorted first-bounce wave): W1 "
          f"{w1_bound['bound_ms']:.4f} ms, W2 {w2_bound['bound_ms']:.4f} ms, "
          f"W3 {w3_bound['bound_ms']:.4f} ms (over {n_key} rays of the "
          f"wave before, {n_b} live), shadow rays "
          f"{shadow_bound['bound_ms']:.4f} ms; launches of the NEE render: "
          f"shadow rays {shadow_launches}")
    results.update(w_checks=w_checks, w_renders=w_renders, w_ms=w_ms,
                   b6_digest=b6_digest)
    stamp("3i done")

    # -- 3j. the main path's counted schedule at its shape: two frames
    # through its graphs (the first captures them) against 3i's frame
    # through the uncounted schedule, and its kernels' counted form on the
    # sorted first-bounce wave laid in its capacity class
    ref_img, ref_stats = w_frames["blob_box x3"]
    wave_cache = wf.WaveCache()
    graph_frames = []
    for _ in range(2):
        frame_stats = {}
        img = wf.render_samples_wavefront(big, cd, MAIN_W, MAIN_H, 0, SPP,
                                          stats=frame_stats,
                                          wave_cache=wave_cache)
        torch.cuda.synchronize()
        graph_frames.append({"equal": bool(torch.equal(img, ref_img)),
                             "stats": frame_stats,
                             "replays": wave_cache.replays()})
    del img, w_frames
    chunks = list(wave_cache._chunks.values())
    K = wf.GROUP_WAVES
    per_graph = {str(name): n for c in chunks
                 for name, n in c.launches.items()}

    def graph_holds(name):
        """[B2, W1, W2, W3, drain] launches of graph ``name``."""
        if name == "drain":
            return [0, 0, 0, 0, 1]
        return [1 if name == "primary" else K] * 4 + [0]

    held = all(n == graph_holds(name)
               for c in chunks for name, n in c.launches.items())
    drained = wave_cache.drained()
    # the classes each chunk captured a group for: here the chunk's full
    # width alone, which the first read picks; every later read drains, as
    # its group would run past the roulette's start
    groups = [[n for n in c.launches if n not in ("primary", "drain")]
              for c in chunks]
    print(f"counted schedule {MAIN_W}x{MAIN_H} spf {SPP} depth 50: "
          f"{len(chunks)} chunk(s) of {[c.capacity for c in chunks]} rays, "
          f"classes {[c.classes for c in chunks]}, drain at or under "
          f"{[K * c.drain_lanes for c in chunks]} live rays (GROUP_WAVES "
          f"rounds of {[c.drain_lanes for c in chunks]} resident lanes) "
          f"or from depth {chunks[0].rr_start_depth - K + 2} on, groups "
          f"captured {groups}; frames (capture, replay) equal to the "
          f"uncounted frame bit for bit "
          f"{[f['equal'] for f in graph_frames]}, waves and rays "
          f"{[f['stats'] for f in graph_frames]} against {ref_stats}, "
          f"replays {graph_frames[-1]['replays']}, the drains' waves and "
          f"rays {drained}; launches a graph [B2, W1, W2, W3, drain] "
          f"{per_graph}")
    replays = graph_frames[-1]["replays"]
    if not (all(f["equal"] and f["stats"] == ref_stats
                for f in graph_frames) and held
            and groups == [[c.capacity] for c in chunks]
            and all(c.engine.graphed for c in chunks)
            and replays["primary"] == 2 * len(chunks)
            and replays["drain"] == 2 * len(chunks)
            and drained["rays"] > 0):
        raise SystemExit("chip_smoke: the kept cache's chunks are not "
                         "counted and graphed, their frame is "
                         "not the uncounted one's, its graphs do not "
                         "hold one launch of B2, W1, W2 and W3 a wave and "
                         "the drain's one of the drain, a group was "
                         "captured for another class than the chunk's "
                         "width, or no frame drained")

    def counted_form(wave):
        """B2 and W1-W3 on wave ``wave`` of 3i's frame, its n rays laid in
        the first columns of its capacity class: their counted launches
        against the plain ones (the live columns bit for bit, W3's keys
        past them INT32_MAX), both timed.  Returns (n, class, {kernel:
        equal}, {kernel: times})."""
        calls = wave_calls(w_logs["blob_box x3"], wave)
        _, t1, slot1, org1, dirn1, tnear1 = calls["record"]
        shade_args = calls["shade"]
        mode, lo, inv_extent, coarse = calls["key"][1:5]
        n = int(t1.numel())
        cls = min(c for c in chunks[0].classes if c >= n)

        def laid(x, fill=0.0):
            """``x`` [..., n] in the first columns of [..., cls]."""
            out = x.new_full((*x.shape[:-1], cls), fill)
            out[..., :n] = x
            return out

        org_c, dirn_c = (type(v)(*(laid(c) for c in v))
                         for v in (org1, dirn1))
        ctl = ws.new_control("cuda")
        ctl[ws.COUNT] = n
        ctl[ws.DEPTH] = int(shade_args[2])
        out_p, out_c = shade_args[6].clone(), shade_args[6].clone()
        into = torch.empty((ws.TABLE_ROWS, cls), device="cuda")
        key_c = torch.empty(cls, dtype=torch.int32, device="cuda")
        t_c, slot_c = laid(t1, float("inf")), laid(slot1, -1)
        table_c, rec_c = laid(shade_args[0]), laid(shade_args[1])
        runs = {
            "B2": (lambda: wf.trace_bricks_cuda(big, *org1, *dirn1, tnear1),
                   lambda: wf.trace_bricks_cuda(big, *org_c, *dirn_c,
                                                tnear1, ctl)),
            "W1": (lambda: ws.wave_record_cuda(*calls["record"]),
                   lambda: ws.wave_record_cuda(big, t_c, slot_c, org_c,
                                               dirn_c, tnear1, ctl)),
            "W2": (lambda: ws.wave_shade_cuda(*shade_args[:6], out_p,
                                              *shade_args[7:]),
                   lambda: ws.wave_shade_cuda(table_c, rec_c, 0,
                                              *shade_args[3:6], out_c,
                                              ctl=ctl, into=into)),
        }
        got = {name: (plain(), fn()) for name, (plain, fn) in runs.items()}
        new_p = got["W2"][0]
        runs["W3"] = (
            lambda: ws.wave_sort_key_cuda(new_p, mode, lo, inv_extent,
                                          coarse),
            lambda: ws.wave_sort_key_cuda(into, mode, lo, inv_extent,
                                          coarse, ctl, key_c))
        got["W3"] = tuple(fn() for fn in runs["W3"])
        torch.cuda.synchronize()
        bits = lambda x: (x.view(torch.int32) if x.dtype == torch.float32
                          else x)
        same = {
            "B2": all(torch.equal(bits(p), bits(c[:n]))
                      for p, c in zip(*got["B2"])),
            "W1": torch.equal(bits(got["W1"][0]),
                              bits(got["W1"][1][:, :n])),
            "W2": (torch.equal(bits(new_p), bits(into[:, :n]))
                   and torch.equal(bits(out_p), bits(out_c))),
            "W3": (torch.equal(got["W3"][0], key_c[:n])
                   and bool((key_c[n:] == ws.INT32_MAX).all())),
        }
        times = {}
        for name, (plain, fn) in runs.items():
            row = {"kernel": [], "counted": []}
            for which in ("kernel", "counted", "counted", "kernel"):
                row[which].append(cuda_ms(fn if which == "counted"
                                          else plain, 20))
            times[name] = {"kernel_ms": statistics.median(row["kernel"]),
                           "counted_ms": statistics.median(row["counted"]),
                           "timings": row}
        return n, cls, same, times

    # the sorted first-bounce wave (3i's timed wave) and the first wave
    # with fewer rays than the chunk: columns past the count in its class
    sizes = [int(args[1].numel()) for name, args in w_logs["blob_box x3"]
             if name == "record"]
    tail_wave = next(w for w, n in enumerate(sizes)
                     if n < chunks[0].capacity)
    counted = {}
    for wave in (1, tail_wave):
        n_rays, n_class, same, times = counted_form(wave)
        counted[f"wave {wave}"] = {"rays": n_rays, "class": n_class,
                                   "same": same, "times": times}
        print(f"counted form on wave {wave} ({n_rays} rays in a class of "
              f"{n_class} columns): equal to the plain launch bit for bit {same}; "
              + ", ".join(f"{k} {v['counted_ms']:.4f} ms (plain launch "
                          f"{v['kernel_ms']:.4f})"
                          for k, v in times.items()))
        if not all(same.values()):
            raise SystemExit(f"chip_smoke: a counted launch on wave {wave} "
                             f"differs from the plain one: {same}")
    results.update(graph_frames=graph_frames, graph_launches=per_graph,
                   counted=counted)

    stamp("3j done")
    # -- 3k. the drain on the carried table of 3j's frame at the first read
    # the rule drains, against drain_plain
    chunk = chunks[0]
    chunk.cam.copy_(cd)
    chunk.first_sample.zero_()
    chunk._primary()
    while not wf._drains(int(chunk.ctl[ws.COUNT]), int(chunk.ctl[ws.DEPTH]),
                         chunk.drain_lanes, chunk.rr_start_depth):
        valid = int(chunk.ctl[ws.VALID])
        chunk._group(min(c for c in chunk.classes if c >= valid))
    torch.cuda.synchronize()
    at_read = (chunk.carry.clone(), chunk.ctl.clone(), chunk.out.clone())
    read_ctl = at_read[1].tolist()
    drain_args = (big, chunk.carry, chunk.ctl, chunk.bg, chunk.rr_start_depth,
                  chunk.max_depth, chunk.out)

    def from_read(**kw):
        """``drain_plain`` (``kw`` its trace and steps) from the read on
        copies: (out, control block)."""
        out, ctl = at_read[2].clone(), at_read[1].clone()
        ws.drain_plain(big, at_read[0].clone(), ctl, chunk.bg,
                       chunk.rr_start_depth, chunk.max_depth, out, **kw)
        return out, ctl

    chunk.ctl.copy_(at_read[1])
    ws.wave_drain_cuda(*drain_args, chunk.drain_lanes)
    torch.cuda.synchronize()
    drain_out, drain_ctl = chunk.out.clone(), chunk.ctl.tolist()
    ref_out, ref_ctl = from_read(trace=wf.trace_wave_slim, steps=ws.STEPS)
    drain_same = (torch.equal(drain_out.view(torch.int32),
                              ref_out.view(torch.int32))
                  and drain_ctl == ref_ctl.tolist())
    t0 = time.perf_counter()
    plain_out, plain_ctl = from_read()
    torch.cuda.synchronize()
    drain_plain_ms = (time.perf_counter() - t0) * 1e3
    # the paths the drain ended: their places in the radiance buffer
    rows = at_read[0][:, :read_ctl[ws.VALID]]
    rows = rows[:, rows[ws.LIVE] > 0]
    _, d_pix, d_samp = ws.int_rows(rows)
    at = lambda o: o[d_samp.long(), d_pix.long()]
    plain_share = float((~torch.isclose(at(drain_out), at(plain_out),
                                        rtol=1e-4, atol=1e-6).all(1))
                        .float().mean())
    plain_err = float((at(drain_out) - at(plain_out)).abs().max())
    drain_times = []
    for _ in range(20):
        chunk.ctl.copy_(at_read[1])
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        ws.wave_drain_cuda(*drain_args, chunk.drain_lanes)
        e1.record()
        e1.synchronize()
        drain_times.append(e0.elapsed_time(e1))
    drain_ms = statistics.median(drain_times)
    drain_rays = drain_ctl[ws.RAYS] - read_ctl[ws.RAYS]
    drain_levels = drain_ctl[ws.WAVES] - read_ctl[ws.WAVES]
    # each drained ray walks as a bounce ray, is recorded and shaded; the
    # drain reads each live column (64 bytes) and every live flag of the
    # valid columns, each traced ray's winner record, and writes 12 bytes a
    # path
    drain_bound = bound(
        walk_bytes + min(big.brick_data.numel() * 4, drain_rays * 128)
        + read_ctl[ws.COUNT] * (64 + 12) + read_ctl[ws.VALID] * 4,
        drain_rays * (walk_ops(big_counters["bounce 1"]) + W1_OPS
                      + big.num_spheres * SPHERE_OPS + W2_OPS))
    print(f"drain {MAIN_W}x{MAIN_H} spf {SPP} depth 50 from depth "
          f"{read_ctl[ws.DEPTH]}: {read_ctl[ws.COUNT]} live paths in "
          f"{read_ctl[ws.VALID]} columns ({chunk.drain_lanes} lanes), "
          f"{drain_rays} rays over {drain_levels} levels; equal to "
          f"drain_plain through B2, W1 and W2 bit for bit {drain_same}; the "
          f"plain drain_plain's paths beyond rtol 1e-4 {plain_share:.3e}, "
          f"largest difference {plain_err:.3e} "
          f"(rays {plain_ctl[ws.RAYS] - read_ctl[ws.RAYS]}); "
          f"{drain_ms:.4f} ms (min {min(drain_times):.4f}, max "
          f"{max(drain_times):.4f}), bound {drain_bound['bound_ms']:.4f} ms, "
          f"plain {drain_plain_ms:.1f} ms")
    if not drain_same or plain_share > 1e-3 or drain_rays <= 0:
        raise SystemExit("chip_smoke: the drain differs from drain_plain")
    drain_row = {"paths": read_ctl[ws.COUNT], "columns": read_ctl[ws.VALID],
                 "depth": read_ctl[ws.DEPTH], "rays": drain_rays,
                 "levels": drain_levels, "ms": drain_ms,
                 "timings": drain_times, "plain_ms": drain_plain_ms,
                 "plain_mismatch_share": plain_share,
                 "max_abs_err": plain_err, **drain_bound}
    results.update(drain=drain_row)
    del w_logs, wave_cache, chunk, at_read, drain_args

    counters = kernel_wrappers()

    def zero_counts():
        for wrapper in counters + w_wrappers:
            wrapper.launches = 0

    def w_launches():
        """Launches of W1, W2, W3 and the shadow rays since zero_counts."""
        return [wrapper.launches for wrapper in w_wrappers]

    stamp("3k done")
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
    others = [w.launches for w in counters[1:]] + w_launches()
    if launches != warmup + frames or any(others):
        raise SystemExit(f"chip_smoke: {launches} kernel launches for "
                         f"{warmup + frames} frames, {others} launches of "
                         f"B2, B3, B6, B4, B5, B7, W1, W2, W3 and the "
                         f"shadow rays")
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
    warmup, big_frames = 2, 10
    with plain_versions_refused():
        for _ in range(warmup):
            big_renderer.step(sync=True)
        # the timed frames' launches, waves and graph replays: the first
        # frame captured the graphs
        graph_kernels = (wf.trace_bricks_cuda, *w_wrappers,
                         ws.wave_drain_cuda)
        launches0 = [w.launches for w in graph_kernels]
        waves0 = big_renderer.waves
        replays0 = big_renderer._wave_cache.replays()
        drained0 = big_renderer._wave_cache.drained()
        big_ms = []
        for _ in range(big_frames):
            big_renderer.step(sync=True)
            big_ms.append(big_renderer.frame_ms)
    b2_launches, *main_w, drain_launches = (
        w.launches - n for w, n in zip(graph_kernels, launches0))
    w1_launches, w2_launches, w3_launches, _ = main_w
    waves = big_renderer.waves - waves0
    cache = big_renderer._wave_cache
    primary, group, drains = (cache.replays()[k] - replays0[k]
                              for k in ("primary", "group", "drain"))
    drained = {k: v - drained0[k] for k, v in cache.drained().items()}
    n_chunks = len(cache._chunks)
    # every graph replayed launches B2, W1, W2 and W3 once a wave: once
    # the primary graph, GROUP_WAVES a group's, and the drain's graph the
    # drain once; the waves traced outside the drain are those launches
    # but the dead ones after a chunk's live count reached zero in its
    # last group, in a frame that did not drain; no shadow ray without NEE
    launched = primary + wf.GROUP_WAVES * group
    group_waves = waves - drained["waves"]
    others = [w.launches for w in counters if w is not wf.trace_bricks_cuda]
    if (b2_launches != launched or primary != big_frames * n_chunks
            or drain_launches != drains
            or not group_waves <= launched
            <= group_waves + (wf.GROUP_WAVES - 1) * (primary - drains)
            or waves < big_frames or any(others)):
        raise SystemExit(f"chip_smoke: {b2_launches} B2 launches for "
                         f"{primary} primary and {group} group replays, "
                         f"{drain_launches} drain launches for {drains} "
                         f"drain replays, {waves} waves ({drained} in the "
                         f"drain), {others} launches of B1, B3, B6, B4, B5, "
                         f"B7 on the large scene")
    if main_w != [launched, launched, launched, 0]:
        raise SystemExit(f"chip_smoke: W1, W2, W3 and shadow-ray launches "
                         f"{main_w} for {launched} launches of B2 in "
                         f"{big_frames} frames")
    big_median = statistics.median(big_ms)
    big_msamples = MAIN_W * MAIN_H * SPP / (big_median * 1e-3) / 1e6
    print(f"large main path {MAIN_W}x{MAIN_H} spf {SPP} depth 50: "
          f"{big_frames} synced frames, median {big_median:.4f} ms, max "
          f"{max(big_ms):.4f} ms (min {min(big_ms):.4f}), "
          f"{big_msamples:.4f} Msamples/s, "
          f"{big_msamples * big_path_len:.4f} Mrays/s, "
          f"{waves / big_frames:.2f} waves per frame, avg path "
          f"length {big_path_len:.4f} rays/sample; B2 launches {b2_launches} "
          f"for {waves} waves ({primary} primary, {group} group and "
          f"{drains} drain graph replays; the drain's {drained}); scene "
          f"build {scene_build_s:.2f} s, "
          f"brick_data {big.brick_data.numel() * 4} bytes")
    big_img = big_renderer.hdr()
    if not (big_img.shape == (MAIN_H, MAIN_W, 3)
            and np.isfinite(big_img).all() and big_img.mean() > 0
            and big_img.std() > 0):
        raise SystemExit("chip_smoke: large-scene image is not finite and "
                         "non-flat")
    big_png = mk.BUILD_DIR / "chip_smoke_blob_box_x3.png"
    big_renderer.save_png(str(big_png))
    print(f"the main path's bounce step: W1 {w1_launches}, W2 "
          f"{w2_launches}, W3 {w3_launches} launches for {waves} waves, no "
          f"plain version run")
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
                   large_waves_per_frame=waves / big_frames,
                   large_avg_path_length=big_path_len,
                   b2_launches=b2_launches, w_launches=main_w,
                   drain_launches=drain_launches, drained=drained,
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
    others = [w.launches for w in counters
              if w is not bk.render_bricks_cuda] + w_launches()
    if b6_launches != warmup + big_frames or any(others) \
            or bricks_renderer.waves != 0:
        raise SystemExit(f"chip_smoke: {b6_launches} B6 launches for "
                         f"{warmup + big_frames} frames, {others} launches "
                         f"of B1, B2, B3, B4, B5, B7, W1, W2, W3 and the "
                         f"shadow rays in bricks mode")
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
    def drive_engine(scene, config, mode, wrapper, kernel, records):
        """Drive ``scene`` through ProgressiveRenderer with ``config``,
        which must take ``mode`` and launch only ``wrapper``'s trace kernel,
        once per wave, and the bounce step: W2 on every wave, W3 on every
        wave but a frame's first, and W1 on every wave where ``records``
        (the "mx" paths record their hits in torch ops)."""
        engine = config.wavefront_trace if mode == "wavefront" else mode
        renderer = ProgressiveRenderer(scene, big_cam, MAIN_W, MAIN_H, config,
                                       device="cuda")
        if renderer.mode != mode:
            raise SystemExit(f"chip_smoke: {engine} took {renderer.mode}")
        zero_counts()
        with plain_versions_refused():
            for _ in range(warmup):
                renderer.step(sync=True)
            ms = []
            for _ in range(big_frames):
                renderer.step(sync=True)
                ms.append(renderer.frame_ms)
        if any(c.engine.counted
               for c in renderer._wave_cache._chunks.values()):
            raise SystemExit(f"chip_smoke: {engine} ran counted")
        launches = wrapper.launches
        others = [w.launches for w in counters if w is not wrapper]
        if launches != renderer.waves or launches < warmup + big_frames \
                or any(others):
            raise SystemExit(f"chip_smoke: {launches} {kernel} launches for "
                             f"{renderer.waves} waves with {engine}, {others} "
                             f"launches of the other kernels")
        waves = renderer.waves
        step_launches = w_launches()
        if step_launches != [waves if records else 0, waves,
                             waves - warmup - big_frames, 0]:
            raise SystemExit(f"chip_smoke: W1, W2, W3 and shadow-ray "
                             f"launches {step_launches} for {waves} waves "
                             f"with {engine}")
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
            "w_launches": step_launches, "vs_default_engine": against}
        return launches, path

    b4_launches, slim2_png = drive_engine(
        big, RenderConfig(wavefront_trace="slim2"), "wavefront",
        wf.trace_bricks_slim2_cuda, "B4", True)
    b5_launches, pairs_png = drive_engine(
        big, RenderConfig(wavefront_trace="pairs"), "wavefront",
        pt.trace_pairs_cuda, "B5", True)
    b7_launches, mx2_png = drive_engine(
        big_pack, RenderConfig(large_scene_mode="mx2"), "mx2",
        mx2.trace_mx2_cuda, "B7", False)
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
        raise SystemExit("chip_smoke: the mx path launched a trace kernel: "
                         f"{[w.launches for w in counters]}")
    # its waves come in chunks (a wave is at most MX_MAX_RAYS_PER_WAVE
    # rays), each with a first wave that W3 does not key
    mx_w = w_launches()
    if not (mx_w[0] == mx_w[3] == 0 and mx_w[1] == mx_renderer.waves
            and 0 < mx_w[2] < mx_w[1]):
        raise SystemExit(f"chip_smoke: W1, W2, W3 and shadow-ray launches "
                         f"{mx_w} for {mx_renderer.waves} waves of the mx "
                         f"path")
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
          f"trace kernel launch (W2 {mx_w[1]}, W3 {mx_w[2]}); "
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

    stamp("4h done")
    # -- 4i. the tile and sample split (parallel/sharding.py) in a world of
    # one rank: each mode against the unsharded function, same call; an
    # "mx" frame takes 11-14 s even at 64x48 (its rounds, not its rays), so
    # it is timed on its two counted frames only.  Then gloo worlds of 2
    # and 4 spawned ranks on this card, against the same unsharded frames
    cbox_pack, cbox_parsed = load_scene(str(SCENES_DIR / "cbox_rect.xml"))
    cbox = DeviceScene.from_pack(cbox_pack).to(dev)
    cbox_cam = Camera.from_parsed(cbox_parsed.camera)
    mx_w, mx_h = 64, 48
    mx_depth_kw = {"max_depth": mx_depth}
    big_mx = mx_renderer.scene
    held = {"cbox": cbox, "big": big, "big_mx2": big_mx2, "big_mx": big_mx,
            "cbox_main": camera_ray_data(cbox_cam, MAIN_W, MAIN_H),
            "cbox_small": camera_ray_data(cbox_cam, SMALL_W, SMALL_H),
            "big_main": cd, "big_small": camera_ray_data(big_cam, mx_w, mx_h)}
    held = {k: torch.as_tensor(v).to(dev) if isinstance(v, np.ndarray)
            else v for k, v in held.items()}
    # (label, scene, camera, width, height, mode, kwargs, the unsharded
    # frame, the mode's kernel, timed frames beyond the counted one)
    specs = [
        ("xla cbox_rect", "cbox", "cbox_small", SMALL_W, SMALL_H, "xla", {},
         lambda: integrator.render_samples(cbox, held["cbox_small"], SMALL_W,
                                           SMALL_H, 0, SPP), None, 4),
        ("megakernel cbox_rect", "cbox", "cbox_main", MAIN_W, MAIN_H,
         "megakernel", {},
         lambda: mk.render_samples_megakernel(cbox, held["cbox_main"],
                                              MAIN_W, MAIN_H, 0, SPP),
         mk.megakernel_cuda, 4),
        ("bricks blob_box x3", "big", "big_main", MAIN_W, MAIN_H, "bricks",
         {}, lambda: bk.render_samples_bricks(big, cd, MAIN_W, MAIN_H, 0,
                                              SPP),
         bk.render_bricks_cuda, 4),
        *[(f"wavefront {trace}", "big", "big_main", MAIN_W, MAIN_H,
           "wavefront", {"trace": trace},
           lambda trace=trace: wf.render_samples_wavefront(
               big, cd, MAIN_W, MAIN_H, 0, SPP, trace=trace),
           {"slim": wf.trace_bricks_cuda,
            "slim2": wf.trace_bricks_slim2_cuda,
            "pairs": pt.trace_pairs_cuda}[trace], 4)
          for trace in ("slim", "slim2", "pairs")],
        ("mx2 blob_box x3", "big_mx2", "big_main", MAIN_W, MAIN_H, "mx2", {},
         lambda: mx2.render_samples_mx2(big_mx2, cd, MAIN_W, MAIN_H, 0, SPP),
         mx2.trace_mx2_cuda, 4),
        (f"mx blob_box x3 depth {mx_depth}", "big_mx", "big_small", mx_w,
         mx_h, "mx", mx_depth_kw,
         lambda: mxtrace.render_samples_mx(big_mx, held["big_small"], mx_w,
                                           mx_h, 0, SPP, **mx_depth_kw),
         None, 0),
    ]
    sharded, refs = sharded_phase(
        [(label, held[sc], held[cam], w, h, mode, kw, unsharded, kernel, n)
         for label, sc, cam, w, h, mode, kw, unsharded, kernel, n in specs],
        counters)
    results["sharded"] = sharded
    # 3 passes over two sample shards: the second renders 1 of its 2, so
    # B1 and B6 take n_real < n
    odd = [("megakernel cbox_rect spp 3", "cbox", "cbox_main", MAIN_W,
            MAIN_H, "megakernel", {}, mk.megakernel_cuda,
            lambda: mk.render_samples_megakernel(
                cbox, held["cbox_main"], MAIN_W, MAIN_H, 0, 3)),
           ("bricks blob_box x3 spp 3", "big", "big_main", MAIN_W, MAIN_H,
            "bricks", {}, bk.render_bricks_cuda,
            lambda: bk.render_samples_bricks(big, cd, MAIN_W, MAIN_H, 0, 3))]
    refs.update({c[0]: c[-1]().cpu() for c in odd})
    cases = [(label, sc, cam, w, h, mode, kw, spp,
              None if kernel is None else counters.index(kernel))
             for label, sc, cam, w, h, mode, kw, spp, kernel in
             [(*c[:7], SPP, c[8]) for c in specs]
             + [(*c[:7], 3, c[7]) for c in odd]]
    host = {k: v.to("cpu") for k, v in held.items()}
    del big, big_mx, big_mx2, mx_renderer, held, specs, odd
    torch.cuda.empty_cache()
    results["card_worlds"] = card_worlds(host, cases, refs, counters)
    del host

    stamp("4i done")
    # -- 4j. gradients on the card (grad/inverse.py, plain torch ops)
    results["grad"] = grad_phase(dev, counters)

    stamp("4j done")
    # -- 4k. the viewer (viewer/server.py) on the card: the rect Cornell box
    # at the main path's shape (B1), then the large scene's set from 3b in
    # bricks mode (B6), each beside its synced frame of phase 4 or 4c
    viewer_renderer = ProgressiveRenderer.from_xml(
        str(SCENES_DIR / "cbox_rect.xml"), width=MAIN_W, height=MAIN_H,
        device="cuda")
    results["viewer"] = [viewer_phase("cbox_rect", viewer_renderer,
                                      mk.megakernel_cuda, counters,
                                      median_ms)]
    viewer_renderer = ProgressiveRenderer(
        big_host, big_cam, MAIN_W, MAIN_H,
        RenderConfig(large_scene_mode="bricks"), device="cuda")
    if viewer_renderer.mode != "bricks":
        raise SystemExit(f"chip_smoke: viewer took {viewer_renderer.mode}")
    results["viewer"].append(viewer_phase(
        "blob_box_x3 bricks", viewer_renderer, bk.render_bricks_cuda,
        counters, bricks_median))
    del viewer_renderer
    torch.cuda.empty_cache()

    stamp("4k done")
    # -- 4l. the port's bench, cbox and bunny rows, in a subprocess
    results["bench"] = bench_phase()

    stamp("4l done")
    # -- 4m. the entry point, the scene printer and the native builders
    fn, fargs = entry_points.entry("cuda")
    entry_img = fn(*fargs)
    if entry_img.device.type != "cuda" or entry_img.shape != (120, 160, 3) \
            or not torch.isfinite(entry_img).all():
        raise SystemExit("chip_smoke: entry() gave no finite image on cuda")
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        rc = print_scene.main([str(SCENES_DIR / "cbox_rect.xml")])
    if rc != 0 or not printed.getvalue().startswith("Scene["):
        raise SystemExit("chip_smoke: print_scene failed")
    print(f"entry() on cuda: image {tuple(entry_img.shape)}, mean "
          f"{float(entry_img.mean()):.5f}; print_scene: "
          f"{len(printed.getvalue().splitlines())} lines")
    results["host"] = host_phase(big_parsed)

    stamp("4m done")
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
                     mx_png, cli_png,
                     *(Path(v["png"]) for v in results["viewer"])):
            shutil.copy(path, out / path.name)
        (out / "chip_smoke_results.json").write_text(
            json.dumps(results, indent=1))

    root = Path(__file__).resolve().parent
    kernels = [{
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
        # its counted form (3j) on the same wave and on a tail wave
        "counted": {w: {"rays": c["rays"], "class": c["class"],
                        "ms": c["times"]["B2"]["counted_ms"],
                        "plain_launch_ms": c["times"]["B2"]["kernel_ms"]}
                    for w, c in counted.items()},
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
    }]
    # the bounce step (3i): launches on the main path (4b), the shadow rays'
    # in 3i's NEE render; times on the sorted first-bounce wave of the large
    # main path, and W1-W3's in their counted form (3j).  No one PyTorch call computes any of them.
    wave_step_source = str(ws.SOURCE.resolve().relative_to(root))
    jax_wavefront = "pathtracer_cuda_interactive_tpu/ops/wavefront.py"
    for name, key, replaces, launched, err, w_bound in (
            ("wave_record", "W1", 249, w1_launches, w_err["record"],
             w1_bound),
            ("wave_shade", "W2", 469, w2_launches, w_err["shade"], w2_bound),
            ("wave_sort_key", "W3", 375, w3_launches, w_err["key"],
             w3_bound),
            ("wave_shadow_rays", "shadow", 434, shadow_launches,
             w_err["shadow_rays"], shadow_bound)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": wave_step_source,
            "replaces": f"{jax_wavefront}:{replaces}",
            "launches": launched,
            "max_abs_err": err,
            "ms": w_ms["bounce 1"][key]["ms"],
            "plain_ms": w_ms["bounce 1"][key]["plain_ms"],
            "counted": {w: {"rays": c["rays"], "class": c["class"],
                            "ms": c["times"][key]["counted_ms"],
                            "plain_launch_ms": c["times"][key]["kernel_ms"]}
                        for w, c in counted.items() if key in c["times"]},
            **w_bound,
            "library_ms": None,
        })
    # launches: the main path (4b); times: the drain of 3k
    kernels.append({
        "name": "wave_drain",
        "route": "cuda",
        "source": wave_step_source,
        "replaces": f"{jax_wavefront}:545 (the waves of the loop's tail)",
        "launches": drain_launches,
        "max_abs_err": drain_row["max_abs_err"],
        "ms": drain_row["ms"],
        "plain_ms": drain_row["plain_ms"],
        **drain_bound,
        "library_ms": None,
    })
    # launches on the sharded path (4i), in the order of ``counters``
    for entry, n in zip(kernels, sharded["launches"]):
        entry["sharded_launches"] = n
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
