"""Time this checkout's redesigned kernels against another commit's on one
CUDA card.

For a change to a kernel that must keep its outputs bit for bit: builds this
checkout's kernels and the brick trace (B2, B3), the brick render (B6), the
megakernel (B1) and the superbrick packet trace (B7) from the ``csrc``
directory of another commit.  That commit's launch functions keep their own
argument lists here: its B7 takes no superbrick boxes and counts four
things, this checkout's five.  Then, at the main path's 640x480, 2 samples:

* on scenes/blob_box.xml subdivided three levels (327,692 triangles): B2 on
  the primary wave, the first-bounce wave in the primary wave's order and
  the sorted first-bounce wave: (t, slot) must equal the other commit's bit
  for bit; both timed in turns (forward, then backward), by CUDA events; B3
  likewise, with and without counters; B6 on one depth-50 frame, images
  equal bit for bit, frames timed in turns;
* B7 on the primary wave and the "mort_oct"-sorted first-bounce wave of the
  same scene as an MX2Set: t, slot and the four counters both commits have
  equal bit for bit, both timed in turns;
* B1 on the rect Cornell box, the sphere scene, the point-light scene with
  NEE and the two larger tables of models/subdivide.py::table_scenes (42
  spheres with 128 triangles; 512 triangles), depth 50: images equal bit
  for bit, frames timed in turns.

Usage, from the root of a checkout, with the other commit unpacked beside
it (``git archive <commit> | tar -x -C _parent``, a git-ignored directory):

    python -m pathtracer_cuda_interactive_tpu_torch.render.walk_compare \\
        --parent _parent/pathtracer_cuda_interactive_tpu_torch/csrc \\
        [--out DIR] [--only b1,b7]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

WIDTH, HEIGHT, SPF, LEVELS = 640, 480, 2, 3
PTR, I32 = ctypes.c_void_p, ctypes.c_int


def _cuda_ms(fn, repeats: int) -> float:
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


def _in_turns(runs: dict, repeats: int) -> dict:
    """{name: [ms forward, ms backward]} of ``runs`` {name: fn}, each timed
    once in the dict's order and once in the reverse order."""
    times = {name: [] for name in runs}
    for name in (*runs, *reversed(runs)):
        times[name].append(_cuda_ms(runs[name], repeats))
    return times


def _report(label: str, times: dict, base: str) -> dict:
    med = {name: statistics.median(v) for name, v in times.items()}
    for name, ms in med.items():
        print(f"  {label} {name}: {ms:.4f} ms {times[name]} "
              f"({ms / med[base]:.3f} of {base})")
    return med


def _swapped(module, lib, fn):
    """``fn`` run with ``module``'s kernel library swapped for ``lib`` (of
    the same launch functions), so both commits go through one wrapper."""
    def run():
        ours, module._lib = module._lib, lib
        try:
            return fn()
        finally:
            module._lib = ours
    return run


def _load_like(path: Path, ours: ctypes.CDLL, names) -> ctypes.CDLL:
    """The library at ``path`` with the argument lists of ``ours``."""
    lib = ctypes.CDLL(str(path))
    for name in names:
        getattr(lib, name).argtypes = getattr(ours, name).argtypes
        getattr(lib, name).restype = I32
    return lib


class _ParentB7:
    """Kernel B7 of the other commit: no superbrick boxes, four counters."""

    def __init__(self, path: Path):
        self.launch = ctypes.CDLL(str(path)).pt_mx2_trace_launch
        self.launch.argtypes = ([PTR] * 6 + [I32, ctypes.c_float, PTR, I32]
                                + [PTR] * 3 + [I32] + [PTR] * 6)
        self.launch.restype = I32

    def trace(self, mx, org, dirn, tnear, brk, ent, cnt, collect_stats=False):
        n = int(org.x.numel())
        t = torch.empty(n, dtype=torch.float32, device="cuda")
        slot = torch.empty(n, dtype=torch.int32, device="cuda")
        stats = (torch.zeros(4, dtype=torch.int64, device="cuda")
                 if collect_stats else None)
        err = self.launch(*(c.data_ptr() for c in (*org, *dirn)), n, tnear,
                          mx.shift.data_ptr(), int(cnt.numel()),
                          brk.data_ptr(), ent.data_ptr(), cnt.data_ptr(),
                          int(mx.coeff.shape[0]), mx.subbox.data_ptr(),
                          mx.coeff.data_ptr(), t.data_ptr(), slot.data_ptr(),
                          stats.data_ptr() if collect_stats else None,
                          torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the other commit's B7: CUDA error {err}")
        return t, slot, stats


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="the csrc directory of the commit to compare with")
    ap.add_argument("--out", default=None,
                    help="also write the results into this directory")
    ap.add_argument("--only", default="walk,b7,b1",
                    help="which parts to run: walk (B2, B3, B6), b7, b1")
    args = ap.parse_args(argv)
    parts = set(args.only.split(","))

    from .. import SCENES_DIR
    from ..experiments import mx2
    from ..experiments.mx2set import MX2Set
    from ..io.xml_scene import parse_scene
    from ..models.bricks import BrickSet
    from ..models.device_scene import DeviceScene
    from ..models.scenepack import pack_scene
    from ..models.subdivide import subdivide_scene, table_scenes
    from ..ops import brickkernel as bk
    from ..ops import cuda_build
    from ..ops import megakernel as mk
    from ..ops import pairtrace as pt
    from ..ops import wavefront as wf
    from ..ops.camera import Camera, camera_ray_data
    from ..ops.integrator import MAX_DEPTH
    from .kernel_stats import capture_waves

    if not torch.cuda.is_available():
        raise SystemExit("walk_compare: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card)
    res = {"card": card, "b2": {}, "b3": {}, "b7": {}, "b1": {}}

    build_dir = cuda_build.BUILD_DIR / "compare"
    csrc = Path(args.parent).resolve()
    sources = [csrc / name for name in ("brick_trace.cu", "brick_render.cu",
                                        "megakernel.cu", "mx2_trace.cu")]
    print("the other commit's kernels:")
    cuda_build.build_all(sources, build_dir)
    print("this checkout's kernels:")
    cuda_build.build_all([wf.SOURCE, bk.SOURCE, mk.SOURCE, mx2.SOURCE])
    old_trace = _load_like(cuda_build.library_path(sources[0], build_dir),
                           wf.load_library(), ("pt_brick_trace_launch",
                                               "pt_brick_trace_full_launch"))
    old_render = _load_like(cuda_build.library_path(sources[1], build_dir),
                            bk.load_library(), ("pt_brick_render_launch",))
    old_mega = _load_like(cuda_build.library_path(sources[2], build_dir),
                          mk.load_library(), ("pt_megakernel_launch",))
    old_b7 = _ParentB7(cuda_build.library_path(sources[3], build_dir))
    mx2.load_library()

    parsed = subdivide_scene(parse_scene(str(SCENES_DIR / "blob_box.xml")),
                             levels=LEVELS)
    pack = pack_scene(parsed)
    cd = torch.from_numpy(camera_ray_data(Camera.from_parsed(parsed.camera),
                                          WIDTH, HEIGHT)).to("cuda")

    if "walk" in parts:
        bricks = BrickSet.from_pack(pack).to("cuda")
        table = bricks.walk_table()
        print(f"blob_box x{LEVELS}: {bricks.num_bricks} bricks, "
              f"{bricks.num_top} top nodes; walk table {table.nbytes} bytes "
              f"built in {table.build_s * 1e3:.2f} ms")
        sorted_waves = capture_waves(bricks, cd, WIDTH, HEIGHT, SPF,
                                     "sig_mort")
        fixed_waves = capture_waves(bricks, cd, WIDTH, HEIGHT, SPF, "none")
        waves = {"primary": sorted_waves[0], "bounce 1 fixed": fixed_waves[1],
                 "bounce 1 sorted": sorted_waves[1]}
        for wave, (org, dirn, tnear) in waves.items():
            print(f"{wave} wave, {org.x.numel()} rays:")
            new = lambda: wf.trace_bricks_cuda(bricks, *org, *dirn, tnear)
            old = _swapped(wf, old_trace, new)
            (t, slot), (ref_t, ref_slot) = new(), old()
            if not (_same_bits(t, ref_t) and torch.equal(slot, ref_slot)):
                raise SystemExit(f"walk_compare: B2 differs from the other "
                                 f"commit's on the {wave} wave")
            print(f"  B2 (t, slot) equal to the other commit's bit for bit "
                  f"on all {org.x.numel()} rays")
            res["b2"][wave] = _report(
                "B2", _in_turns({"parent": old, "new": new}, 20), "parent")

            full = lambda stats: (lambda: wf.trace_bricks_full_cuda(
                bricks, *org, *dirn, tnear, collect_stats=stats))
            rec, counts = full(True)()
            ref, ref_counts = _swapped(wf, old_trace, full(True))()
            if not (torch.equal(counts, ref_counts)
                    and _same_bits(torch.stack(rec), torch.stack(ref))):
                raise SystemExit(f"walk_compare: B3 differs from the other "
                                 f"commit's on the {wave} wave")
            print("  B3 records (16 channels) and counters equal to the "
                  "other commit's bit for bit")
            res["b3"][wave] = _report("B3", _in_turns({
                "parent": _swapped(wf, old_trace, full(False)),
                "new": full(False),
                "parent counters": _swapped(wf, old_trace, full(True)),
                "new counters": full(True)}, 20), "parent")

        # B6: one depth-50 frame of the main path
        new = lambda: bk.render_samples_bricks(bricks, cd, WIDTH, HEIGHT, 0,
                                               SPF)
        old = _swapped(bk, old_render, new)
        if not _same_bits(new(), old()):
            raise SystemExit("walk_compare: B6's image differs from the "
                             "other commit's")
        print(f"B6 frame {WIDTH}x{HEIGHT}, {SPF} spp, depth {MAX_DEPTH}: "
              f"image equal to the other commit's bit for bit")
        res["b6"] = _report("B6", _in_turns({"parent": old, "new": new}, 5),
                            "parent")
        del bricks, table, waves, sorted_waves, fixed_waves

    if "b7" in parts:
        # B7 on its own path's waves: the bounce wave sorted by "mort_oct"
        mxs = MX2Set.from_pack(pack).to("cuda")
        waves = []

        def recording(m, org, dirn, tnear):
            waves.append((org, dirn, tnear))
            return mx2.trace_wave_mx2(m, org, dirn, tnear)

        mx2.render_samples_mx2(mxs, cd, WIDTH, HEIGHT, 0, SPF, max_depth=2,
                               tracer=recording)
        for wave, (org, dirn, tnear) in zip(("primary", "bounce 1 mort_oct"),
                                            waves):
            brk, ent, cnt = pt.visit_lists(mxs, org, dirn, tnear, 1)
            t, slot, seen = mx2.trace_mx2_cuda(mxs, *org, *dirn, tnear, brk,
                                               ent, cnt, collect_stats=True)
            ref_t, ref_slot, ref_seen = old_b7.trace(mxs, org, dirn, tnear,
                                                     brk, ent, cnt, True)
            if not (_same_bits(t, ref_t) and torch.equal(slot, ref_slot)
                    and seen[:4].tolist() == ref_seen.tolist()):
                raise SystemExit(f"walk_compare: B7 differs from the other "
                                 f"commit's on the {wave} wave: counters "
                                 f"{seen.tolist()} against "
                                 f"{ref_seen.tolist()}")
            listed, visited, voted, tested, boxed_out = seen.tolist()
            print(f"{wave} wave, {org.x.numel()} rays in {cnt.numel()} "
                  f"packets: B7 (t, slot) and the counters (listed {listed}, "
                  f"visited {visited}, voted {voted}, tested {tested}) equal "
                  f"to the other commit's bit for bit; {boxed_out} visits "
                  f"({boxed_out / max(visited, 1):.4f}) ended at the "
                  f"superbrick's own box")
            res["b7"][wave] = _report("B7", _in_turns({
                "parent": lambda: old_b7.trace(mxs, org, dirn, tnear, brk,
                                               ent, cnt),
                "new": lambda: mx2.trace_mx2_cuda(mxs, *org, *dirn, tnear,
                                                  brk, ent, cnt)}, 10),
                "parent")
            res["b7"][wave]["counters"] = seen.tolist()
        del mxs, waves

    if "b1" in parts:
        # B1: the small-scene frame, on every kind of table
        small = {name: parse_scene(str(SCENES_DIR / f"{name}.xml"))
                 for name in ("cbox_rect", "spheres", "pointlight")}
        small.update(table_scenes(small["cbox_rect"]))
        for name, scene_parsed in small.items():
            scene = DeviceScene.from_pack(pack_scene(scene_parsed)).to("cuda")
            small_cd = torch.from_numpy(camera_ray_data(
                Camera.from_parsed(scene_parsed.camera), WIDTH,
                HEIGHT)).to("cuda")
            nee = name == "pointlight"
            new = lambda: mk.render_samples_megakernel(
                scene, small_cd, WIDTH, HEIGHT, 0, SPF, nee=nee)
            old = _swapped(mk, old_mega, new)
            if not _same_bits(new(), old()):
                raise SystemExit(f"walk_compare: B1's image of {name} "
                                 f"differs from the other commit's")
            print(f"B1 frame {name} ({scene.num_spheres} spheres, "
                  f"{scene.num_triangles} triangles, nee={nee}) "
                  f"{WIDTH}x{HEIGHT}, {SPF} spp, depth {MAX_DEPTH}: image "
                  f"equal to the other commit's bit for bit")
            runs = {"parent": old, "new": new}
            times = _in_turns(runs, 20)
            for which, more in _in_turns(runs, 20).items():
                times[which] += more
            res["b1"][name] = _report(f"B1 {name}", times, "parent")

    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "walk_compare.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
