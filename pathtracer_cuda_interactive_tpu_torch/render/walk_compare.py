"""Time the brick walk's kernels against another commit's on one CUDA card.

For a change to csrc/brick_walk.cuh, csrc/brick_trace.cu (kernels B2, B3)
or csrc/brick_render.cu (kernel B6): builds this checkout's kernels and the
same three and the megakernel (B1, which shares headers) from the ``csrc``
directory of another commit, whose launch functions take the brick set's
own tensors (top_boxes, top_links, brick_data) where this checkout's take
the walk table.  Then, on scenes/blob_box.xml subdivided three levels
(327,692 triangles) at the main path's 640x480, 2 samples:

* B2 on the primary wave, the first-bounce wave in the primary wave's
  order and the sorted first-bounce wave: (t, slot) must equal the other
  commit's bit for bit; both timed in turns (forward, then backward), by
  CUDA events;
* B3 likewise, with and without counters;
* B6 on one depth-50 frame: images equal bit for bit, frames timed in turns;
* B1 on the rect Cornell box, both commits in turns.

Usage, from the root of a checkout, with the other commit unpacked beside
it (``git archive <commit> | tar -x -C _parent``, a git-ignored directory):

    python -m pathtracer_cuda_interactive_tpu_torch.render.walk_compare \\
        --parent _parent/pathtracer_cuda_interactive_tpu_torch/csrc \\
        [--out DIR]
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


class _ParentKernels:
    """The brick kernels and the megakernel of another commit's csrc
    directory, whose brick launch functions take the set's own tensors."""

    def __init__(self, csrc: Path, build_dir: Path):
        from ..ops import cuda_build
        sources = [csrc / name for name in ("brick_trace.cu",
                                            "brick_render.cu",
                                            "megakernel.cu")]
        cuda_build.build_all(sources, build_dir)
        trace, render, mega = (
            ctypes.CDLL(str(cuda_build.library_path(s, build_dir)))
            for s in sources)
        self.b2 = trace.pt_brick_trace_launch
        self.b2.argtypes = [PTR] * 6 + [I32, ctypes.c_float] + [PTR] * 6
        self.b3 = trace.pt_brick_trace_full_launch
        self.b3.argtypes = ([PTR] * 6 + [I32, ctypes.c_float, PTR, PTR, I32]
                            + [PTR] * 6)
        self.b6 = render.pt_brick_render_launch
        self.b6.argtypes = ([PTR, I32] + [PTR] * 6 + [I32] * 4
                            + [ctypes.c_uint, I32, I32, ctypes.c_uint, I32,
                               I32, PTR])
        for fn in (self.b2, self.b3, self.b6):
            fn.restype = I32
        self.megakernel = mega

    @staticmethod
    def _set(bricks):
        return (bricks.top_boxes.data_ptr(), bricks.top_links.data_ptr(),
                bricks.brick_data.data_ptr())

    @staticmethod
    def _stream():
        return torch.cuda.current_stream().cuda_stream

    def trace(self, bricks, org, dirn, tnear):
        n = int(org.x.numel())
        t = torch.empty(n, dtype=torch.float32, device="cuda")
        slot = torch.empty(n, dtype=torch.int32, device="cuda")
        err = self.b2(*(c.data_ptr() for c in (*org, *dirn)), n, tnear,
                      *self._set(bricks), t.data_ptr(), slot.data_ptr(),
                      self._stream())
        if err:
            raise RuntimeError(f"the other commit's B2: CUDA error {err}")
        return t, slot

    def trace_full(self, bricks, org, dirn, tnear, collect_stats):
        n = int(org.x.numel())
        out = torch.empty((16, n), dtype=torch.float32, device="cuda")
        counts = (torch.empty((3, n), dtype=torch.int32, device="cuda")
                  if collect_stats else None)
        err = self.b3(*(c.data_ptr() for c in (*org, *dirn)), n, tnear, None,
                      bricks.sph_rows.data_ptr(), bricks.num_spheres,
                      *self._set(bricks), out.data_ptr(),
                      counts.data_ptr() if collect_stats else None,
                      self._stream())
        if err:
            raise RuntimeError(f"the other commit's B3: CUDA error {err}")
        return out, counts

    def render(self, bricks, cam, bg, width, height, n_tiles, sample_start,
               num_samples, seed, max_depth, rr_start_depth):
        out = torch.zeros((height, width, 3), dtype=torch.float32,
                          device="cuda")
        err = self.b6(bricks.sph_rows.data_ptr(), bricks.num_spheres,
                      *self._set(bricks), cam.data_ptr(), bg.data_ptr(),
                      out.data_ptr(), width, height, 0, n_tiles, sample_start,
                      num_samples, -1, seed, max_depth, rr_start_depth,
                      self._stream())
        if err:
            raise RuntimeError(f"the other commit's B6: CUDA error {err}")
        return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="the csrc directory of the commit to compare with")
    ap.add_argument("--out", default=None,
                    help="also write the results into this directory")
    args = ap.parse_args(argv)

    from .. import SCENES_DIR
    from ..io.xml_scene import parse_scene
    from ..models.bricks import BrickSet
    from ..models.device_scene import DeviceScene
    from ..models.scenepack import load_scene, pack_scene
    from ..models.subdivide import subdivide_scene
    from ..ops import brickkernel as bk
    from ..ops import cuda_build
    from ..ops import megakernel as mk
    from ..ops import wavefront as wf
    from ..ops.camera import Camera, camera_ray_data
    from ..ops.integrator import MAX_DEPTH, RR_START_DEPTH
    from .kernel_stats import capture_waves

    if not torch.cuda.is_available():
        raise SystemExit("walk_compare: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card)
    res = {"card": card, "b2": {}, "b3": {}}

    build_dir = cuda_build.BUILD_DIR / "compare"
    print("the other commit's kernels:")
    parent = _ParentKernels(Path(args.parent).resolve(), build_dir)
    print("this checkout's kernels:")
    wf.load_library()
    bk.load_library()
    ours = mk.load_library()
    parent.megakernel.pt_megakernel_launch.argtypes = \
        ours.pt_megakernel_launch.argtypes
    parent.megakernel.pt_megakernel_launch.restype = I32

    parsed = subdivide_scene(parse_scene(str(SCENES_DIR / "blob_box.xml")),
                             levels=LEVELS)
    bricks = BrickSet.from_pack(pack_scene(parsed)).to("cuda")
    table = bricks.walk_table()
    print(f"blob_box x{LEVELS}: {bricks.num_bricks} bricks, {bricks.num_top} "
          f"top nodes; walk table {table.nbytes} bytes built in "
          f"{table.build_s * 1e3:.2f} ms")
    cd = torch.from_numpy(camera_ray_data(Camera.from_parsed(parsed.camera),
                                          WIDTH, HEIGHT)).to("cuda")
    sorted_waves = capture_waves(bricks, cd, WIDTH, HEIGHT, SPF, "sig_mort")
    fixed_waves = capture_waves(bricks, cd, WIDTH, HEIGHT, SPF, "none")
    waves = {"primary": sorted_waves[0], "bounce 1 fixed": fixed_waves[1],
             "bounce 1 sorted": sorted_waves[1]}

    for wave, (org, dirn, tnear) in waves.items():
        print(f"{wave} wave, {org.x.numel()} rays:")
        new = lambda: wf.trace_bricks_cuda(bricks, *org, *dirn, tnear)
        old = lambda: parent.trace(bricks, org, dirn, tnear)
        (t, slot), (ref_t, ref_slot) = new(), old()
        differ = int(((t.view(torch.int32) != ref_t.view(torch.int32))
                      | (slot != ref_slot)).sum())
        if differ:
            raise SystemExit(f"walk_compare: B2 differs from the other "
                             f"commit's on {differ} rays of the {wave} wave")
        print(f"  B2 (t, slot) equal to the other commit's bit for bit on "
              f"all {org.x.numel()} rays")
        res["b2"][wave] = _report("B2", _in_turns({"parent": old, "new": new},
                                                  20), "parent")

        ref, ref_counts = parent.trace_full(bricks, org, dirn, tnear, True)
        rec, counts = wf.trace_bricks_full_cuda(bricks, *org, *dirn, tnear,
                                                collect_stats=True)
        if not (torch.equal(counts, ref_counts)
                and torch.equal(torch.stack(rec).view(torch.int32),
                                ref.view(torch.int32))):
            raise SystemExit(f"walk_compare: B3 differs from the other "
                             f"commit's on the {wave} wave")
        print("  B3 records (16 channels) and counters equal to the other "
              "commit's bit for bit")
        res["b3"][wave] = _report("B3", _in_turns({
            "parent": lambda: parent.trace_full(bricks, org, dirn, tnear,
                                                False),
            "new": lambda: wf.trace_bricks_full_cuda(bricks, *org, *dirn,
                                                     tnear),
            "parent counters": lambda: parent.trace_full(bricks, org, dirn,
                                                         tnear, True),
            "new counters": lambda: wf.trace_bricks_full_cuda(
                bricks, *org, *dirn, tnear, collect_stats=True)}, 20),
            "parent")

    # B6: one depth-50 frame of the main path
    cam = cd.reshape(12).contiguous()
    bg = torch.stack([bricks.bg_r, bricks.bg_g, bricks.bg_b])
    n_tiles = bk.tile_grid(WIDTH, HEIGHT)
    old = lambda: parent.render(bricks, cam, bg, WIDTH, HEIGHT, n_tiles, 0,
                                SPF, 1984, MAX_DEPTH, RR_START_DEPTH)
    new = lambda: bk.render_samples_bricks(bricks, cd, WIDTH, HEIGHT, 0, SPF)
    if not torch.equal(new().view(torch.int32), old().view(torch.int32)):
        raise SystemExit("walk_compare: B6's image differs from the other "
                         "commit's")
    print(f"B6 frame {WIDTH}x{HEIGHT}, {SPF} spp, depth {MAX_DEPTH}: image "
          f"equal to the other commit's bit for bit")
    res["b6"] = _report("B6", _in_turns({"parent": old, "new": new}, 5),
                        "parent")

    # B1, which shares headers with B6: the small-scene frame
    pack, small = load_scene(str(SCENES_DIR / "cbox_rect.xml"))
    scene = DeviceScene.from_pack(pack).to("cuda")
    small_cd = torch.from_numpy(camera_ray_data(
        Camera.from_parsed(small.camera), WIDTH, HEIGHT)).to("cuda")

    def b1(lib):
        def run():
            mk._lib = lib
            try:
                return mk.render_samples_megakernel(scene, small_cd, WIDTH,
                                                    HEIGHT, 0, SPF)
            finally:
                mk._lib = ours
        return run

    if not torch.equal(b1(parent.megakernel)(), b1(ours)()):
        raise SystemExit("walk_compare: B1's image differs from the other "
                         "commit's")
    print(f"B1 frame cbox_rect {WIDTH}x{HEIGHT}, {SPF} spp, depth "
          f"{MAX_DEPTH}: image equal to the other commit's bit for bit")
    runs = {"parent": b1(parent.megakernel), "new": b1(ours)}
    times = _in_turns(runs, 20)
    for name, more in _in_turns(runs, 20).items():
        times[name] += more
    res["b1"] = _report("B1", times, "parent")

    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "walk_compare.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
