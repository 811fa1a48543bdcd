"""Run one cell of the port's benchmark and print its result line.

    python3 -m torrey_bench.run --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up (imports, the kernel libraries, the
scene build and upload, the warm-up frames) is timed from the start of this
module; then ``ProgressiveRenderer.step(sync=True)`` runs back to back for
``--seconds``, each frame after the traffic's camera move (with ``--trace
1`` as ``step(sync=False)`` and a sync, a few frames of it under
``torch.profiler``); then what the window added to the accumulation since
the camera last moved is compared with the plain reference (check.py).  The
last line on stdout is one JSON object; the numbers compared, each with its
limit, are the last lines on stderr and the result's last key.  With no
CUDA card, or fewer than the cell asks for, it exits 2 and prints no
result; with JAX or the JAX package loaded after the window, 3.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from . import ROOT  # noqa: E402

# every build and kernel cache inside the checkout, at fixed paths (the
# port's own libraries go to its _build/ beside the package)
CACHE = ROOT / ".bench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")

FORBIDDEN = ("jax", "jaxlib", "flax", "pathtracer_cuda_interactive_tpu")


def loaded_forbidden() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def measure(cell, seed: int, seconds: float, traced: bool,
            device: str = "cuda", overrides: dict | None = None,
            t_process: float = T_PROCESS) -> dict:
    """Set-up, the window and the check of one run.  Returns the record
    the metric readers take (``run``) with the check's numbers, their
    rows against the limits, ``correct``, the frames attempted and the
    memory peak.  ``overrides`` shrink the frame for the CPU tests."""
    import torch

    from . import check, program, spec, tracing
    from .roofline import least_ms

    spec.check_scene_files(cell.config)
    s = program.setup(cell, seed, device, overrides)
    program.warm_up(s, int(cell.traffic["warmup_frames"]))
    if traced and device == "cuda":
        # the profiler's own first start, outside the window
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            s.renderer.step(sync=True)
    setup_s = time.perf_counter() - t_process
    rec = program.run_window(s, cell, seed, seconds, traced)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    print(f"{cell.name}: {program.frame_summary(rec['frames_ms'])}, window "
          f"{rec['window_s']!r} s, set-up {setup_s!r} s", file=sys.stderr)

    size = program.sizes(cell, overrides)
    fixed = cell.config["fixed_work"]
    pix = check.pick_tiles(cell, size, rec["samples"], seed)
    prog = program.tile_sums(rec.pop("added"), pix)
    spans, spf = s.spans, s.spf
    del s               # the program's state is freed before the reference
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref_sum, ref_sq = check.reference_sums(
        cell, size, pix, rec["first_sample"], rec["samples"], seed, device,
        rec["camera"])
    numbers = check.gaps(prog, ref_sum, ref_sq, rec["samples"])
    correct, rows = check.judge(numbers, cell.config["check"]["limits"])
    print(f"check: {len(pix)} pixels x {rec['samples']} samples from "
          f"{rec['first_sample']}; reference "
          f"{time.perf_counter() - t0!r} s", file=sys.stderr)
    run = {"width": size["width"], "height": size["height"], "spf": spf,
           "frames_ms": rec["frames_ms"], "window_s": rec["window_s"],
           "setup_s": setup_s, "spans": spans,
           "step_host_ms": rec["step_host_ms"], "fixed_work": fixed,
           "least_ms": least_ms(fixed, size["width"], size["height"],
                                spf)[0],
           "trace": (tracing.digest(rec["events"])
                     if rec["events"] is not None else None)}
    return {"run": run, "numbers": numbers, "rows": rows,
            "correct": correct, "attempted": len(rec["frames_ms"]),
            "peak": peak}


def result_line(cell, out: dict, traced: bool, device: dict) -> dict:
    """The result's JSON object, its compared numbers last."""
    from . import spec, tracing
    run = out["run"]
    entries = cell.per_layer if traced else cell.end_to_end
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": 0, "metrics": spec.read_metrics(entries, run),
            "device": dict(device, memory_peak_bytes=out["peak"])}
    if traced and run["trace"] is not None:
        d = run["trace"]
        line["device"]["busy_s"] = d["busy_us"] / 1e6
        line["device"]["window_s"] = d["window_us"] / 1e6
        line["breakdown"] = tracing.breakdown(d)
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in out["rows"]}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from . import spec
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"torrey_bench: {args.workload} needs {cell.chips} CUDA "
              "card(s); none or too few here", file=sys.stderr)
        return 2
    out = measure(cell, args.seed, args.seconds, bool(args.trace))
    found = loaded_forbidden()
    if found:
        print(f"torrey_bench: loaded after the window: {found}",
              file=sys.stderr)
        return 3
    limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {limit}", file=sys.stderr)
    line = result_line(cell, out, bool(args.trace),
                       {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        "count": cell.chips})
    for name, value, lim in out["rows"]:
        print(f"{name} {value!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
