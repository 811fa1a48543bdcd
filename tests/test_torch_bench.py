"""The port's bench (bench.py) at its CPU size: one ``--quick --device
cpu`` run in a subprocess, whose stdout must be exactly one JSON line with
the keys of the repo's bench.py, every timing and rate positive."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pathtracer_cuda_interactive_tpu_torch import bench

REPO = Path(__file__).resolve().parent.parent
RATES = ("cbox_synced_latency_ms", "cbox_synced_latency_max_ms",
         "cbox_synced_fps", "cbox_batched16_msamples_s", "cbox_avg_path_len",
         "cbox_mrays_s", "bunny_avg_path_len",
         *(f"bunny_{mode}_{key}" for mode in ("wavefront", "bricks")
           for key in ("msamples_s", "vs_baseline", "init_s",
                       "first_step_s", "mrays_s")))


@pytest.fixture(scope="module")
def quick_run():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "pathtracer_cuda_interactive_tpu_torch.bench",
         "--quick", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


def test_quick_cpu_run_prints_one_json_line(quick_run):
    lines = quick_run.splitlines()
    assert len(lines) == 1, lines
    out = json.loads(lines[0])
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert out["metric"] == "cbox_progressive_throughput"
    assert out["unit"] == "Msamples/s"
    assert out["value"] > 0 and out["vs_baseline"] > 0
    assert abs(out["vs_baseline"] - out["value"] / bench.BASE_CBOX) < 1e-12
    extra = out["extra"]
    for key in RATES:
        assert extra[key] > 0, key
    assert extra["device"] == "cpu" and extra["card"] is None
    assert extra["cbox_mode"] == "megakernel"
    assert extra["bunny_tris"] == 5132
    assert extra["bunny_mode"] in ("wavefront", "bricks")
    assert extra["bunny_trace"] == "slim+sig_mort"
    assert "stand-ins" in extra["scenes"]
    assert (extra["width"], extra["height"], extra["max_depth"]) == \
        (32, 24, 4)
    assert not any(k.startswith("buddha") for k in extra)


def test_unknown_row_is_refused():
    with pytest.raises(SystemExit):
        bench.main(["--rows", "cbox,teapot", "--device", "cpu"])


def test_bench_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the card is there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.run(["cbox"], bench.QUICK, "cuda")
