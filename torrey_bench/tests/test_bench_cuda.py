"""On the card: one short run of a cell through the benchmark's command,
and its result line.  Skips where there is no card (decided inside
the test).  Run it there with
``python3 -m pytest -m cuda torrey_bench/tests/test_bench_cuda.py``."""

import json
import subprocess
import sys

import pytest

from torrey_bench import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_cbox_run_on_the_card(trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "torrey_bench.run", "--workload",
         "cbox_rect-spf2", "--seed", "4294967311", "--seconds", "2",
         "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == 1
    if trace:
        assert {"kernel_ms", "kernel_roofline", "launches_per_frame",
                "device_idle_share"} <= set(line["metrics"])
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    else:
        assert set(line["metrics"]) == {"msamples_s", "frame_ms_p95",
                                        "setup_s"}
