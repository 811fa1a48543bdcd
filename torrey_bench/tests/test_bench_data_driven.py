"""A new traffic mix and a new per-layer metric are files that the harness
finds by name: placed in a copy of the harness's folders, with no file
that is there edited, they run."""

import hashlib
import json
import shutil

from torrey_bench import BENCH_DIR, ROOT, run, spec


def _digests(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in folder.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_traffic_and_metric_are_found_by_name(tmp_path):
    bench = tmp_path / "torrey_bench"
    shutil.copytree(BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _digests(bench)
    (bench / "traffic" / "still-spf1.json").write_text(json.dumps({
        "name": "still-spf1", "why": "one sample a frame",
        "motion": "still", "render_config": {"samples_per_frame": 1},
        "warmup_frames": 1}))
    (bench / "metrics" / "frames_in_window.py").write_text(
        "def read(run):\n    return len(run['frames_ms'])\n")
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["workloads"].append({"name": "cbox_rect-spf1", "config": "cbox_rect",
                             "traffic": "still-spf1", "chips": 1,
                             "why": "test"})
    doc["per_layer"].append({"name": "frames_in_window", "unit": "frames",
                             "better": "higher", "source": "host_clock",
                             "layer": "progressive step",
                             "moves": "msamples_s",
                             "workloads": ["cbox_rect-spf1"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    after = _digests(bench)
    assert all(after[p] == d for p, d in before.items())

    cell = spec.load_cell("cbox_rect-spf1", root=tmp_path, bench_dir=bench)
    assert cell.traffic["render_config"] == {"samples_per_frame": 1}
    assert [m["name"] for m in cell.per_layer][-1] == "frames_in_window"
    out = run.measure(cell, 11, 0.5, True, device="cpu",
                      overrides={"width": 16, "height": 12, "max_depth": 3})
    got = spec.read_metrics(cell.per_layer, out["run"], bench_dir=bench)
    assert got["frames_in_window"]["value"] == out["attempted"] > 0
    assert out["run"]["spf"] == 1
    # the other cells do not list it
    other = spec.load_cell("cbox_rect-spf2", root=tmp_path, bench_dir=bench)
    assert "frames_in_window" not in [m["name"] for m in other.per_layer]
