"""A new traffic mix, a new per-layer metric and a new configuration with
render settings of its own are files that the harness finds by name:
placed in a copy of the harness's folders, with no file that is there
edited, they run."""

import dataclasses
import hashlib
import json
import shutil

import pytest

from torrey_bench import BENCH_DIR, ROOT, fixed_work, program, roofline, run
from torrey_bench import spec


def _digests(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in folder.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def _copy(tmp_path):
    """A copy of the harness's folders and its files' digests."""
    bench = tmp_path / "torrey_bench"
    shutil.copytree(BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return bench, _digests(bench)


def test_new_traffic_and_metric_are_found_by_name(tmp_path):
    bench, before = _copy(tmp_path)
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


# a configuration that samples its scene's point light (next-event
# estimation), at the size of a CPU test: blob_box.xml unsubdivided, 16x12,
# depth 3
NEE_SIZE = {"width": 16, "height": 12, "max_depth": 3, "subdivide_levels": 0}


def _add_nee_configuration(tmp_path, bench):
    """Place ``configs/blob_box_nee.json`` (``render_config`` with
    ``enable_nee``, its fixed work counted by fixed_work.py, shadow rays
    included), a traffic that sets ``enable_nee`` too, and a BENCHMARK.json
    with a cell of each: new files alone.  Returns the configuration."""
    config = json.loads((bench / "configs" / "blob_box_x3.json").read_text())
    config.update(NEE_SIZE, name="blob_box_nee", triangles=5132,
                  render_config={"enable_nee": True})
    config["fixed_work"] = fixed_work.count(config, 48)
    (bench / "configs" / "blob_box_nee.json").write_text(json.dumps(config))
    (bench / "traffic" / "still-spf2-nee.json").write_text(json.dumps({
        "name": "still-spf2-nee", "why": "NEE set by the traffic too",
        "motion": "still",
        "render_config": {"samples_per_frame": 2, "enable_nee": False},
        "warmup_frames": 1}))
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "blob_box_nee", "source": "test",
                           "file": "torrey_bench/configs/blob_box_nee.json",
                           "reduced": [], "why": "test"})
    for traffic in ("still-spf2", "still-spf2-nee"):
        doc["workloads"].append({"name": f"blob_box_nee-{traffic}",
                                 "config": "blob_box_nee",
                                 "traffic": traffic, "chips": 1,
                                 "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    return config


def test_nee_configuration_is_new_files(tmp_path, monkeypatch):
    """A point-lit configuration that samples its light: it loads with the
    traffic's settings and its own merged, its shadow work counts in the
    least frame time, and a run on the CPU is checked against the
    reference with NEE and reads correct.  The program rendering with NEE
    off fails the check; a traffic that sets ``enable_nee`` as well
    raises at load, naming both files."""
    bench, before = _copy(tmp_path)
    config = _add_nee_configuration(tmp_path, bench)
    after = _digests(bench)
    assert all(after[p] == d for p, d in before.items())

    fixed = config["fixed_work"]
    assert fixed["shadow_rays_per_sample"] > 0
    assert fixed["shadow_box_tests_per_ray"] > 0
    unlit = {k: v for k, v in fixed.items() if not k.startswith("shadow_")}
    assert roofline.frame_work(fixed, 16, 12, 2)[0] \
        > roofline.frame_work(unlit, 16, 12, 2)[0]

    name = "blob_box_nee-still-spf2"
    cell = spec.load_cell(name, root=tmp_path, bench_dir=bench)
    assert cell.render_config == {"enable_nee": True, "samples_per_frame": 2}
    assert program.render_config(cell, 5, program.sizes(cell)).enable_nee
    out = run.measure(cell, 2 ** 35 + 9, 0.5, False, device="cpu")
    assert out["correct"], out["rows"]

    render_config = program.render_config
    monkeypatch.setattr(program, "render_config", lambda *a: dataclasses.
                        replace(render_config(*a), enable_nee=False))
    out = run.measure(cell, 2 ** 35 + 9, 0.5, False, device="cpu")
    assert not out["correct"], out["rows"]

    with pytest.raises(ValueError, match="configs/blob_box_nee.json.*"
                       "traffic/still-spf2-nee.json"):
        spec.load_cell("blob_box_nee-still-spf2-nee", root=tmp_path,
                       bench_dir=bench)
