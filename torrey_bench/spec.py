"""What a cell is, read from ``BENCHMARK.json`` and the files it names.

Every piece that belongs to one configuration, one traffic mix or one
metric sits in a file of its own, found by the name ``BENCHMARK.json``
gives it, so a later cell, mix or metric is a new file and an edit of
none:

* ``configs/<config>.json``: the scene, its sizes, the yardstick's data
  (fixed work, the check's budget and limits) and, under
  ``render_config``, the ``RenderConfig`` settings the deployment fixes
  (such as ``enable_nee``: whether its point lights are sampled);
* ``traffic/<traffic>.json``: the ``RenderConfig`` settings the user's
  traffic sets (``render_config``), the warm-up frames and the camera
  motion's name;
* ``motions/<motion>.py``: a ``before_frame(renderer, frame, rng)``
  function that moves the camera (or not) before each timed frame;
* ``metrics/<metric>.py``: a ``read(run)`` function that returns the
  metric's value from the run's record, or None where it finds nothing.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

from . import BENCH_DIR, ROOT


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    render_config: dict     # the configuration's and the traffic's, merged
    end_to_end: list        # BENCHMARK.json entries reported with --trace 0
    per_layer: list         # ... with --trace 1, those listing this cell
    motion: ModuleType


def load_module(path: Path) -> ModuleType:
    """Import the file ``path`` as a module of its own (a name may hold a
    dot, which a package import would take for a subpackage)."""
    spec = importlib.util.spec_from_file_location(
        f"torrey_bench._{path.parent.name}_{path.stem.replace('.', '_')}",
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _for_cell(metric: dict, cell: str, end_to_end: dict) -> bool:
    """Whether ``metric`` is reported in ``cell``: its ``workloads`` list,
    or, without one, every cell that reports the end-to-end metric it
    moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moved = end_to_end.get(metric.get("moves"))
    return moved is None or "workloads" not in moved \
        or cell in moved["workloads"]


def check_scene_files(config: dict, bench_dir: Path = BENCH_DIR) -> None:
    """Raise unless every scene file has the sha256 the configuration
    records: the yardstick's inputs are frozen."""
    for rel, digest in config["scene_files"].items():
        got = hashlib.sha256((bench_dir / rel).read_bytes()).hexdigest()
        if got != digest:
            raise RuntimeError(f"{rel}: sha256 {got}, the configuration "
                               f"records {digest}")


def merge_render_config(config: dict, traffic: dict, config_file: str,
                        traffic_file: str) -> dict:
    """The ``RenderConfig`` settings of a cell: the configuration's
    ``render_config`` and the traffic's together.  A key that both set
    raises, naming both files: neither overrides the other."""
    ours = config.get("render_config", {})
    theirs = traffic.get("render_config", {})
    both = sorted(set(ours) & set(theirs))
    if both:
        raise ValueError(f"render_config {both} set in both {config_file} "
                         f"and {traffic_file}")
    return {**ours, **theirs}


def load_cell(name: str, root: Path = ROOT,
              bench_dir: Path = BENCH_DIR) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    config_file = f"configs/{w['config']}.json"
    traffic_file = f"traffic/{w['traffic']}.json"
    config = json.loads((bench_dir / config_file).read_text())
    traffic = json.loads((bench_dir / traffic_file).read_text())
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        render_config=merge_render_config(config, traffic, config_file,
                                          traffic_file),
        end_to_end=[m for m in bench["end_to_end"]
                    if "workloads" not in m or name in m["workloads"]],
        per_layer=[m for m in bench["per_layer"]
                   if _for_cell(m, name, e2e)],
        motion=load_module(bench_dir / "motions"
                           / f"{traffic['motion']}.py"))


def read_metrics(entries: list, run: dict,
                 bench_dir: Path = BENCH_DIR) -> dict:
    """{name: {"value", "unit"}} of every metric in ``entries`` whose
    reader (``metrics/<name>.py``) finds something in ``run``."""
    out = {}
    for m in entries:
        value = load_module(bench_dir / "metrics"
                            / f"{m['name']}.py").read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
