"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port.  Top-level module names are compared
whole: the port's name begins with the JAX package's."""

import ast
import json
import subprocess
import sys

from torrey_bench import BENCH_DIR, ROOT

JAX_NAMES = {"jax", "jaxlib", "flax", "pathtracer_cuda_interactive_tpu"}
PORT = "pathtracer_cuda_interactive_tpu_torch"

CPU_RUN = """
import json, sys, torch
torch.set_num_threads(2)
from torrey_bench import run, spec
cell = spec.load_cell("cbox_rect-spf2")
out = run.measure(cell, 3, 0.5, False, device="cpu",
                  overrides={"width": 16, "height": 12, "max_depth": 3})
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = """
import json, sys, numpy as np, torch
from torrey_bench import reference
scene, cam, _ = reference.build_scene("torrey_bench/scenes/cbox_rect.xml")
cd = torch.as_tensor(reference.camera_ray_data(cam, 8, 6))
reference.pixel_sample_sums(scene, cd, np.arange(48), 8, 6, 0, 1, 5, 3)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level_modules(script: str) -> set:
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_cpu_run_loads_no_jax():
    loaded = _top_level_modules(CPU_RUN)
    assert PORT in loaded
    assert not loaded & JAX_NAMES


def test_the_reference_loads_nothing_of_the_port():
    loaded = _top_level_modules(REFERENCE)
    assert not loaded & (JAX_NAMES | {PORT})


def test_no_source_of_the_reference_imports_the_port_or_jax():
    for path in (BENCH_DIR / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in JAX_NAMES | {PORT}, \
                    f"{path.name} imports {name}"


def test_run_refuses_without_a_card_or_with_jax(monkeypatch):
    """No card: exit 2 and no result on stdout.  The check on loaded
    modules finds the JAX package by its whole top-level name, and not the
    port, whose name begins with it."""
    out = subprocess.run(
        [sys.executable, "-m", "torrey_bench.run", "--workload",
         "cbox_rect-spf2", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 2 and out.stdout == ""
    from torrey_bench import run
    monkeypatch.setitem(sys.modules, PORT, sys.modules.get(PORT, object()))
    monkeypatch.delitem(sys.modules, "pathtracer_cuda_interactive_tpu",
                        raising=False)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "pathtracer_cuda_interactive_tpu.ops",
                        object())
    assert run.loaded_forbidden() == ["pathtracer_cuda_interactive_tpu"]
