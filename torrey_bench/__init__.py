"""The benchmark of the PyTorch and CUDA port
(``pathtracer_cuda_interactive_tpu_torch``), run as
``python3 -m torrey_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout.

Driven by data: ``BENCHMARK.json`` names the cells, and each cell's
configuration (``configs/<name>.json``), traffic mix
(``traffic/<name>.json``, with its camera motion in ``motions/<name>.py``)
and metrics (``metrics/<name>.py``, one reader a metric) are files found by
name.  ``reference/`` is the plain path tracer that decides ``correct``.
"""

from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
