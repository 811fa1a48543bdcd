"""Host spans and counters of the port, free while no profiler records.

``span(name)`` opens a ``torch.profiler.record_function`` range while a
profiler records (``torch.autograd._profiler_enabled()``) and otherwise
returns one shared no-op context: no range, no clock read, no allocation.
Under the profiler the ranges sit on Kineto's host clock, the clock the
device's kernels and copies are put on, so each gap in the device's work
can be put down to the span open at that moment.  The spans of a frame:

* ``frame.layout``: ``render_waves``' slot map and image buffer;
* ``frame.rays``: a chunk's camera and first sample, and in the uncounted
  schedule its camera rays (seeds, uniforms, primary rays, ray table);
* ``frame.sum``: a chunk's sum over its samples, added to the image;
* ``frame.launch``: the host side of a one-launch frame (B1, B6);
* ``frame.accumulate``: ``accum += new``, once a step;
* ``frame.read``: each wait of the host on the card — in the wave loop's
  uncounted schedule the live count a wave and the shadow waves'
  ``nonzero``, in its counted schedule the control block once a group of
  waves, and a chunk's blocking upload of its columns when it is built;
  the one ``frame.*`` span that opens inside another;

beside the uncounted schedule's ``wavefront.sort``, ``.trace``, ``.shade``
and ``.count`` (ops/wavefront.py), and the counted schedule's
``wavefront.replay``, the host side of each graph's replay (or, on the
CPU, of running its steps).  While a profiler records, every span also
adds its count and host seconds to a total by name (``totals()``), and
``count(name, n)`` adds to a counter by name (``counts()``: "waves" and
"rays" from the wave loop, "graph_waves" the waves run inside a graph's
replay, "drain_rays" the rays the counted schedule's drain traced):
one entry a name, so a long viewer run grows nothing, and nothing at all
while no profiler records.

``setup_span(name)`` is such a span that also adds its seconds, profiler
or not, to the process's set-up record by name (``setup_seconds()``):
``setup.parse``, ``.subdivide``, ``.pack``, ``.host_set`` (BVH, SAH
treelets and bricks), ``.upload``, ``.walk_table`` and ``.kernels`` (a
kernel library's hash check, build and load).  Set-up spans do not nest
in one another.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.profiler import record_function

_recording = torch.autograd._profiler_enabled
NOOP = contextlib.nullcontext()

_totals: dict = {}       # name -> [spans, seconds] while a profiler records
_counts: dict = {}       # name -> sum while a profiler records
_setup: dict = {}        # name -> seconds


class _Span:
    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = record_function(self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self._t0
        self._range.__exit__(*exc)
        row = _totals.setdefault(self.name, [0, 0.0])
        row[0] += 1
        row[1] += seconds
        return False


def span(name: str):
    """A host range named ``name`` while a profiler records, else NOOP."""
    return _Span(name) if _recording() else NOOP


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records."""
    if _recording():
        _counts[name] = _counts.get(name, 0) + n


@contextlib.contextmanager
def setup_span(name: str):
    """``span(name)`` whose seconds also add to ``setup_seconds()``; a
    decorator too."""
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        _setup[name] = _setup.get(name, 0.0) + time.perf_counter() - t0


def totals() -> dict:
    """{name: (spans, host seconds)} of the spans opened while a profiler
    recorded, over the process."""
    return {name: tuple(row) for name, row in _totals.items()}


def counts() -> dict:
    """{name: sum} of the counts made while a profiler recorded."""
    return dict(_counts)


def setup_seconds() -> dict:
    """{name: seconds} of every set-up span over the process."""
    return dict(_setup)
