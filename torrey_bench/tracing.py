"""From a profiler's trace of a few frames to the per-layer numbers.

``events_from_profiler`` turns ``torch.profiler``'s events into a flat list
of ``Event``: the device's kernels and copies, and the host ranges that the
port (``wavefront.sort`` / ``.trace`` / ``.shade`` / ``.count`` in
ops/wavefront.py) and the benchmark (``bench.frame``, ``bench.move``,
``bench.step``, ``bench.sync``) open with ``record_function``.  ``digest``
reduces such a list to the traced window, the device's busy time in it (the
union of its kernels and copies), the kernels by name, the host ranges by
name and the device's idle time labelled by the innermost host range open
at the middle of each gap: what the host was doing while the card waited.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

# host ranges the digest keeps; everything else on the host is left out
RANGE_PREFIXES = ("wavefront.", "bench.")
FRAME_RANGE = "bench.frame"
# a kernel's name is cut to this length in the breakdown
NAME_CHARS = 120


@dataclass(frozen=True)
class Event:
    name: str
    kind: str          # "kernel", "copy" (memcpy / memset) or "range"
    start_us: float
    end_us: float


def events_from_profiler(prof) -> list:
    """The kernels, copies and kept host ranges of a finished
    ``torch.profiler.profile``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.events():
        ranged = e.name.startswith(RANGE_PREFIXES)
        if e.device_type == cuda:
            # a host range appears again on the device's timeline as an
            # annotation spanning its kernels: not device work
            if ranged or getattr(e, "is_user_annotation", False):
                continue
            kind = ("copy" if e.name.startswith(("Memcpy", "Memset"))
                    else "kernel")
        elif ranged:
            kind = "range"
        else:
            continue
        out.append(Event(e.name, kind, float(e.time_range.start),
                         float(e.time_range.end)))
    return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _label(t: float, ranges, starts) -> str:
    """The innermost host range open at time ``t``: of the ranges that
    hold it, the one that opened last (host ranges nest).  ``ranges`` are
    sorted by start, ``starts`` are their starts."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if ranges[i].end_us >= t:
            return ranges[i].name
    return "host"


def digest(events: list) -> dict:
    """Per-window sums of a trace: the window runs from the start of the
    first ``bench.frame`` range to the end of the last.  Times in us."""
    frames = [e for e in events if e.kind == "range"
              and e.name == FRAME_RANGE]
    if not frames:
        raise ValueError("no bench.frame range in the trace")
    t0 = min(e.start_us for e in frames)
    t1 = max(e.end_us for e in frames)
    device = [e for e in events if e.kind in ("kernel", "copy")
              and e.end_us > t0 and e.start_us < t1]
    busy = _union((max(e.start_us, t0), min(e.end_us, t1)) for e in device)
    ranges = sorted((e for e in events if e.kind == "range"
                     and e.name != FRAME_RANGE and e.end_us > t0
                     and e.start_us < t1), key=lambda e: e.start_us)
    starts = [e.start_us for e in ranges]
    idle = {}
    edge = t0
    for s, e in busy + [[t1, t1]]:
        if s > edge:
            label = _label(0.5 * (edge + s), ranges, starts)
            idle[label] = idle.get(label, 0.0) + (s - edge)
        edge = max(edge, e)
    kernels = {}
    for e in device:
        if e.kind == "kernel":
            row = kernels.setdefault(e.name, [0, 0.0])
            row[0] += 1
            row[1] += e.end_us - e.start_us
    host = {}
    for e in ranges:
        row = host.setdefault(e.name, [0, 0.0])
        row[0] += 1
        row[1] += e.end_us - e.start_us
    return {
        "frames": len(frames),
        "window_us": t1 - t0,
        "busy_us": sum(e - s for s, e in busy),
        "kernel_count": sum(row[0] for row in kernels.values()),
        "kernel_us": sum(row[1] for row in kernels.values()),
        "kernels": kernels,
        "ranges": host,
        "idle_us": idle,
    }


def breakdown(d: dict) -> dict:
    """The ten kernels that took most device time and the ten host ranges
    under which the device idled longest, in seconds over the window."""
    ops = sorted(((name[:NAME_CHARS], row[1] / 1e6)
                  for name, row in d["kernels"].items()),
                 key=lambda x: -x[1])[:10]
    gaps = sorted(((name, us / 1e6) for name, us in d["idle_us"].items()),
                  key=lambda x: -x[1])[:10]
    return {"device_ops": [list(x) for x in ops],
            "idle_gaps": [list(x) for x in gaps]}
