"""What the port's own spans and counters recorded in this process
(``pathtracer_cuda_interactive_tpu_torch/utils/trace.py``), for the metric
readers.

While a profiler records, the port adds every span's count and host
seconds to a total by name, and its counts ("waves", "rays") to a counter
by name; its set-up spans add their seconds to a record by name whether
or not a profiler records.  A run profiles the one step of the profiler's
own first start and the traced frames, so the totals cover those steps:
the readers divide by the steps they hold (one ``frame.accumulate`` a
step).  The readers find nothing where this process did not load the
port's module, or where the port has none (a commit before it).
"""

from __future__ import annotations

import sys

MODULE = "pathtracer_cuda_interactive_tpu_torch.utils.trace"


def port_trace():
    """The port's trace module if this process loaded it, else None."""
    return sys.modules.get(MODULE)


def frame_totals():
    """({name: (spans, seconds)}, steps) of the steps made under a
    profiler, or None where there were none."""
    t = port_trace()
    if t is None:
        return None
    totals = t.totals()
    steps = totals.get("frame.accumulate", (0, 0.0))[0]
    return (totals, steps) if steps else None
