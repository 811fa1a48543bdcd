"""The median host ms from calling ``ProgressiveRenderer.step(sync=False)``
to its return, over the traced run's frames outside the profiler.  In the
wavefront it holds the wave loop's waits on each wave's live count."""

import statistics


def read(run):
    ms = run["step_host_ms"]
    return statistics.median(ms) if ms else None
