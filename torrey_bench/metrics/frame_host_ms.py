"""Host ms a frame in the port's ``frame.*`` spans other than
``frame.read`` (``frame.layout``, ``.rays``, ``.sum``, ``.launch``,
``.accumulate``; the reads nested in them included): the step's host time
outside the wave loop's ranges, over the steps made under the profiler."""

from torrey_bench.program_trace import frame_totals


def read(run):
    got = frame_totals()
    if got is None:
        return None
    totals, steps = got
    s = sum(row[1] for name, row in totals.items()
            if name.startswith("frame.") and name != "frame.read")
    return s / steps * 1e3
