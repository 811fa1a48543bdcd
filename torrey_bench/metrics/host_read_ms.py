"""Host ms a frame inside the port's ``frame.read`` spans: the host
blocked on the card, over the steps made under the profiler; 0.0 where a
step opened none."""

from torrey_bench.program_trace import frame_totals


def read(run):
    got = frame_totals()
    if got is None:
        return None
    totals, steps = got
    return totals.get("frame.read", (0, 0.0))[1] / steps * 1e3
