"""The port's ``frame.read`` spans a frame: each wait of the host on the
card (the live count a wave, the padding mask's gathers, the shadow waves'
``nonzero``, a blocking upload), over the steps made under the profiler;
0.0 where a step opened none."""

from torrey_bench.program_trace import frame_totals


def read(run):
    got = frame_totals()
    if got is None:
        return None
    totals, steps = got
    return totals.get("frame.read", (0, 0.0))[0] / steps
