"""The least time of a frame's fixed work (roofline.py) over the median
host-clock frame of the run, in percent: the whole frame's share of the
card's peak, which bounds what any kernel's share can claim."""

import statistics


def read(run):
    return 100.0 * run["least_ms"] / statistics.median(run["frames_ms"])
