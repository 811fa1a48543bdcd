"""Camera samples completed in the window over its wall seconds, in
millions: width x height x samples a frame x frames, over the host clock
from the first frame's start to the last frame's end."""


def read(run):
    samples = run["width"] * run["height"] * run["spf"] \
        * len(run["frames_ms"])
    return samples / run["window_s"] / 1e6
