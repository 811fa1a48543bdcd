"""The device time of all kernels of a frame, summed by kernel name from
the profiler's trace of the traced frames, in ms."""


def read(run):
    d = run["trace"]
    if d is None or not d["kernel_us"]:
        return None
    return d["kernel_us"] / d["frames"] / 1e3
