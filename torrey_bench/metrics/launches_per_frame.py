"""Device kernels a frame in the profiler's trace of the traced frames."""


def read(run):
    d = run["trace"]
    if d is None or not d["kernel_count"]:
        return None
    return d["kernel_count"] / d["frames"]
