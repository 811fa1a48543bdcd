"""Seconds from the start of the benchmark's process to the first timed
frame: imports, the kernel libraries (built on a checkout's first run),
the scene build and upload, the warm-up frames."""


def read(run):
    return run["setup_s"]
