"""Seconds in the port's set-up spans (``setup.parse``, ``.subdivide``,
``.pack``, ``.host_set``, ``.upload``, ``.walk_table``, ``.kernels``) over
the process: ``setup_s`` less this is the process's own (imports, the CUDA
context, warm-up frames)."""

from torrey_bench.program_trace import port_trace


def read(run):
    t = port_trace()
    if t is None:
        return None
    seconds = t.setup_seconds()
    return sum(seconds.values()) if seconds else None
