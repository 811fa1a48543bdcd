"""Host ms a frame inside the wave loop's ranges (``wavefront.sort``,
``.trace``, ``.shade``, ``.count`` of ops/wavefront.py), from the traced
frames; nothing where no wave ran."""


def read(run):
    d = run["trace"]
    if d is None:
        return None
    us = sum(row[1] for name, row in d["ranges"].items()
             if name.startswith("wavefront."))
    return us / d["frames"] / 1e3 if us > 0 else None
