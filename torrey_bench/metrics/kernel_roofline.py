"""The least time of a frame's fixed work (roofline.py, from the
configuration's ``fixed_work``) over the frame's kernel time
(``kernel_ms``), in percent."""


def read(run):
    d = run["trace"]
    if d is None or not d["kernel_us"]:
        return None
    return 100.0 * run["least_ms"] / (d["kernel_us"] / d["frames"] / 1e3)
