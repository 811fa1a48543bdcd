"""The share of the traced window (first to last traced frame boundary) in
which no kernel or copy ran on the device, in percent."""


def read(run):
    d = run["trace"]
    if d is None or not d["busy_us"]:
        return None
    return 100.0 * (1.0 - d["busy_us"] / d["window_us"])
