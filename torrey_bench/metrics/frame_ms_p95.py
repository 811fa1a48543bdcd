"""The 95th percentile of the host-clock time of every synced frame in the
window, from the traffic's camera move to the sync
(``statistics.quantiles``, inclusive), over all of its frames."""

import statistics


def read(run):
    frames = run["frames_ms"]
    if len(frames) < 2:
        return None
    return statistics.quantiles(frames, n=100, method="inclusive")[94]
