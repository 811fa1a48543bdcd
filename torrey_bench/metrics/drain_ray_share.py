"""The share of traced rays that the wave loop's drain traced, in percent,
from the port's "drain_rays" and "rays" counters over the steps made under
the profiler: how much of a frame's tail the fixed-capacity loop hands to
its one-launch drain instead of small sorted waves.  Nothing where no ray
was traced, or where the port keeps no "drain_rays" counter (a commit
before it)."""

from torrey_bench.program_trace import port_trace


def read(run):
    t = port_trace()
    if t is None:
        return None
    c = t.counts()
    if not c.get("rays") or "drain_rays" not in c:
        return None
    return 100.0 * c["drain_rays"] / c["rays"]
