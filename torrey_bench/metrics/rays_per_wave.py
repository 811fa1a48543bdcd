"""Rays a traced wave (shadow waves included), from the port's "rays" and
"waves" counters over the steps made under the profiler: how full the
waves are that each pay a sort, a trace, a bounce step and a count.
Nothing where no wave ran."""

from torrey_bench.program_trace import port_trace


def read(run):
    t = port_trace()
    if t is None:
        return None
    c = t.counts()
    return c["rays"] / c["waves"] if c.get("waves") else None
