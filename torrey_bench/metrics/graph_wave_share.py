"""The share of traced waves that ran inside a CUDA graph's replay, in
percent, from the port's "graph_waves" and "waves" counters over the steps
made under the profiler: how often the wave loop's fixed-capacity graph
path engages.  Nothing where no wave ran, or where the port keeps no
"graph_waves" counter (a commit before it)."""

from torrey_bench.program_trace import port_trace


def read(run):
    t = port_trace()
    if t is None:
        return None
    c = t.counts()
    if not c.get("waves") or "graph_waves" not in c:
        return None
    return 100.0 * c["graph_waves"] / c["waves"]
