"""The reader of ``graph_wave_share`` (metrics/graph_wave_share.py) on a
stub of the port's trace module: the share where the counters are there,
nothing where no wave ran, where the port keeps no "graph_waves" counter
(a commit before it) or where it has no trace module at all."""

import sys
import types

import pytest

from torrey_bench import program_trace, spec


def _read(counts):
    stub = types.SimpleNamespace(counts=lambda: dict(counts))
    entries = [{"name": "graph_wave_share", "unit": "%"}]
    with pytest.MonkeyPatch.context() as mp:
        if counts is None:
            mp.delitem(sys.modules, program_trace.MODULE, raising=False)
        else:
            mp.setitem(sys.modules, program_trace.MODULE, stub)
        got = spec.read_metrics(entries, {"trace": None})
    return got.get("graph_wave_share", {}).get("value")


@pytest.mark.parametrize("counts,share", [
    ({"waves": 40, "rays": 1000, "graph_waves": 38}, 95.0),
    ({"waves": 40, "rays": 1000, "graph_waves": 0}, 0.0),
    ({"waves": 40, "rays": 1000}, None),
    ({"graph_waves": 0}, None),
    ({}, None),
    (None, None)])
def test_graph_wave_share(counts, share):
    got = _read(counts)
    assert got == (pytest.approx(share) if share is not None else None)
