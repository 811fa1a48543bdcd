"""The reader of ``drain_ray_share`` (metrics/drain_ray_share.py) on a
stub of the port's trace module: the share where the counters are there,
nothing where no ray was traced, where the port keeps no "drain_rays"
counter (a commit before it) or where it has no trace module at all."""

import sys
import types

import pytest

from torrey_bench import program_trace, spec


def _read(counts):
    stub = types.SimpleNamespace(counts=lambda: dict(counts))
    entries = [{"name": "drain_ray_share", "unit": "%"}]
    with pytest.MonkeyPatch.context() as mp:
        if counts is None:
            mp.delitem(sys.modules, program_trace.MODULE, raising=False)
        else:
            mp.setitem(sys.modules, program_trace.MODULE, stub)
        got = spec.read_metrics(entries, {"trace": None})
    return got.get("drain_ray_share", {}).get("value")


@pytest.mark.parametrize("counts,share", [
    ({"waves": 40, "rays": 1000, "drain_rays": 80}, 8.0),
    ({"waves": 40, "rays": 1000, "drain_rays": 0}, 0.0),
    ({"waves": 40, "rays": 1000, "graph_waves": 40}, None),
    ({"drain_rays": 0}, None),
    ({"waves": 0, "rays": 0, "drain_rays": 0}, None),
    ({}, None),
    (None, None)])
def test_drain_ray_share(counts, share):
    got = _read(counts)
    assert got == (pytest.approx(share) if share is not None else None)
