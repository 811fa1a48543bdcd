"""A run with the timed path broken underneath comes out not correct.

Each cell's run is driven on the CPU at a tiny size (the harness's look for
a card skipped): first sound, then once with each fault a one-card
progressive renderer can have: a step that leaves the accumulation as it
was; half of a frame's samples left out and the rest counted twice (the
mean taken over the rest); a frame's answer altered where it is produced
(every seventh pixel at half its value).  One card exchanges nothing, so
the fault of an exchange left out does not arise."""

import pytest
import torch

from pathtracer_cuda_interactive_tpu_torch.render import renderer as rmod
from torrey_bench import run

from .conftest import CELLS, tiny

RENDERERS = ("render_samples_megakernel", "render_samples_wavefront",
             "render_samples_bricks")


def _unchanged(fn):
    def wrapped(*args, **kwargs):
        return torch.zeros_like(fn(*args, **kwargs))
    return wrapped


def _half(fn):
    def wrapped(scene, cam, w, h, start, ns, *args, **kwargs):
        kept = max(1, ns // 2)
        return fn(scene, cam, w, h, start, kept, *args, **kwargs) * (ns / kept)
    return wrapped


def _altered(fn):
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        flat = out.reshape(-1, 3)
        flat[::7] *= 0.5
        return out
    return wrapped


FAULTS = {"unchanged": _unchanged, "half": _half, "altered": _altered}


def _measure(cell, name, seconds=1.5):
    return run.measure(cell, 2 ** 33 + 17, seconds, False, device="cpu",
                       overrides=tiny(name))


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(cells, name):
    out = _measure(cells[name], name)
    assert out["correct"], out["rows"]
    line = run.result_line(cells[name], out, False, {"platform": "cpu"})
    want = {"msamples_s", "setup_s"}
    if out["attempted"] >= 2:       # a tail needs two frames
        want.add("frame_ms_p95")
    assert set(line["metrics"]) == want
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(cells, name, fault, monkeypatch):
    for fn in RENDERERS:
        monkeypatch.setattr(rmod, fn, FAULTS[fault](getattr(rmod, fn)))
    out = _measure(cells[name], name)
    assert not out["correct"], out["rows"]
