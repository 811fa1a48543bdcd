"""The drain of the wave loop's counted schedule (ops/wavefront.py::
_ChunkWaves, ops/wave_step.py::drain_plain and the kernel ``wave_drain``):
at a host read whose live count fits GROUP_WAVES rounds of the drain's
resident lanes, or whose group would run past the roulette's start
(``wavefront._drains``), every live path of the carried table is carried
to its end at once.

The rule on both sides of each of its limits, and the classes a chunk
captures under it.  On the CPU the counted schedule runs its plain steps
and ``drain_plain``: with the drain forced at the first read and at a
middle read, and with lanes that drain at the second read where one round
of them would not, the image, waves and rays equal the uncounted
schedule's bit for bit and the drain took the rays of the waves it
replaced (the counted schedule
that never drains, the CPU's default, is held to it in
tests/test_torch_wave_graphs.py);
``drain_plain``
on a carried table equals the sorted waves run one by one through the
plain counted steps (radiance, waves, rays, depth), and the port's
"drain_rays" counter holds the rays it traced.

The cases marked ``cuda`` skip without a card and import no jax, so on the
card this file runs with ``python -m pytest --noconftest -m cuda
tests/test_torch_wave_drain.py``: the drain kernel against ``drain_plain``
through the wave's own kernels (B2, W1, W2) bit for bit on the carried
table of a 640x480 frame at the first read the rule drains on the card,
and the resident lanes the rule is made of.
"""

import pytest
import torch

from pathtracer_cuda_interactive_tpu_torch import SCENES_DIR
from pathtracer_cuda_interactive_tpu_torch.models.bricks import BrickSet
from pathtracer_cuda_interactive_tpu_torch.models.scenepack import load_scene
from pathtracer_cuda_interactive_tpu_torch.ops import wave_step, wavefront
from pathtracer_cuda_interactive_tpu_torch.ops.camera import (
    Camera, camera_ray_data)
from pathtracer_cuda_interactive_tpu_torch.utils import trace

# several test workers at once: one intra-op thread per process
torch.set_num_threads(1)

BLOB_BOX = str(SCENES_DIR / "blob_box.xml")
SEED, DEPTH, RR = 1984, 50, 5


def _load(device="cpu"):
    pack, parsed = load_scene(BLOB_BOX)
    return BrickSet.from_pack(pack).to(device), Camera.from_parsed(
        parsed.camera)


@pytest.fixture(scope="module")
def blob():
    return _load()


def _camera(cam, width, height, device="cpu"):
    return torch.from_numpy(camera_ray_data(cam, width, height)).to(device)


# kernel B2 at every depth: with a kept cache, the counted schedule
TRACERS = (wavefront.trace_wave_slim,) * DEPTH


def _chunk(bricks, cd, width, height, spp, sort_mode):
    """A WaveCache holding the one chunk of a frame in the counted
    schedule, built before the frame, and that chunk."""
    root = bricks.top_boxes[0, :6]
    cache = wavefront.WaveCache()
    engine = wavefront.wave_engine(True, TRACERS, wave_step.STEPS.record,
                                   wave_step.STEPS, False, cd.device)
    slots = cache.begin(bricks, width, height, None, spp, SEED, DEPTH, RR,
                        sort_mode, engine)
    chunk = cache.chunk(slots, 0, spp, engine, bricks, cd, width, height,
                        SEED, DEPTH, RR, sort_mode, root[:3], root[3:])
    assert chunk.engine.counted
    return cache, chunk


def _frame(bricks, cd, width, height, spp, sort_mode, stats, cache=None):
    """The frame through the counted schedule of ``cache``, or without one
    through the uncounted schedule."""
    root = bricks.top_boxes[0, :6]
    return wavefront.render_waves(
        bricks, cd, width, height, 0, spp, SEED, DEPTH, RR, sort_mode, False,
        root[:3], root[3:], TRACERS, wave_step.STEPS.record, stats=stats,
        cache=cache)


_refs = {}


def _ref(blob, sort_mode):
    """The uncounted schedule's 32x24, 2-sample frame, its stats and the
    rays of each of its waves."""
    if sort_mode not in _refs:
        bricks, cam = blob
        stats, rays = {}, []

        def trace_wave(scene, org, dirn, tnear):
            rays.append(int(org.x.numel()))
            return wavefront.trace_wave_slim(scene, org, dirn, tnear)

        root = bricks.top_boxes[0, :6]
        img = wavefront.render_waves(
            bricks, _camera(cam, 32, 24), 32, 24, 0, 2, SEED, DEPTH, RR,
            sort_mode, False, root[:3], root[3:], (trace_wave,) * DEPTH,
            wave_step.STEPS.record, stats=stats)
        _refs[sort_mode] = img, stats, rays
    return _refs[sort_mode]


def _lanes(limit):
    """The fewest lanes whose GROUP_WAVES rounds hold ``limit`` paths."""
    return -(-limit // wavefront.GROUP_WAVES)


K, CARD_LANES = wavefront.GROUP_WAVES, 118_272     # an H100's drain lanes


# (live, depth, lanes, drains) with the roulette from past depth RR = 5.
# At depth 1 a group stops short of the roulette: the live paths against
# GROUP_WAVES rounds of the lanes decide, and what one round holds drains
# too.  From depth RR - K + 2 = 3 on a group would run past it: a read
# drains whatever its live count.  No lanes, no drain.
@pytest.mark.parametrize("live,depth,lanes,drains", [
    (K * CARD_LANES, 1, CARD_LANES, True),
    (K * CARD_LANES + 1, 1, CARD_LANES, False),
    (K * 128, 1, 128, True),
    (K * 128 + 1, 1, 128, False),
    (CARD_LANES, 1, CARD_LANES, True),
    (1, 1, CARD_LANES, True),
    (128, 1, 128, True),
    (614_400, 1, CARD_LANES, False),
    (614_400, RR - K + 1, CARD_LANES, False),
    (614_400, RR - K + 2, CARD_LANES, True),
    (414_155, 5, CARD_LANES, True),
    (1_241_469, 5, CARD_LANES, True),
    (1_843_200, 1, CARD_LANES, False),
    (1, 1, 0, False),
    (614_400, 5, 0, False),
])
def test_drain_rule(live, depth, lanes, drains):
    assert wavefront._drains(live, depth, lanes, RR) is drains


# (rr_start_depth, lanes, groups) of a 64x48, 2-sample chunk, classes 6144
# and 4096: the first read (depth 1) picks 6144, later ones (depth 5 on)
# either; with the roulette from past depth 5 a later read always drains
@pytest.mark.parametrize("rr,lanes,groups", [
    (RR, 0, [6144, 4096]),
    (RR, 1, [6144]),
    (RR, 1536, []),
    (DEPTH, 900, [6144, 4096]),
    (DEPTH, 1100, [6144]),
])
def test_drain_rule_picks_the_captured_classes(blob, rr, lanes, groups):
    """A chunk's groups: the classes some read that does not drain can
    pick."""
    bricks, cam = blob
    _, chunk = _chunk(bricks, _camera(cam, 64, 48), 64, 48, 2, "sig_mort")
    assert chunk.classes == [6144, 4096]
    chunk.rr_start_depth, chunk.drain_lanes = rr, lanes
    assert list(chunk._steps()) == ["primary", *groups, "drain"]


# the drain's limit as a share of the chunk's capacity: all of it (the
# first read drains), a quarter (a read after a group)
@pytest.mark.parametrize("sort_mode", ["sig_mort", "none"])
@pytest.mark.parametrize("when,share", [("first", 1.0), ("middle", 0.25)])
def test_drain_matches_the_live_prefix_loop(blob, sort_mode, when, share):
    bricks, cam = blob
    cd = _camera(cam, 32, 24)
    ref, ref_stats, _ = _ref(blob, sort_mode)
    cache, chunk = _chunk(bricks, cd, 32, 24, 2, sort_mode)
    assert chunk.drain_lanes == 0        # no drain on the CPU by default
    chunk.drain_lanes = _lanes(int(share * chunk.capacity))
    stats = {}
    got = _frame(bricks, cd, 32, 24, 2, sort_mode, stats, cache)
    assert torch.equal(got, ref)
    assert stats == ref_stats and ref_stats["waves"] > 10
    runs = chunk.replays
    assert runs["primary"] == 1 and runs["drain"] == 1
    if when == "first":
        assert runs["group"] == 0
    else:
        assert 1 <= runs["group"] < ref_stats["waves"] // wavefront.GROUP_WAVES
    assert int(chunk.ctl[wave_step.COUNT]) == 0
    assert chunk.ctl.tolist()[wave_step.CURSOR:] == [0, 0]


# lanes whose one round holds fewer paths than the second read (before
# wave 1 + K) finds: 300, whose K rounds hold them; 1, whose K rounds do
# not, where the second read drains as its group would pass the roulette
@pytest.mark.parametrize("lanes", [300, 1])
def test_drain_from_the_second_read(blob, lanes):
    """The drain takes the frame from the second read (one round of the
    lanes would wait for the third), the frame is the uncounted
    schedule's bit for bit, and the drain took the rays of the waves it
    replaced."""
    bricks, cam = blob
    cd = _camera(cam, 32, 24)
    ref, ref_stats, rays = _ref(blob, "sig_mort")
    assert rays[1] > K * lanes and rays[1 + K] > lanes
    assert (rays[1 + K] <= K * lanes) is (lanes == 300)
    cache, chunk = _chunk(bricks, cd, 32, 24, 2, "sig_mort")
    chunk.drain_lanes = lanes
    stats = {}
    got = _frame(bricks, cd, 32, 24, 2, "sig_mort", stats, cache)
    assert torch.equal(got, ref) and stats == ref_stats
    assert chunk.replays == {"primary": 1, "group": 1, "drain": 1}
    assert chunk.drained == {"waves": len(rays) - 1 - K,
                             "rays": sum(rays[1 + K:])}


def _carried(bricks, cam, width, height, spp, sort_mode="sig_mort"):
    """A chunk whose carried table and control block hold its first
    bounce: the primary wave run once."""
    cd = _camera(cam, width, height)
    _, chunk = _chunk(bricks, cd, width, height, spp, sort_mode)
    chunk.cam.copy_(cd)
    chunk._primary()
    return chunk


def test_drain_plain_matches_the_waves_one_by_one(blob):
    """``drain_plain`` on a carried table against the same table's sorted
    waves through the plain counted steps until no ray is live."""
    bricks, cam = blob
    chunk = _carried(bricks, cam, 32, 24, 2)
    carry, ctl, out = (chunk.carry.clone(), chunk.ctl.clone(),
                       chunk.out.clone())
    live = int(ctl[wave_step.COUNT])
    assert 0 < live <= int(ctl[wave_step.VALID]) == chunk.capacity
    wave_step.drain_plain(bricks, carry, ctl, chunk.bg, RR, DEPTH, out)
    depth = int(chunk.ctl[wave_step.DEPTH])
    while int(chunk.ctl[wave_step.COUNT]):
        valid = int(chunk.ctl[wave_step.VALID])
        chunk._group(min(c for c in chunk.classes if c >= valid))
    want = chunk.ctl.tolist()
    assert torch.equal(out, chunk.out) and chunk.out.abs().sum() > 0
    got = ctl.tolist()
    for k in (wave_step.WAVES, wave_step.RAYS, wave_step.DEPTH):
        assert got[k] == want[k]
    assert got[wave_step.WAVES] > 5 and got[wave_step.DEPTH] > depth
    assert got[wave_step.RAYS] > 2 * live
    # no ray is left, and the drain's own slots are clear
    assert [got[k] for k in (wave_step.COUNT, wave_step.NEXT,
                             wave_step.VALID, wave_step.CURSOR,
                             wave_step.LEVELS)] == [0] * 5


def test_drain_plain_reads_only_the_valid_columns(blob):
    """Columns at or past ``VALID`` (left from earlier waves) are not
    paths, whatever their live flag says; a table with no live column
    drains nothing and clears the count."""
    bricks, cam = blob
    chunk = _carried(bricks, cam, 32, 24, 1)
    carry, ctl = chunk.carry.clone(), chunk.ctl.clone()
    half = chunk.capacity // 2
    ctl[wave_step.VALID] = half
    out = torch.zeros_like(chunk.out)
    wave_step.drain_plain(bricks, carry, ctl, chunk.bg, RR, DEPTH, out)
    _, pix, samp = wave_step.int_rows(chunk.carry)
    written = out[samp.long(), pix.long()].abs().sum(dim=1) > 0
    live = chunk.carry[wave_step.LIVE] > 0
    assert written[half:].sum() == 0 and written[:half].any()
    assert not (written & ~live).any()
    assert torch.equal(carry.view(torch.int32), chunk.carry.view(torch.int32))
    none = chunk.ctl.clone()
    none[wave_step.VALID] = 0
    rays = int(none[wave_step.RAYS])
    wave_step.drain_plain(bricks, carry, none, chunk.bg, RR, DEPTH,
                          torch.zeros_like(out))
    assert int(none[wave_step.RAYS]) == rays
    assert int(none[wave_step.COUNT]) == 0


def test_drain_counts_its_rays(blob, monkeypatch):
    """While the trace module records (under a profiler; here forced, the
    profiler's own cost being some 3 s a frame on the CPU) the port's
    "drain_rays" counter gets the rays the drain traced: with the drain at
    the first read, every ray after the primary wave's; and 0 where no
    drain ran."""
    bricks, cam = blob
    cd = _camera(cam, 32, 24)
    monkeypatch.setattr(trace, "_recording", lambda: True)
    for share in (1.0, 0.0):
        cache, chunk = _chunk(bricks, cd, 32, 24, 1, "sig_mort")
        chunk.drain_lanes = _lanes(int(share * chunk.capacity))
        before, stats = trace.counts(), {}
        _frame(bricks, cd, 32, 24, 1, "sig_mort", stats, cache)
        added = {k: v - before.get(k, 0) for k, v in trace.counts().items()}
        assert added["rays"] == stats["rays"]
        assert added["drain_rays"] == (stats["rays"] - chunk.capacity
                                       if share else 0)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


@pytest.mark.cuda
def test_cuda_drain_lanes():
    """The card's resident lanes of the drain: a whole number of 128-thread
    blocks on every SM, the lanes the rule of every chunk reads."""
    _needs_card()
    lanes = wave_step.drain_lanes("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert lanes > 0 and lanes % (128 * sms) == 0
    assert lanes <= sms * 2048


@pytest.mark.cuda
def test_cuda_drain_matches_drain_plain_through_the_wave_kernels():
    """The drain kernel on the carried table of a 640x480, 2-sample frame
    at the first read the rule drains on the card, against ``drain_plain``
    through B2, W1 and W2 on the same table: the radiance and the control
    block bit for bit."""
    _needs_card()
    bricks, cam = _load("cuda")
    cd = _camera(cam, 640, 480, "cuda")
    cache, chunk = _chunk(bricks, cd, 640, 480, 2, "sig_mort")
    chunk.cam.copy_(cd)
    chunk._primary()
    while not wavefront._drains(int(chunk.ctl[wave_step.COUNT]),
                                int(chunk.ctl[wave_step.DEPTH]),
                                chunk.drain_lanes, RR):
        valid = int(chunk.ctl[wave_step.VALID])
        chunk._group(min(c for c in chunk.classes if c >= valid))
    live = int(chunk.ctl[wave_step.COUNT])
    assert live > 0
    carry, ctl, out = (chunk.carry.clone(), chunk.ctl.clone(),
                       chunk.out.clone())
    before = wave_step.wave_drain_cuda.launches
    wave_step.wave_drain_cuda(bricks, chunk.carry, chunk.ctl, chunk.bg, RR,
                              DEPTH, chunk.out, chunk.drain_lanes)
    assert wave_step.wave_drain_cuda.launches == before + 1
    wave_step.drain_plain(bricks, carry, ctl, chunk.bg, RR, DEPTH, out,
                          trace=wavefront.trace_wave_slim,
                          steps=wave_step.STEPS)
    torch.cuda.synchronize()
    assert torch.equal(chunk.out.view(torch.int32), out.view(torch.int32))
    assert chunk.ctl.tolist() == ctl.tolist()
    assert int(ctl[wave_step.RAYS]) > 0
