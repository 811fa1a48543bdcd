"""The walk table of kernels B2, B3 and B6 (models/bricks.py::WalkTable).

On the CPU: the table against the ``BrickSet`` it is derived from, field
for field; the plain walk over the table against the plain walk over the
set's own tensors, bit for bit; the rule by which a warp tests a chunk
together ("smallest t, lowest k") against the sequential strict ``t <
best`` scan; and a set built from the JAX package's BrickSet fields.  The
cases marked ``cuda`` run on a card only, where they hold the kernels that
read the table to their plain versions on every ray.  This file imports
jax only inside a CPU case, so on the card it runs with
``python -m pytest --noconftest -m cuda tests/test_torch_walk_table.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pathtracer_cuda_interactive_tpu_torch import SCENES_DIR
from pathtracer_cuda_interactive_tpu_torch.io.xml_scene import parse_scene
from pathtracer_cuda_interactive_tpu_torch.models.bricks import (
    BRICK_DATA_ROWS, BRICK_PRIMS, NUM_SUBS, SUB_PRIMS, BrickSet, WalkTable)
from pathtracer_cuda_interactive_tpu_torch.models.scenepack import pack_scene
from pathtracer_cuda_interactive_tpu_torch.models.subdivide import (
    subdivide_scene)
from pathtracer_cuda_interactive_tpu_torch.ops import brickkernel, wavefront
from pathtracer_cuda_interactive_tpu_torch.ops.brickkernel import (
    trace_bricks_full_plain, trace_bricks_plain)
from pathtracer_cuda_interactive_tpu_torch.ops.camera import (
    Camera, camera_ray_data)
from pathtracer_cuda_interactive_tpu_torch.render import walk_compare

# several worker processes run at once and these tensors are small
torch.set_num_threads(1)

W, H = 32, 24
BLOB_BOX = str(SCENES_DIR / "blob_box.xml")
LEVELS = [0, 1]            # blob_box as it is, and subdivided once
_sets = {}


def _load(levels, width=W, height=H, device="cpu"):
    """(BrickSet, camera data) of blob_box subdivided ``levels`` times; the
    CPU sets are built once per process."""
    if levels not in _sets:
        parsed = subdivide_scene(parse_scene(BLOB_BOX), levels=levels)
        _sets[levels] = (BrickSet.from_pack(pack_scene(parsed)),
                         Camera.from_parsed(parsed.camera))
    bricks, cam = _sets[levels]
    cd = torch.from_numpy(camera_ray_data(cam, width, height))
    return bricks.to(device), cd.to(device)


def _waves(bricks, cd, width, height, n_waves, spp=1):
    """The first waves of a plain-traced wavefront render: the primary
    wave, then sorted bounce waves, as (org, dirn, tnear)."""
    waves = []

    def recording(b, org, dirn, tnear):
        waves.append((org, dirn, tnear))
        return trace_bricks_plain(b, org, dirn, tnear)

    wavefront.render_samples_wavefront(bricks, cd, width, height, 0, spp,
                                       max_depth=n_waves, tracer=recording)
    return waves[:n_waves]


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_table_matches_set(bricks, table):
    n, B = bricks.num_top, bricks.num_bricks
    boxes = bricks.top_boxes.reshape(-1, 8)[:n]
    links = bricks.top_links.reshape(-1, 2)[:n]
    nodes, ints = table.nodes, table.nodes.view(torch.int32)
    assert nodes.shape == (n, 16) and nodes.dtype == torch.float32
    assert nodes.is_contiguous() and nodes.data_ptr() % 64 == 0
    assert torch.equal(_bits(nodes[:, :6].contiguous()),
                       _bits(boxes[:, :6].contiguous()))
    assert torch.equal(ints[:, 6], links[:, 0])      # skip
    assert torch.equal(ints[:, 7], links[:, 1])      # brick
    inner = links[:, 1] < 0
    assert int(inner.sum()) == B - 1 and n == 2 * B - 1
    ids = torch.arange(n)[inner]
    left = ids + 1
    right = links[left, 0].long()
    assert torch.equal(ints[inner, 11].long(), left)
    assert torch.equal(ints[inner, 15].long(), right)
    for child, at in ((left, 8), (right, 12)):
        for f in range(3):
            want = boxes[child, f] + boxes[child, f + 3]   # float32 sum
            assert torch.equal(_bits(nodes[inner, at + f]), _bits(want))
    assert not nodes[~inner, 8:].view(torch.int32).any()

    # every slot's nine floats, empty slots included
    recs = bricks.brick_data[:, :BRICK_DATA_ROWS].reshape(B, BRICK_PRIMS, 32)
    tris = table.tris
    assert tris.shape == (B * NUM_SUBS, 9, SUB_PRIMS) and tris.is_contiguous()
    assert tris.data_ptr() % 16 == 0
    by_slot = tris.view(B, NUM_SUBS, 9, SUB_PRIMS).permute(0, 1, 3, 2)
    assert torch.equal(_bits(by_slot.reshape(B, BRICK_PRIMS, 9)),
                       _bits(recs[:, :, 1:10].contiguous()))
    assert bool((recs[:, :, 0] == 0).any())          # there are empty slots
    # the gates the walk reads are the numbers of the records' gate row
    assert torch.equal(
        _bits(bricks.sub_boxes),
        _bits(bricks.brick_data[:, BRICK_DATA_ROWS].reshape(B, NUM_SUBS, 8)))
    assert table.nbytes == n * 64 + B * BRICK_PRIMS * 36


@pytest.mark.parametrize("levels", LEVELS)
def test_table_matches_the_brickset_field_for_field(levels):
    bricks, _ = _load(levels)
    _assert_table_matches_set(bricks, bricks.walk_table())


def test_table_is_built_once_and_moves_with_the_set():
    bricks, _ = _load(0)
    table = bricks.walk_table()
    assert bricks.walk_table() is table and table.build_s > 0.0
    moved = bricks.to("cpu")
    assert moved is not bricks
    assert moved.walk_table().tris.data_ptr() == table.tris.data_ptr()
    meta = bricks.to("meta")
    assert meta.walk_table().nodes.device.type == "meta"
    # a set whose table was never asked for moves without one
    fresh = BrickSet(**{f.name: getattr(bricks, f.name)
                        for f in dataclasses.fields(BrickSet)})
    assert fresh.to("cpu")._walk is None
    assert isinstance(fresh.walk_table(), WalkTable)


@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("wave", [0, 1], ids=["primary", "bounce"])
def test_plain_walk_over_the_table_equals_the_walk_over_the_set(levels,
                                                                 wave):
    bricks, cd = _load(levels)
    org, dirn, tnear = _waves(bricks, cd, W, H, 2)[wave]
    # the walk updates its start distances in place: a fresh tensor each
    start = lambda: torch.full((org.x.numel(),), float("inf"))
    ref = brickkernel._walk(bricks, org, dirn, tnear, start(), full=True)
    got = brickkernel._walk(bricks, org, dirn, tnear, start(), full=True,
                            table=bricks.walk_table())
    for a, b in zip((got[0], got[1], *got[2], got[3]),
                    (ref[0], ref[1], *ref[2], ref[3])):
        assert torch.equal(_bits(a), _bits(b))
    assert (ref[1] >= 0).float().mean() > 0.5 and int(ref[3].min()) >= 1


@pytest.mark.parametrize("levels", LEVELS)
def test_plain_traces_take_the_table(levels):
    """The slim and the full-record plain versions give the same with and
    without the table: records, counters, masked rays."""
    bricks, cd = _load(levels)
    table = bricks.walk_table()
    org, dirn, tnear = _waves(bricks, cd, W, H, 2)[1]
    active = torch.arange(org.x.numel()) % 3 != 0
    args = (bricks, org, dirn, tnear, active)
    t, slot, counts = trace_bricks_plain(*args, collect_stats=True)
    t2, slot2, counts2 = trace_bricks_plain(*args, collect_stats=True,
                                            table=table)
    rec, rec_counts = trace_bricks_full_plain(*args, collect_stats=True)
    rec2, rec_counts2 = trace_bricks_full_plain(*args, collect_stats=True,
                                                table=table)
    for a, b in zip((t2, slot2, counts2, rec_counts2, *rec2),
                    (t, slot, counts, rec_counts, *rec)):
        assert torch.equal(_bits(a), _bits(b))
    assert int(counts2[:, ~active].abs().sum()) == 0
    assert int(counts2[0, active].min()) >= 1


def _sequential_scan(t, best):
    """Strict ``t < best`` over a chunk's 32 tests in slot order: (best t,
    k of the winner or -1) per row."""
    out_t, out_k = best.copy(), np.full(len(best), -1)
    for k in range(t.shape[1]):
        take = t[:, k] < out_t
        out_t = np.where(take, t[:, k], out_t)
        out_k = np.where(take, k, out_k)
    return out_t, out_k


def _warp_rule(t, best):
    """The warp's rule: every lane tests against the best on entry, the
    smallest t's bit pattern wins (a hit's t is positive, so the bits order
    as t does), the lowest lane on a tie."""
    hit = t < best[:, None]
    key = np.where(hit, t, np.float32(np.inf)).view(np.uint32)
    nearest = key.min(axis=1)
    won = nearest != np.float32(np.inf).view(np.uint32)
    k = np.argmax(key == nearest[:, None], axis=1)       # lowest lane
    return (np.where(won, nearest.view(np.float32), best),
            np.where(won, k, -1))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_smallest_t_lowest_k_equals_the_sequential_scan(seed):
    rs = np.random.default_rng(seed)
    rows = 4096
    # few distinct values, so equal t within a chunk is the rule; misses
    # (inf) and an entry best that lies among the values
    values = np.concatenate([rs.uniform(1e-4, 9.0, 6).astype(np.float32),
                             [np.float32(1e-38), np.float32(np.inf)]])
    t = values[rs.integers(0, len(values), (rows, SUB_PRIMS))]
    t[:, 7] = t[:, 3]                                    # a forced pair
    t[rs.random(t.shape) < 0.5] = np.inf
    best = values[rs.integers(0, len(values), rows)].astype(np.float32)
    seq_t, seq_k = _sequential_scan(t, best)
    got_t, got_k = _warp_rule(t, best)
    np.testing.assert_array_equal(got_t.view(np.int32), seq_t.view(np.int32))
    np.testing.assert_array_equal(got_k, seq_k)
    ties = (t == seq_t[:, None]).sum(axis=1) > 1
    assert (ties & (seq_k >= 0)).mean() > 0.05           # ties were decided
    assert (seq_k < 0).any() and (seq_k >= 0).any()


def test_set_from_the_jax_fields_builds_the_same_table():
    from pathtracer_cuda_interactive_tpu.models import native as jax_native
    from pathtracer_cuda_interactive_tpu.models.bricks import (
        BrickSet as JaxBrickSet)
    from pathtracer_cuda_interactive_tpu.models.scenepack import (
        load_scene as jax_load_scene)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "build_sah_treelets_native",
                   lambda *args: None)
        jax_set = JaxBrickSet.from_pack(jax_load_scene(BLOB_BOX)[0])
    fields = {f.name: getattr(jax_set, f.name)
              for f in dataclasses.fields(JaxBrickSet)}
    got = BrickSet.from_numpy(**{k: v if isinstance(v, int) else np.asarray(v)
                                 for k, v in fields.items()})
    table = got.walk_table()
    _assert_table_matches_set(got, table)
    ref = _load(0)[0].walk_table()
    assert torch.equal(_bits(table.nodes), _bits(ref.nodes))
    assert torch.equal(_bits(table.tris), _bits(ref.tris))


def test_wrappers_refuse_a_table_of_another_set():
    bricks, _ = _load(0)
    other = BrickSet(**{f.name: getattr(bricks, f.name)
                        for f in dataclasses.fields(BrickSet)})
    other._walk = _load(1)[0].walk_table()
    with pytest.raises(ValueError, match="does not belong"):
        brickkernel.walk_pointers(other)
    assert len(brickkernel.walk_pointers(bricks)) == 3


def test_walk_compare_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        walk_compare.main(["--parent", "csrc_of_another_commit"])


# -- on the card ---------------------------------------------------------------
# The skipif conditions are strings: evaluated when a test runs, not when the
# module is imported.

@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card (the kernel has no CPU mode)")
@pytest.mark.parametrize("levels", LEVELS)
def test_cuda_slim_trace_equals_plain_on_every_ray(levels):
    bricks, cd = _load(levels, 160, 120, "cuda")
    for org, dirn, tnear in _waves(bricks, cd, 160, 120, 3, spp=2):
        before = wavefront.trace_bricks_cuda.launches
        t, slot = wavefront.trace_wave_slim(bricks, org, dirn, tnear)
        torch.cuda.synchronize()
        assert wavefront.trace_bricks_cuda.launches == before + 1
        for table in (None, bricks.walk_table()):
            ref_t, ref_slot = trace_bricks_plain(bricks, org, dirn, tnear,
                                                 table=table)
            assert torch.equal(slot, ref_slot)
            assert torch.equal(_bits(t), _bits(ref_t))
        assert (slot >= 0).float().mean() > 0.5


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card (the kernel has no CPU mode)")
@pytest.mark.parametrize("masked", [False, True])
def test_cuda_full_trace_equals_plain_on_every_ray(masked):
    bricks, cd = _load(1, 160, 120, "cuda")
    for org, dirn, tnear in _waves(bricks, cd, 160, 120, 2, spp=2):
        n = org.x.numel()
        active = (torch.arange(n, device="cuda") % 5 != 0) if masked else None
        rec, counts = wavefront.trace_bricks_full_cuda(
            bricks, *org, *dirn, tnear, active, collect_stats=True)
        ref, ref_counts = trace_bricks_full_plain(bricks, org, dirn, tnear,
                                                  active, collect_stats=True)
        torch.cuda.synchronize()
        assert torch.equal(counts, ref_counts)
        same = (torch.stack(rec) == torch.stack(ref)).all(dim=0)
        # the record's position and normal are sums of products the card
        # may round otherwise than the plain version's ops on the card; the
        # walk itself (t, counters) agrees on every ray
        assert torch.equal(_bits(rec[0]), _bits(ref[0]))
        assert float((~same).float().mean()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card (the kernel has no CPU mode)")
@pytest.mark.parametrize("depth", [4, 12])
def test_cuda_brick_render_matches_plain(depth):
    width, height = 64, 48
    bricks, cd = _load(0, width, height, "cuda")
    before = brickkernel.render_bricks_cuda.launches
    got = brickkernel.render_samples_bricks(bricks, cd, width, height, 0, 2,
                                            max_depth=depth)
    again = brickkernel.render_samples_bricks(bricks, cd, width, height, 0,
                                              2, max_depth=depth)
    torch.cuda.synchronize()
    assert brickkernel.render_bricks_cuda.launches == before + 2
    assert torch.equal(got, again)            # the same from run to run
    ref = brickkernel.render_tiles_bricks_plain(
        bricks, cd, width, height, 0, brickkernel.tile_grid(width, height),
        0, 2, max_depth=depth)
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    err = np.abs(got - ref)
    if depth == 4:       # tests/test_wavefront.py:37-39
        bad = ~np.isclose(got, ref, rtol=1e-4, atol=1e-4)
        assert bad.mean() < 1e-3 and err.mean() < 1e-3
    else:                # tests/test_megakernel.py:74-77
        assert (err.max(axis=-1) > 1e-3).mean() < 2e-3 and err.mean() < 1e-3
        assert abs(float(got.mean() - ref.mean())) < 1e-3
    assert ref.mean() > 0.0
