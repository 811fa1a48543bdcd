"""The port's large-scene host layer against the JAX package.

The SAH treelet builder, the brick decomposition and the mesh subdivision
are numpy code copied from the JAX package, so every array must be
identical.  The JAX package would build its SAH tree with its C++ twin when
that library is available; these tests pin it to its numpy body, the
semantic reference the port copies.  ``BrickSet`` holds tensors, built from
the port's own ScenePack (``from_pack``) or from the JAX BrickSet's fields
(``from_numpy``); both must equal the JAX BrickSet field for field.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from pathtracer_cuda_interactive_tpu.models import native as jax_native
from pathtracer_cuda_interactive_tpu.models import sah as jax_sah
from pathtracer_cuda_interactive_tpu.models.bricks import (
    BrickSet as JaxBrickSet)
from pathtracer_cuda_interactive_tpu.models.scenepack import (
    load_scene as jax_load_scene)
from pathtracer_cuda_interactive_tpu.models.subdivide import (
    subdivide_mesh as jax_subdivide_mesh)
from pathtracer_cuda_interactive_tpu_torch import SCENES_DIR
from pathtracer_cuda_interactive_tpu_torch.io.xml_scene import parse_scene
from pathtracer_cuda_interactive_tpu_torch.models import bricks, sah
from pathtracer_cuda_interactive_tpu_torch.models.bricks import BrickSet
from pathtracer_cuda_interactive_tpu_torch.models.ir import ParsedTriangleMesh
from pathtracer_cuda_interactive_tpu_torch.models.scenepack import (
    load_scene, pack_scene)
from pathtracer_cuda_interactive_tpu_torch.models.subdivide import (
    subdivide_mesh, subdivide_scene)

# The suite runs in several worker processes at once and these tensors are
# small: one intra-op thread per process keeps the workers from spinning
# against each other for the machine's cores.
torch.set_num_threads(1)

BLOB_BOX = str(SCENES_DIR / "blob_box.xml")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same(got, ref, name):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, name
    np.testing.assert_array_equal(_bits(got), _bits(ref), err_msg=name)


@pytest.fixture(scope="module")
def jax_bricks():
    """The JAX BrickSet of blob_box, built with the numpy SAH body."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "build_sah_treelets_native",
                   lambda *args: None)
        return JaxBrickSet.from_pack(jax_load_scene(BLOB_BOX)[0])


def _blob_boxes():
    pack, _ = load_scene(BLOB_BOX)
    p0 = pack.tri_p0
    p1, p2 = p0 + pack.tri_e1, p0 + pack.tri_e2
    return (np.minimum(np.minimum(p0, p1), p2),
            np.maximum(np.maximum(p0, p1), p2))


def _random_boxes():
    rs = np.random.default_rng(7)
    lo = rs.uniform(-5.0, 5.0, (3000, 3)).astype(np.float32)
    return lo, lo + rs.uniform(0.0, 0.3, (3000, 3)).astype(np.float32)


@pytest.mark.parametrize("source,leaf_size", [("random", 512),
                                              ("random", 40),
                                              ("blob", 512),
                                              ("blob", 64)])
def test_sah_treelets_match_jax_numpy_body(source, leaf_size):
    lo, hi = _random_boxes() if source == "random" else _blob_boxes()
    got = sah.build_sah_treelets(lo, hi, leaf_size=leaf_size)
    ref = jax_sah._build_sah_treelets_numpy(lo, hi, leaf_size=leaf_size)
    for f in dataclasses.fields(jax_sah.SAHTreelets):
        r, g = getattr(ref, f.name), getattr(got, f.name)
        if isinstance(r, np.ndarray):
            _assert_same(g, r, f.name)
        else:
            assert g == r, f.name
    sah.validate_treelets(got, lo, hi)
    assert got.num_leaves >= len(lo) // leaf_size


def test_brickset_from_pack_matches_jax(jax_bricks):
    got = BrickSet.from_pack(load_scene(BLOB_BOX)[0])
    for f in dataclasses.fields(JaxBrickSet):
        r, g = getattr(jax_bricks, f.name), getattr(got, f.name)
        if isinstance(g, torch.Tensor):
            _assert_same(g, r, f.name)
        else:
            assert g == r, f.name
    assert got.num_bricks > 4 and got.num_spheres == 1
    assert got.top_depth == bricks.top_tree_depth(
        got.top_links.numpy(), got.num_top)
    assert sum(bricks.brick_prim_count(got, b)
               for b in range(got.num_bricks)) == 5132


def test_brickset_from_numpy_round_trip(jax_bricks):
    fields = {f.name: getattr(jax_bricks, f.name)
              for f in dataclasses.fields(JaxBrickSet)}
    got = BrickSet.from_numpy(**{k: v if isinstance(v, int) else
                                 np.asarray(v) for k, v in fields.items()})
    ref = BrickSet.from_pack(load_scene(BLOB_BOX)[0])
    again = BrickSet.from_numpy(**{
        f.name: (getattr(got, f.name).numpy()
                 if isinstance(getattr(got, f.name), torch.Tensor)
                 else getattr(got, f.name))
        for f in dataclasses.fields(BrickSet)})
    moved = got.to("meta")
    for f in dataclasses.fields(BrickSet):
        a, b, c = getattr(got, f.name), getattr(ref, f.name), \
            getattr(again, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b) and torch.equal(a, c), f.name
            assert getattr(moved, f.name).device.type == "meta", f.name
        else:
            assert a == b == c, f.name
    assert got.device.type == "cpu"
    assert got.nbytes > got.brick_data.numel() * 4


def test_top_tree_depth_counts_levels():
    # root (0) -> leaf 1, internal 2 -> leaves 3, 4: three levels
    links = np.array([[5, -1], [2, 0], [5, -1], [4, 1], [5, 2]], np.int32)
    assert bricks.top_tree_depth(links, 5) == 3
    assert bricks.top_tree_depth(np.array([[1, 0]], np.int32), 1) == 1


@pytest.mark.parametrize("levels", [1, 2])
def test_subdivide_mesh_matches_jax(levels):
    parsed = parse_scene(BLOB_BOX)
    mesh = next(s for s in parsed.shapes
                if isinstance(s, ParsedTriangleMesh) and len(s.indices) > 100)
    got = subdivide_mesh(mesh, levels)
    ref = jax_subdivide_mesh(mesh, levels)
    for name in ("positions", "indices", "normals", "uvs"):
        r, g = getattr(ref, name), getattr(got, name)
        if r is None:
            assert g is None, name
        else:
            _assert_same(g, r, name)
    assert len(got.indices) == 5120 * 4 ** levels


def test_subdivide_scene_keeps_small_meshes():
    parsed = parse_scene(BLOB_BOX)
    pack = pack_scene(subdivide_scene(parsed, levels=1))
    assert pack.num_triangles == 5120 * 4 + 12 and pack.num_spheres == 1


def test_blob_generator_reproduces_the_committed_mesh(tmp_path):
    sys.path.insert(0, str(SCENES_DIR))
    try:
        import make_blob
    finally:
        sys.path.remove(str(SCENES_DIR))
    out = tmp_path / "blob.obj"
    assert make_blob.main([str(out)]) == 0
    assert out.read_text() == (SCENES_DIR / "blob.obj").read_text()
    verts, faces = make_blob.blob()
    assert faces.shape == (5120, 3) and verts.shape == (2562, 3)
