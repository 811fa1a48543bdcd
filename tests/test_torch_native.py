"""The port's C++ host builders (models/native.py): the BVH of
models/bvh.py and the SAH treelets of models/sah.py, bit for bit the numpy
builders' arrays and the JAX package's native ones (its models/native.py
over its own build of the same sources), on random boxes and on
scenes/blob_box.xml (as built and subdivided once).  The library is built
with g++ into the package's _build/; the cases skip without g++.
"""

import shutil

import numpy as np
import pytest

from pathtracer_cuda_interactive_tpu.models import native as jax_native
from pathtracer_cuda_interactive_tpu_torch import SCENES_DIR
from pathtracer_cuda_interactive_tpu_torch.io.xml_scene import parse_scene
from pathtracer_cuda_interactive_tpu_torch.models import native, sah
from pathtracer_cuda_interactive_tpu_torch.models.bvh import (
    build_bvh, validate_bvh)
from pathtracer_cuda_interactive_tpu_torch.models.scenepack import pack_scene
from pathtracer_cuda_interactive_tpu_torch.models.subdivide import (
    subdivide_scene)

SAH_FIELDS = ("node_min", "node_max", "skip", "leaf_of_node", "order",
              "leaf_start", "leaf_count")


@pytest.fixture(scope="module")
def built():
    """The port's library, built (or found) in _build/."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    assert native.available()
    return native.library_path(shutil.which("g++"))


def _random_boxes(P, seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (P, 3)).astype(np.float32)
    half = rng.uniform(0.01, 0.5, (P, 3)).astype(np.float32)
    return centers - half, centers + half


def _blob_boxes(levels):
    parsed = parse_scene(str(SCENES_DIR / "blob_box.xml"))
    if levels:
        parsed = subdivide_scene(parsed, levels=levels)
    pack = pack_scene(parsed)
    p0 = pack.tri_p0
    p1, p2 = p0 + pack.tri_e1, p0 + pack.tri_e2
    return (np.minimum(np.minimum(p0, p1), p2),
            np.maximum(np.maximum(p0, p1), p2))


BOXES = {f"random{P}": (lambda P=P: _random_boxes(P, seed=P))
         for P in (2, 3, 7, 100, 4096, 50001)}
BOXES["blob_box"] = lambda: _blob_boxes(0)
BOXES["blob_box_x1"] = lambda: _blob_boxes(1)


def _same(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, name
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                  err_msg=name)


@pytest.mark.parametrize("case", sorted(BOXES))
def test_bvh_native_equals_numpy(built, case):
    pmin, pmax = BOXES[case]()
    ref = build_bvh(pmin, pmax, use_native=False)
    got = native.build_bvh_native(pmin, pmax)
    assert got is not None
    for i, f in enumerate(("node_min", "node_max", "skip", "prim")):
        _same(got[i], getattr(ref, f), f)
    assert got[4] == ref.depth
    bvh = build_bvh(pmin, pmax)
    _same(bvh.skip, ref.skip, "dispatch")
    validate_bvh(bvh, pmin, pmax)


@pytest.mark.parametrize("case,leaf", [
    ("random2", 512), ("random100", 16), ("random4096", 64),
    ("random50001", 512), ("blob_box", 16), ("blob_box", 512),
    ("blob_box_x1", 64), ("blob_box_x1", 512)])
def test_sah_native_equals_numpy(built, case, leaf):
    pmin, pmax = BOXES[case]()
    ref = sah._build_sah_treelets_numpy(pmin, pmax, leaf_size=leaf)
    got = native.build_sah_treelets_native(pmin, pmax, leaf)
    assert got is not None
    for i, f in enumerate(SAH_FIELDS):
        _same(got[i], getattr(ref, f), f)
    assert got[7] == ref.depth
    tree = sah.build_sah_treelets(pmin, pmax, leaf_size=leaf)
    _same(tree.order, ref.order, "dispatch")
    sah.validate_treelets(tree, pmin, pmax)


@pytest.mark.parametrize("case,leaf", [("random4096", 64),
                                       ("blob_box_x1", 512)])
def test_native_equals_jax_native(built, case, leaf):
    """The JAX package's bridge over its own build of the same sources."""
    if not jax_native.available():
        pytest.skip("the JAX package's native library is unavailable")
    pmin, pmax = BOXES[case]()
    got = native.build_bvh_native(pmin, pmax)
    want = jax_native.build_bvh_native(pmin, pmax)
    for i in range(4):
        _same(got[i], want[i], i)
    assert got[4] == want[4]
    got = native.build_sah_treelets_native(pmin, pmax, leaf)
    want = jax_native.build_sah_treelets_native(pmin, pmax, leaf)
    for i, f in enumerate(SAH_FIELDS):
        _same(got[i], want[i], f)
    assert got[7] == want[7]


def test_library_lands_in_the_ports_build_dir(built):
    assert built.exists() and built.parent == native.BUILD_DIR
    assert built.name.startswith("pt_native_")
    assert native._load()._name == str(built)


def test_no_native_switch_read_after_import(built, monkeypatch):
    pmin, pmax = _random_boxes(100, seed=5)
    assert native.build_bvh_native(pmin, pmax) is not None
    monkeypatch.setenv("PT_TPU_NO_NATIVE", "1")
    assert not native.available()
    assert native.build_bvh_native(pmin, pmax) is None
    assert native.build_sah_treelets_native(pmin, pmax, 16) is None
    ref = sah._build_sah_treelets_numpy(pmin, pmax, leaf_size=16)
    _same(sah.build_sah_treelets(pmin, pmax, 16).skip, ref.skip, "numpy")
    monkeypatch.delenv("PT_TPU_NO_NATIVE")
    assert native.available()


def test_bad_boxes_raise(built):
    with pytest.raises(ValueError, match=r"\[P, 3\]"):
        native.build_bvh_native(np.zeros((4, 2)), np.zeros((4, 2)))
