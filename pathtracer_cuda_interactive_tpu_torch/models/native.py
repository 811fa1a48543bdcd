"""ctypes bridge to the C++ host builders (``native/`` at the repo root).

The port of ``pathtracer_cuda_interactive_tpu/models/native.py``.  The BVH
build of models/bvh.py and the binned-SAH treelet build of models/sah.py
have C++ twins (``native/bvh_builder.cpp``, ``native/sah_treelets.cpp``):
the same algorithms with the same float64 numerics, stable partitions and
first-minimum tie rules, so both give the numpy builders' arrays bit for
bit, several times faster at a million primitives.  The numpy builders stay
the always-available fallback and the reference
(tests/test_torch_native.py).

The two sources are compiled as they are, with ``native/Makefile``'s
flags, by ``g++`` into one shared library under the package's ``_build/``
the first time a builder needs it, named by a hash of the sources, the
flags and what ``-march=native`` means on this host (a library built for
one CPU is never loaded on another).  When ``g++`` is missing or the build
fails, the builders return None and the numpy path runs.  Setting
``PT_TPU_NO_NATIVE`` (to anything but the empty string) forces the numpy
path; it is read at every build, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCES = tuple(PKG_DIR.parent / "native" / name
                for name in ("bvh_builder.cpp", "sah_treelets.cpp"))
BUILD_DIR = PKG_DIR / "_build"
# native/Makefile's CXXFLAGS.  ISO C++ (-std=c++17, not gnu++17) keeps GCC
# from contracting a*b+c into an FMA, which could change an SAH cost, and so
# a split, against the numpy build.
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path(cxx: str) -> Path:
    """Where the library built by ``cxx`` with CXX_FLAGS lives: named by a
    hash of both sources, the flags and the target options that
    ``-march=native`` selects on this host."""
    digest = hashlib.sha256()
    for source in SOURCES:
        digest.update(source.name.encode() + source.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True, check=True,
                            timeout=60)
    digest.update(target.stdout.encode())
    return BUILD_DIR / f"pt_native_{digest.hexdigest()[:16]}.so"


def _build(cxx: str) -> Path:
    """Compile both sources unless their library exists; return its path.
    Raises on a failed build."""
    lib_path = library_path(cxx)
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp_path = lib_path.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp_path),
                        *map(str, SOURCES)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp_path, lib_path)
    return lib_path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    lp = ctypes.POINTER(ctypes.c_int64)
    lib.pt_build_bvh.restype = ctypes.c_int
    lib.pt_build_bvh.argtypes = [fp, fp, ctypes.c_int64, fp, fp, ip, ip, ip]
    lib.pt_build_sah_treelets.restype = ctypes.c_int
    lib.pt_build_sah_treelets.argtypes = [
        fp, fp, ctypes.c_int64, ctypes.c_int64, fp, fp, ip, ip, lp, lp, lp,
        lp]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The library, built on first need; None when ``PT_TPU_NO_NATIVE`` is
    set, ``g++`` is missing or the build failed (tried once a process)."""
    global _lib, _tried
    if os.environ.get("PT_TPU_NO_NATIVE"):
        return None
    with _lock:
        if not _tried:
            _tried = True
            cxx = shutil.which("g++")
            if cxx is not None:
                try:
                    _lib = _bind(ctypes.CDLL(str(_build(cxx))))
                except (OSError, subprocess.SubprocessError):
                    _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def _boxes(prim_min, prim_max):
    pmin = np.ascontiguousarray(prim_min, np.float32)
    pmax = np.ascontiguousarray(prim_max, np.float32)
    if pmin.ndim != 2 or pmin.shape[1] != 3 or pmax.shape != pmin.shape:
        raise ValueError(f"boxes must be [P, 3] and alike, got {pmin.shape} "
                         f"and {pmax.shape}")
    return pmin, pmax


def build_bvh_native(prim_min: np.ndarray, prim_max: np.ndarray):
    """C++ build of models/bvh.py's tree; (node_min, node_max, skip, prim,
    depth), or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    pmin, pmax = _boxes(prim_min, prim_max)
    P = pmin.shape[0]
    N = 2 * P - 1
    node_min = np.empty((N, 3), np.float32)
    node_max = np.empty((N, 3), np.float32)
    skip = np.empty(N, np.int32)
    prim = np.empty(N, np.int32)
    depth = ctypes.c_int32(0)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    rc = lib.pt_build_bvh(
        pmin.ctypes.data_as(fp), pmax.ctypes.data_as(fp), P,
        node_min.ctypes.data_as(fp), node_max.ctypes.data_as(fp),
        skip.ctypes.data_as(ip), prim.ctypes.data_as(ip), ctypes.byref(depth))
    if rc != 0:
        return None
    return node_min, node_max, skip, prim, int(depth.value)


def build_sah_treelets_native(prim_min: np.ndarray, prim_max: np.ndarray,
                              leaf_size: int):
    """C++ build of models/sah.py's treelets; the SAHTreelets fields
    (node_min, node_max, skip, leaf_of_node, order, leaf_start, leaf_count,
    depth), or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    pmin, pmax = _boxes(prim_min, prim_max)
    P = pmin.shape[0]
    N = 2 * P - 1 if P > 1 else 1
    node_min = np.empty((N, 3), np.float32)
    node_max = np.empty((N, 3), np.float32)
    skip = np.empty(N, np.int32)
    leaf_of = np.empty(N, np.int32)
    order = np.empty(P, np.int64)
    leaf_start = np.empty(P, np.int64)
    leaf_count = np.empty(P, np.int64)
    counts = np.zeros(3, np.int64)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    lp = ctypes.POINTER(ctypes.c_int64)
    rc = lib.pt_build_sah_treelets(
        pmin.ctypes.data_as(fp), pmax.ctypes.data_as(fp), P, int(leaf_size),
        node_min.ctypes.data_as(fp), node_max.ctypes.data_as(fp),
        skip.ctypes.data_as(ip), leaf_of.ctypes.data_as(ip),
        order.ctypes.data_as(lp), leaf_start.ctypes.data_as(lp),
        leaf_count.ctypes.data_as(lp), counts.ctypes.data_as(lp))
    if rc != 0:
        return None
    n, b, depth = (int(c) for c in counts)
    return (node_min[:n].copy(), node_max[:n].copy(), skip[:n].copy(),
            leaf_of[:n].copy(), order, leaf_start[:b].copy(),
            leaf_count[:b].copy(), depth)
