"""Build the package's hand-written CUDA kernels with ``nvcc``.

Each ``csrc/*.cu`` file has a plain C launch function and is compiled on
its own for ``sm_90a`` into a shared library under ``_build/`` beside the
package, named by a hash of its source, the shared ``csrc/*.cuh`` headers
and the flags, then loaded with ``ctypes`` by its op module
(ops/megakernel.py, ops/wavefront.py, ops/brickkernel.py,
ops/pairtrace.py, ops/wave_step.py, experiments/mx2.py) through ``load``,
the set-up span ``setup.kernels`` (utils/trace.py).  A library that is
already there is reused.  A missing ``nvcc`` or a failed
build raises: there is no fallback.

``build_all`` starts one ``nvcc`` per missing library at once, so a fresh
checkout builds all kernels in the time of the slowest.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from ..utils.trace import setup_span

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
# --fmad=false and no fast math keep each kernel's float arithmetic op for
# op with its plain version (FMA contraction alone moves triangle-edge
# hits); nvcc's defaults keep IEEE division and sqrtf.  -Xptxas=-v reports
# registers and spills at build time.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (needed to build the kernels in "
                       "csrc/)")


def library_path(source: Path, build_dir: Path) -> Path:
    """Where the library of ``source`` built with NVCC_FLAGS lives: named
    by a hash of the source, of every header beside it (``*.cuh``, which
    the sources include) and of the flags, so an edit to any of them
    builds anew."""
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir / f"{source.stem}_{digest.hexdigest()[:16]}.so"


def build(source: Path, build_dir: Path = BUILD_DIR) -> Path:
    """Compile one ``.cu`` file unless its library exists; return the
    library's path.  Raises if nvcc is missing or the build fails."""
    build_all([source], build_dir)
    return library_path(source, build_dir)


def load(source: Path, build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """Build ``source`` unless its library is there, and load it."""
    with setup_span("setup.kernels"):
        return ctypes.CDLL(str(build(source, build_dir)))


def build_all(sources, build_dir: Path = BUILD_DIR) -> dict:
    """Build every source whose library is missing, all ``nvcc`` processes
    at once, and print each one's time and ptxas report.  Returns {source:
    seconds until its build ended, 0.0 if its library was there}.  Raises
    if nvcc is missing or a build fails, after every build has ended."""
    t0 = time.perf_counter()
    seconds = {source: 0.0 for source in sources}
    missing = [s for s in sources if not library_path(s, build_dir).exists()]
    compiler = nvcc() if missing else None
    started = []
    for source in missing:
        lib_path = library_path(source, build_dir)
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp_path = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp_path), str(source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        started.append((source, lib_path, tmp_path, proc))
    errors = []
    for source, lib_path, tmp_path, proc in started:
        out, err = proc.communicate()
        seconds[source] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}) on "
                          f"{source.name}:\n{err}")
            continue
        os.replace(tmp_path, lib_path)
        print(f"built {lib_path.name} in {seconds[source]:.2f} s")
        for line in (out + err).splitlines():
            if line.strip():
                print(f"  {line.strip()}")   # ptxas: registers, stack, spills
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds
