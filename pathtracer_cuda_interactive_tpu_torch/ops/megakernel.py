"""The small-scene megakernel: the whole progressive sample pass in one
hand-written CUDA kernel (csrc/megakernel.cu).

The port of ``pathtracer_cuda_interactive_tpu/ops/megakernel.py``.  Scenes
with at most ``MEGAKERNEL_MAX_PRIMS`` primitives (the sphere scenes and the
Cornell box) render through it: one launch computes, per pixel, the
radiance sum of ``num_samples`` full paths.

``render_samples_megakernel`` dispatches on the device of its tensors:

* CUDA tensors launch the kernel (``megakernel_cuda``).  It never falls
  back: a missing ``nvcc``, a failed build or a refused launch raises.
* CPU tensors run the kernel's plain version,
  ``ops/integrator.py::render_pixel_sums``, in plain torch ops.  That is
  also what the kernel is held to on the card (chip_smoke.py), by calling
  the plain version directly on CUDA tensors.

The kernel is built at first use with ``nvcc`` for ``sm_90a`` from the
source in this package into ``_build/`` beside it, under a file name keyed
on a hash of the source and flags (ops/cuda_build.py), and bound with
``ctypes``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..models.device_scene import DeviceScene
from . import cuda_build
from .integrator import MAX_DEPTH, RR_START_DEPTH, render_pixel_sums

# Scenes up to this many primitives render through the megakernel (its
# per-primitive loop is O(P); the table fits in one block's shared memory).
MEGAKERNEL_MAX_PRIMS = 512

SOURCE = cuda_build.CSRC_DIR / "megakernel.cu"
BUILD_DIR = cuda_build.BUILD_DIR

_lib = None


def build() -> Path:
    """Compile csrc/megakernel.cu into a shared library under BUILD_DIR,
    unless a library of this source and these flags is there already.
    Returns its path; raises if nvcc is missing or the build fails."""
    return cuda_build.build(SOURCE, BUILD_DIR)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(SOURCE, BUILD_DIR)
        fn = lib.pt_megakernel_launch
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, i32, i32,             # prim_rows, S, F
                       ptr, i32,                  # light_rows, NL
                       ptr, ptr, ptr,             # cam, bg, out
                       i32, i32, i32, i32,        # width, height, pix0, count
                       ctypes.c_uint, i32, i32,   # sample_start, n, n_real
                       ctypes.c_uint, i32, i32,   # seed, max_depth, rr_start
                       ptr]                       # stream
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_cuda_f32(name: str, t: torch.Tensor, device) -> None:
    if t.device != device or t.dtype != torch.float32 \
            or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous float32 tensor on "
                         f"{device}, got {t.dtype} on {t.device}")


def megakernel_cuda(prim_rows: torch.Tensor, num_spheres: int,
                    num_triangles: int, light_rows, cam: torch.Tensor,
                    bg: torch.Tensor, width: int, height: int, pix0: int,
                    count: int, sample_start: int, num_samples: int,
                    num_real: int, seed: int, max_depth: int,
                    rr_start_depth: int) -> torch.Tensor:
    """Launch the CUDA megakernel on the current stream.

    Inputs are CUDA float32 tensors: ``prim_rows`` [P_pad, 32] (spheres
    first, then triangles), ``light_rows`` [NL, 8] or None, ``cam`` [4, 3]
    (origin, top_left, horizontal, vertical), ``bg`` [3].  Returns a FRESH
    [count, 3] tensor: per pixel of [pix0, pix0 + count), the radiance sum
    of the first ``num_real`` (-1: all) of ``num_samples`` passes starting
    at ``sample_start``.  It does not add into an accumulation buffer; the
    caller does.  Adds one to ``megakernel_cuda.launches`` per launch."""
    device = prim_rows.device
    if device.type != "cuda":
        raise ValueError(f"megakernel_cuda needs CUDA tensors, got {device}")
    for name, t in (("prim_rows", prim_rows), ("cam", cam), ("bg", bg)):
        _check_cuda_f32(name, t, device)
    P = num_spheres + num_triangles
    if prim_rows.ndim != 2 or prim_rows.shape[1] != 32 \
            or prim_rows.shape[0] < P:
        raise ValueError(f"prim_rows: need [>= {P}, 32], got "
                         f"{tuple(prim_rows.shape)}")
    if not 0 < P <= MEGAKERNEL_MAX_PRIMS:
        raise ValueError(f"megakernel takes 1..{MEGAKERNEL_MAX_PRIMS} "
                         f"primitives, got {P}")
    if cam.numel() != 12 or bg.numel() != 3:
        raise ValueError("cam must hold 12 floats and bg 3")
    num_lights = 0
    if light_rows is not None:
        _check_cuda_f32("light_rows", light_rows, device)
        if light_rows.ndim != 2 or light_rows.shape[1] != 8:
            raise ValueError("light_rows: need [NL, 8]")
        num_lights = int(light_rows.shape[0])
    if not (0 <= pix0 and count >= 0 and pix0 + count <= width * height):
        raise ValueError(f"pixel range [{pix0}, {pix0 + count}) outside "
                         f"{width}x{height}")
    if max_depth < 1 or num_samples < 0:
        raise ValueError("need max_depth >= 1 and num_samples >= 0")

    lib = load_library()
    out = torch.empty((count, 3), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.pt_megakernel_launch(
            prim_rows.data_ptr(), num_spheres, num_triangles,
            light_rows.data_ptr() if light_rows is not None else None,
            num_lights, cam.data_ptr(), bg.data_ptr(), out.data_ptr(),
            width, height, pix0, count, sample_start & 0xFFFFFFFF,
            num_samples, num_real, seed & 0xFFFFFFFF, max_depth,
            rr_start_depth, stream)
    if err != 0:
        raise RuntimeError(f"megakernel launch failed: CUDA error {err}")
    megakernel_cuda.launches += 1
    return out


megakernel_cuda.launches = 0


def pack_light_rows(scene: DeviceScene):
    """[NL, 8] f32 point-light table (pos xyz, intensity rgb, pad), or None
    when the scene has no point lights."""
    NL = int(scene.light_pos.shape[0])
    if NL == 0:
        return None
    rows = torch.zeros((NL, 8), dtype=torch.float32, device=scene.device)
    rows[:, 0:3] = scene.light_pos
    rows[:, 3:6] = scene.light_intensity
    return rows


def render_pixels_megakernel(scene: DeviceScene, cam_data: torch.Tensor,
                             width: int, height: int, pix0: int, count: int,
                             sample_start: int, num_samples: int = 1,
                             seed: int = 1984, max_depth: int = MAX_DEPTH,
                             rr_start_depth: int = RR_START_DEPTH,
                             nee: bool = False,
                             num_real=None) -> torch.Tensor:
    """Radiance sums [count, 3] for pixels [pix0, pix0 + count) over the
    first ``num_real`` (None: all) of ``num_samples`` passes — the unit a
    tile or sample split across devices would partition.  Runs the kernel
    for CUDA tensors and its plain version for CPU tensors."""
    if scene.num_prims > MEGAKERNEL_MAX_PRIMS:
        raise ValueError(f"{scene.num_prims} primitives exceed the "
                         f"megakernel's {MEGAKERNEL_MAX_PRIMS}")
    device = cam_data.device
    if device.type == "cpu":
        pix = torch.arange(pix0, pix0 + count, dtype=torch.int32)
        return render_pixel_sums(scene, cam_data, pix, width, height,
                                 sample_start, num_samples, seed, max_depth,
                                 nee, rr_start_depth, num_real)
    if device.type != "cuda":
        raise ValueError(f"no megakernel for device {device}")
    bg = torch.stack([scene.bg_r, scene.bg_g, scene.bg_b])
    light_rows = pack_light_rows(scene) if nee else None
    return megakernel_cuda(
        scene.prim_rows, scene.num_spheres, scene.num_triangles, light_rows,
        cam_data.reshape(12).contiguous(), bg, width, height, pix0, count,
        sample_start, num_samples, -1 if num_real is None else num_real,
        seed, max_depth, rr_start_depth)


def render_samples_megakernel(scene: DeviceScene, cam_data: torch.Tensor,
                              width: int, height: int, sample_start: int,
                              num_samples: int = 1, seed: int = 1984,
                              max_depth: int = MAX_DEPTH,
                              rr_start_depth: int = RR_START_DEPTH,
                              nee: bool = False) -> torch.Tensor:
    """Drop-in for ops.integrator.render_samples on scenes with <=
    MEGAKERNEL_MAX_PRIMS primitives: the [H, W, 3] radiance sum of
    ``num_samples`` passes, a fresh tensor on ``cam_data``'s device."""
    out = render_pixels_megakernel(scene, cam_data, width, height, 0,
                                   width * height, sample_start, num_samples,
                                   seed, max_depth, rr_start_depth, nee)
    return out.reshape(height, width, 3)
