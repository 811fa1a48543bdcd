"""The least time a frame's fixed work needs on one NVIDIA H100.

The work is the configuration's, not the program's: ``fixed_work`` in the
configuration's file holds what the benchmark's own reference counted once
(``python3 -m torrey_bench.fixed_work``): rays a camera sample, and box,
triangle and sphere tests a ray in the reference's own closest-hit search
(brute force up to 512 primitives, its BVH walk above), and the bytes of
its scene tables; where the configuration samples its point lights, the
shadow rays a camera sample and the tests a shadow ray in the reference's
any-hit search.  An absent count is 0.  Whatever implements the frame, its
kernels need at least the larger of these operations over the FP32 peak and
these bytes over the memory peak.
"""

from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM at a 700 W power limit (NVIDIA's
# data sheet): float32 outside the tensor cores, and HBM3.
PEAK_FP32_OPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# float32 operations of one slab test (6 subtractions, 6 products, 12
# min/max, 2 comparisons), of one Moller-Trumbore test (two cross products,
# four dot products, a reciprocal, a subtraction, three scalings and the
# range checks) and of one sphere test (a subtraction, two dot products, the
# discriminant, a square root, two roots and the range checks).
BOX_OPS = 26
TRI_OPS = 52
SPHERE_OPS = 24
# a ray read once (origin and direction), its hit written once (t and
# primitive id), an image pixel written once (three floats)
RAY_BYTES = 24
HIT_BYTES = 8
PIXEL_BYTES = 12
# a shadow ray's origin and direction read once, its occlusion flag (one
# byte) written once
SHADOW_RAY_BYTES = RAY_BYTES + 1


def frame_work(fixed: dict, width: int, height: int, spf: int) -> tuple:
    """(operations, bytes) of one frame of ``spf`` samples a pixel: the
    closest-hit rays' tests, and the shadow rays' where ``fixed`` counts
    any (their tests at the same operations a test)."""
    rays = width * height * spf * fixed["rays_per_sample"]
    shadow = width * height * spf * fixed.get("shadow_rays_per_sample", 0)
    ops = (rays * (fixed["box_tests_per_ray"] * BOX_OPS
                   + fixed["tri_tests_per_ray"] * TRI_OPS
                   + fixed["sphere_tests_per_ray"] * SPHERE_OPS)
           + shadow * (fixed.get("shadow_box_tests_per_ray", 0) * BOX_OPS
                       + fixed.get("shadow_tri_tests_per_ray", 0) * TRI_OPS
                       + fixed.get("shadow_sphere_tests_per_ray", 0)
                       * SPHERE_OPS))
    nbytes = (fixed["scene_bytes"] + rays * (RAY_BYTES + HIT_BYTES)
              + shadow * SHADOW_RAY_BYTES + width * height * PIXEL_BYTES)
    return ops, nbytes


def least_ms(fixed: dict, width: int, height: int, spf: int) -> tuple:
    """(ms, "operations" or "bytes"): the least time of one frame's work
    and which peak bounds it."""
    ops, nbytes = frame_work(fixed, width, height, spf)
    by_ops = ops / PEAK_FP32_OPS * 1e3
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (max(by_ops, by_bytes),
            "operations" if by_ops >= by_bytes else "bytes")
