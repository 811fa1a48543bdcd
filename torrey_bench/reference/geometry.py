"""Device-side geometry math over SoA ``Vec3`` tensors.

Frozen from the PyTorch port's ``ops/geometry.py``: sphere and
triangle intersection (shape.cuh:110-215), orthonormal frames
(frame.h:17-64), hemisphere sampling (scene.h:338-357) and Schlick's
Fresnel.  Branches are ``torch.where`` masks, op for op as in
the JAX package, so the two agree to float32 rounding.  The CUDA megakernel
(csrc/megakernel.cu) repeats the same arithmetic per thread.
"""

from __future__ import annotations

import math

import torch

from .vec import Vec3, cross, dot, normalize

INF = float("inf")
TWO_PI = 2.0 * math.pi
PI = math.pi


# ---------------------------------------------------------------------------
# Ray-AABB slab test
# ---------------------------------------------------------------------------

def slab_interval(org: Vec3, inv_dir: Vec3, box_min: Vec3, box_max: Vec3):
    """Entry and exit distances (tn, tf) of the ray's line through the box.
    ``torch.minimum``/``torch.maximum`` propagate NaN, as jnp's do: a ray
    parallel to an axis whose origin lies on that slab's plane gets
    0 * inf = NaN, and NaN fails every comparison below, so such a box is a
    miss (the brick trace kernel, csrc/brick_trace.cu, does the same)."""
    tx0 = (box_min.x - org.x) * inv_dir.x
    tx1 = (box_max.x - org.x) * inv_dir.x
    ty0 = (box_min.y - org.y) * inv_dir.y
    ty1 = (box_max.y - org.y) * inv_dir.y
    tz0 = (box_min.z - org.z) * inv_dir.z
    tz1 = (box_max.z - org.z) * inv_dir.z
    tn = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                     torch.minimum(ty0, ty1)),
                       torch.minimum(tz0, tz1))
    tf = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                     torch.maximum(ty0, ty1)),
                       torch.maximum(tz0, tz1))
    return tn, tf


def slab_hit(tn, tf, t_max):
    """tf >= max(0, tn) (reference Hit()) plus tn <= t_max closest-hit
    pruning; NaN in tn or tf is a miss."""
    return (tf >= torch.maximum(tn, torch.zeros_like(tn))) & (tn <= t_max)


def slab_test(org: Vec3, inv_dir: Vec3, box_min: Vec3, box_max: Vec3, t_max):
    """Hit mask of the ray against the box, closer than ``t_max``."""
    tn, tf = slab_interval(org, inv_dir, box_min, box_max)
    return slab_hit(tn, tf, t_max)


# ---------------------------------------------------------------------------
# Sphere intersection (shape.cuh:110-186 semantics)
# ---------------------------------------------------------------------------

def intersect_sphere(center: Vec3, radius, org: Vec3, dirn: Vec3, tnear,
                     tfar):
    """Numerically-stable quadratic + root selection matching
    find_intersection_with_sphere.  Returns (t, hit_mask)."""
    v = org - center
    a = dot(dirn, dirn)
    b = 2.0 * dot(dirn, v)
    c = dot(v, v) - radius * radius
    disc = b * b - 4.0 * a * c
    has_root = disc >= 0.0
    root_disc = torch.sqrt(torch.clamp_min(disc, 0.0))
    b_pos = b >= 0.0
    q = torch.where(b_pos, -b - root_disc, -b + root_disc)
    a_zero = a == 0.0
    safe_a = torch.where(a_zero, 1.0, a)
    safe_q = torch.where(q == 0.0, 1.0, q)
    r0 = torch.where(b_pos, q / (2.0 * safe_a), 2.0 * c / safe_q)
    r1 = torch.where(b_pos, 2.0 * c / safe_q, q / (2.0 * safe_a))
    lin_ok = b != 0.0
    lin_t = -c / torch.where(lin_ok, b, 1.0)
    t0 = torch.where(a_zero, lin_t, torch.minimum(r0, r1))
    t1 = torch.where(a_zero, lin_t, torch.maximum(r0, r1))
    has_root = torch.where(a_zero, lin_ok, has_root)

    t0_ok = (t0 >= tnear) & (t0 < tfar)
    t1_ok = (t1 >= tnear) & (t1 < tfar)
    t = torch.where(t0_ok, t0, torch.where(t1_ok, t1, t0))
    hit = has_root & (t >= tnear) & (t < tfar)
    return t, hit


def sphere_shading(center: Vec3, radius, org: Vec3, dirn: Vec3, t):
    """Position / normal / spherical uv at parameter t (shape.cuh:163-179).
    Returns (p: Vec3, n: Vec3, u, v)."""
    p = org + dirn * t
    n = normalize(p - center)
    theta = torch.arccos(torch.clamp(n.y, -1.0, 1.0))
    phi = torch.atan2(-n.z, n.x) + PI
    return p, n, phi / TWO_PI, theta / PI


# ---------------------------------------------------------------------------
# Triangle intersection (shape.cuh:188-215, precomputed edges)
# ---------------------------------------------------------------------------

def intersect_triangle(p0: Vec3, e1: Vec3, e2: Vec3, org: Vec3, dirn: Vec3,
                       tnear, tfar):
    """Moller-Trumbore with e1 = p1-p0, e2 = p2-p0.
    Returns (t, u, v, hit_mask)."""
    s1 = cross(dirn, e2)
    divisor = dot(s1, e1)
    ok = divisor != 0.0
    inv_div = 1.0 / torch.where(ok, divisor, 1.0)
    s = org - p0
    u = dot(s, s1) * inv_div
    s2 = cross(s, e1)
    v = dot(dirn, s2) * inv_div
    t = dot(e2, s2) * inv_div
    hit = (ok & (t > tnear) & (t < tfar) & (u >= 0.0) & (v >= 0.0)
           & (u + v <= 1.0))
    return t, u, v, hit


# ---------------------------------------------------------------------------
# Orthonormal frames (Duff et al. 2017; the reference uses Frisvad with a
# -z special case, frame.h:17-64)
# ---------------------------------------------------------------------------

def make_frame(n: Vec3):
    """Returns (x, y) tangents completing unit n to an ONB."""
    s = torch.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n.z)
    b = n.x * n.y * a
    x = Vec3(1.0 + s * n.x * n.x * a, s * b, -s * n.x)
    y = Vec3(b, s + n.y * n.y * a, -n.y)
    return x, y


def frame_to_world(x: Vec3, y: Vec3, n: Vec3, v: Vec3) -> Vec3:
    return x * v.x + y * v.y + n * v.z


# ---------------------------------------------------------------------------
# Hemisphere sampling (scene.h:338-357)
# ---------------------------------------------------------------------------

def sample_cos_hemisphere(u1, u2) -> Vec3:
    phi = TWO_PI * u1
    tmp = torch.sqrt(torch.clamp(1.0 - u2, 0.0, 1.0))
    return Vec3(torch.cos(phi) * tmp, torch.sin(phi) * tmp,
                torch.sqrt(torch.clamp(u2, 0.0, 1.0)))


def sample_cos_n_hemisphere(u1, u2, exponent) -> Vec3:
    phi = TWO_PI * u1
    cos_theta = torch.pow(torch.clamp(u2, 1e-30, 1.0), 1.0 / (exponent + 1.0))
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, 0.0, 1.0))
    return Vec3(torch.cos(phi) * sin_theta, torch.sin(phi) * sin_theta,
                cos_theta)


def schlick_fresnel(f0: Vec3, cos_theta) -> Vec3:
    """F0 + (1-F0)(1-cos)^5 (scene.h:333-336)."""
    m = torch.clamp(1.0 - cos_theta, 0.0, 1.0)
    m5 = m * m * m * m * m
    return Vec3(f0.x + (1.0 - f0.x) * m5,
                f0.y + (1.0 - f0.y) * m5,
                f0.z + (1.0 - f0.z) * m5)
