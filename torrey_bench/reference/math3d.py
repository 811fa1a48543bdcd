"""Host-side 3D math foundation (numpy).

TPU-native replacement for the reference's L0 math layer
(``cutil_math.h``, ``matrix.h``, ``transform.cpp``, ``compute_normals.cpp``
in jayHuggie/PathTracer_CUDA_Interactive).  Everything here runs on the host
at scene-build time; the device-side math lives in
the torch modules beside it.

Unlike the reference's scalar ``float3`` API, every function here is
vectorized over leading batch dimensions — points are ``[..., 3]`` numpy
arrays and matrices are plain ``[4, 4]`` numpy arrays (row-major, matching
``matrix.h:5-75`` conventions).
"""

from __future__ import annotations

import numpy as np

Float = np.float32


# ---------------------------------------------------------------------------
# Basic vector helpers
# ---------------------------------------------------------------------------

def normalize(v: np.ndarray, axis: int = -1, eps: float = 0.0) -> np.ndarray:
    """Unit-normalize vectors along ``axis`` (reference: cutil_math.h normalize)."""
    n = np.linalg.norm(v, axis=axis, keepdims=True)
    if eps:
        n = np.maximum(n, eps)
    return v / n


def radians(deg) -> np.ndarray:
    return np.asarray(deg) * (np.pi / 180.0)


def degrees(rad) -> np.ndarray:
    return np.asarray(rad) * (180.0 / np.pi)


def srgb_to_rgb(srgb: np.ndarray) -> np.ndarray:
    """sRGB EOTF decode (reference: parse_scene.cpp:31-38)."""
    srgb = np.asarray(srgb, dtype=np.float64)
    lo = srgb / 12.92
    hi = ((srgb + 0.055) / 1.055) ** 2.4
    return np.where(srgb <= 0.04045, lo, hi).astype(Float)


# ---------------------------------------------------------------------------
# 4x4 transform matrices (row-major; reference: matrix.h, transform.cpp)
# ---------------------------------------------------------------------------

def identity() -> np.ndarray:
    return np.eye(4, dtype=np.float64)


def translate(delta) -> np.ndarray:
    """Reference: transform.cpp:6-11."""
    m = identity()
    m[:3, 3] = np.asarray(delta, dtype=np.float64)
    return m


def scale(s) -> np.ndarray:
    """Reference: transform.cpp:13-18."""
    m = identity()
    m[0, 0], m[1, 1], m[2, 2] = np.asarray(s, dtype=np.float64)
    return m


def rotate(angle_deg: float, axis) -> np.ndarray:
    """Axis-angle rotation, angle in degrees (reference: transform.cpp:20-45)."""
    a = np.asarray(axis, dtype=np.float64)
    a = a / np.linalg.norm(a)
    s = np.sin(radians(angle_deg))
    c = np.cos(radians(angle_deg))
    x, y, z = a
    m = identity()
    m[0, 0] = x * x + (1 - x * x) * c
    m[0, 1] = x * y * (1 - c) - z * s
    m[0, 2] = x * z * (1 - c) + y * s
    m[1, 0] = x * y * (1 - c) + z * s
    m[1, 1] = y * y + (1 - y * y) * c
    m[1, 2] = y * z * (1 - c) - x * s
    m[2, 0] = x * z * (1 - c) - y * s
    m[2, 1] = y * z * (1 - c) + x * s
    m[2, 2] = z * z + (1 - z * z) * c
    return m


def look_at(pos, look, up) -> np.ndarray:
    """Camera-to-world transform (reference: transform.cpp:47-70)."""
    pos = np.asarray(pos, dtype=np.float64)
    look = np.asarray(look, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    d = normalize(look - pos)
    left = normalize(np.cross(normalize(up), d))
    new_up = np.cross(d, left)
    m = identity()
    m[:3, 0] = left
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = pos
    return m


def perspective(fov_deg: float) -> np.ndarray:
    """Reference: transform.cpp:72-78."""
    cot = 1.0 / np.tan(radians(fov_deg / 2.0))
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0] = cot
    m[1, 1] = cot
    m[2, 2] = 1.0
    m[2, 3] = -1.0
    m[3, 2] = 1.0
    return m


def xform_point(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply homogeneous transform to points ``[..., 3]``
    (reference: transform.cpp:80-88)."""
    pts = np.asarray(pts, dtype=np.float64)
    r = pts @ m[:3, :3].T + m[:3, 3]
    w = pts @ m[3, :3].T + m[3, 3]
    return (r / w[..., None]).astype(Float)


def xform_vector(m: np.ndarray, vec: np.ndarray) -> np.ndarray:
    """Reference: transform.cpp:90-94."""
    vec = np.asarray(vec, dtype=np.float64)
    return (vec @ m[:3, :3].T).astype(Float)


def xform_normal(inv_m: np.ndarray, n: np.ndarray) -> np.ndarray:
    """Transform normals with the *inverse* matrix (inverse-transpose rule;
    reference: transform.cpp:96-101).  Pass the inverse of the to-world
    transform, exactly like the reference call sites do."""
    n = np.asarray(n, dtype=np.float64)
    out = n @ inv_m[:3, :3]  # multiply by inverse-transpose == right-mul by inverse
    return normalize(out).astype(Float)


def inverse(m: np.ndarray) -> np.ndarray:
    """Matrix inverse (reference: matrix.h:79-213 cofactor expansion; here LAPACK)."""
    return np.linalg.inv(m)


# ---------------------------------------------------------------------------
# Vertex-normal synthesis (reference: compute_normals.cpp — Nelson Max's
# angle-weighted facet-normal average, vectorized over all faces at once)
# ---------------------------------------------------------------------------

def _unit_angle(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Numerically robust angle between unit vectors (compute_normals.cpp:4-10)."""
    d = np.sum(u * v, axis=-1)
    opp = (np.pi - 2.0) * np.arcsin(
        np.clip(0.5 * np.linalg.norm(v + u, axis=-1), -1.0, 1.0))
    same = 2.0 * np.arcsin(np.clip(0.5 * np.linalg.norm(v - u, axis=-1), -1.0, 1.0))
    return np.where(d < 0, opp, same)


def compute_vertex_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Angle-weighted vertex normals (reference: compute_normals.cpp:12-50).

    positions: [V, 3] float; indices: [F, 3] int.  Returns [V, 3] float32.
    Degenerate faces contribute nothing; degenerate vertex normals are zero,
    matching the reference's behavior.
    """
    positions = np.asarray(positions, dtype=np.float64)
    indices = np.asarray(indices, dtype=np.int64)
    v0 = positions[indices[:, 0]]
    v1 = positions[indices[:, 1]]
    v2 = positions[indices[:, 2]]
    side1 = v1 - v0
    side2 = v2 - v0
    fn = np.cross(side1, side2)
    l = np.linalg.norm(fn, axis=-1)
    ok = l != 0
    # Avoid div-by-zero; contributions from degenerate faces masked out below.
    n = fn / np.where(ok, l, 1.0)[:, None]

    def corner_angle(a, b):
        return _unit_angle(normalize(a, eps=1e-30), normalize(b, eps=1e-30))

    w0 = corner_angle(side1, side2)
    w1 = corner_angle(v2 - v1, v0 - v1)
    w2 = corner_angle(v0 - v2, v1 - v2)

    normals = np.zeros_like(positions)
    for corner, w in ((0, w0), (1, w1), (2, w2)):
        contrib = n * np.where(ok, w, 0.0)[:, None]
        np.add.at(normals, indices[:, corner], contrib)

    l = np.linalg.norm(normals, axis=-1)
    nz = l != 0
    normals = np.where(nz[:, None], normals / np.where(nz, l, 1.0)[:, None], 0.0)
    return normals.astype(Float)
