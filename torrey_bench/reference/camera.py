"""Camera model + primary ray generation.

Frozen from the PyTorch port's ``ops/camera.py``, itself the
analog of the reference's ``camera.cuh``: the host precompute of {origin,
top_left_corner, horizontal, vertical} (camera.cuh:28-43) and the per-pixel
ray formula (camera.cuh:45-50), vectorized over a pixel batch.  Pixel
convention matches the CUDA kernels (main.cu:41-42): u = (i + xi)/W,
v = (j + xi)/H with j = 0 the top row, and
dir = top_left + u*horizontal - v*vertical - origin.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .vec import Vec3, normalize


@dataclass(frozen=True)
class Camera:
    """lookfrom/lookat/up/vfov — mirrors the reference Camera
    (camera.cuh:10-15).  Plain float tuples so it hashes and
    epsilon-compares for the progressive reset (main.cu:297-312)."""
    lookfrom: tuple
    lookat: tuple
    up: tuple
    vfov: float

    @staticmethod
    def from_parsed(cam) -> "Camera":
        return Camera(tuple(float(x) for x in cam.lookfrom),
                      tuple(float(x) for x in cam.lookat),
                      tuple(float(x) for x in cam.up),
                      float(cam.vfov))

    def almost_equal(self, other: "Camera", eps: float = 1e-5) -> bool:
        """The main-loop camera epsilon compare (main.cu:297-310)."""
        va = np.array(self.lookfrom + self.lookat + self.up + (self.vfov,))
        vb = np.array(other.lookfrom + other.lookat + other.up + (other.vfov,))
        return bool(np.all(np.abs(va - vb) < eps))


def camera_ray_data(cam: Camera, width: int, height: int) -> np.ndarray:
    """Host precompute -> [4,3] float32 array (origin, top_left,
    horizontal, vertical); the analog of compute_camera_ray_data
    (camera.cuh:28-43)."""
    aspect = width / height
    viewport_h = 2.0 * np.tan(np.radians(cam.vfov / 2.0))
    viewport_w = aspect * viewport_h
    lookfrom = np.asarray(cam.lookfrom, np.float64)
    lookat = np.asarray(cam.lookat, np.float64)
    up = np.asarray(cam.up, np.float64)
    cam_dir = lookat - lookfrom
    cam_dir = cam_dir / np.linalg.norm(cam_dir)
    right = np.cross(cam_dir, up)
    right = right / np.linalg.norm(right)
    new_up = np.cross(right, cam_dir)
    horizontal = viewport_w * right
    vertical = viewport_h * new_up
    top_left = lookfrom - horizontal / 2 + vertical / 2 + cam_dir
    return np.stack([lookfrom, top_left, horizontal, vertical]).astype(np.float32)


def generate_primary_rays(cam_data: torch.Tensor, u: torch.Tensor,
                          v: torch.Tensor):
    """Vectorized generate_primary_ray (camera.cuh:45-50).
    ``cam_data``: [4,3] tensor from camera_ray_data; u, v: screen coords in
    [0,1] of any one shape.  Returns SoA (org, dir) Vec3s of that shape."""
    o = cam_data[0]
    tl = cam_data[1]
    h = cam_data[2]
    vv = cam_data[3]
    d = Vec3(tl[0] + u * h[0] - v * vv[0] - o[0],
             tl[1] + u * h[1] - v * vv[1] - o[1],
             tl[2] + u * h[2] - v * vv[2] - o[2])
    d = normalize(d)
    ones = torch.ones_like(u)
    org = Vec3(o[0] * ones, o[1] * ones, o[2] * ones)
    return org, d
