"""SoA 3-vector type over torch tensors.

The reference's math layer is Cg-style ``float3`` AoS (cutil_math.h).  The
port keeps the JAX package's structure-of-arrays form: ``Vec3`` holds three
separate tensors of one shape, so every op is one elementwise tensor op and
the plain path tracer below reads op for op like the JAX one it is tested
against.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Vec3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # -- construction ----------------------------------------------------
    @staticmethod
    def full(shape, vals, device=None, dtype=torch.float32) -> "Vec3":
        return Vec3(torch.full(shape, vals[0], dtype=dtype, device=device),
                    torch.full(shape, vals[1], dtype=dtype, device=device),
                    torch.full(shape, vals[2], dtype=dtype, device=device))

    @staticmethod
    def zeros(shape, device=None, dtype=torch.float32) -> "Vec3":
        z = torch.zeros(shape, dtype=dtype, device=device)
        return Vec3(z, z, z)

    def to_array(self) -> torch.Tensor:
        return torch.stack([self.x, self.y, self.z], dim=-1)

    # -- arithmetic ------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)


def dot(a: Vec3, b: Vec3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(a.y * b.z - a.z * b.y,
                a.z * b.x - a.x * b.z,
                a.x * b.y - a.y * b.x)


def length2(a: Vec3):
    return dot(a, a)


def normalize(a: Vec3, eps: float = 1e-20) -> Vec3:
    # 1 / sqrt, both correctly rounded, as XLA computes rsqrt on the CPU and
    # the CUDA megakernel does; torch.rsqrt on CUDA is a 2-ulp approximation
    inv = 1.0 / torch.sqrt(torch.clamp_min(length2(a), eps))
    return a * inv


def where(mask, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(torch.where(mask, a.x, b.x),
                torch.where(mask, a.y, b.y),
                torch.where(mask, a.z, b.z))


def max_elem(a: Vec3):
    return torch.maximum(torch.maximum(a.x, a.y), a.z)


def reflect(wi: Vec3, n: Vec3) -> Vec3:
    """-wi + 2 dot(wi, n) n (scene.h:435)."""
    return -wi + n * (2.0 * dot(wi, n))
