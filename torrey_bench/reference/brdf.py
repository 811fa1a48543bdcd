"""BRDF sampling and evaluation (diffuse / mirror / plastic / Phong), SoA.

Frozen from the PyTorch port's ``ops/brdf.py``, itself the
equivalent of the reference's tagged-union dispatch (eval_brdf
scene.h:364-412, sample_brdf scene.h:422-464).  All four lobes are
evaluated over the whole ray batch and selected with masks; the CUDA
megakernel branches per thread on the material type and computes the same
lobe with the same arithmetic.

Conventions exactly match the reference:
  * ``wi`` points toward the viewer (= -ray.dir); ``n`` is the shading
    normal already flipped toward the ray (radiance.cuh:45-47).
  * mirror and the plastic specular lobe are "pure specular": sampler
    returns a weight, eval returns 0 (scene.h:377-379, 434-447).
  * plastic F0 = ((eta-1)/(eta+1))^2, lobe-selected with prob F
    (scene.h:439-453).
  * Phong samples cos^n around the reflection of ``wi`` (scene.h:455-460).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .device_scene import DeviceScene
from .scenepack import (MAT_DIFFUSE, MAT_MIRROR, MAT_PHONG,
                                MAT_PLASTIC)
from . import geometry as g
from . import rng
from .vec import Vec3, dot, reflect, where

_INV_PI = 1.0 / math.pi


class MatLookup(NamedTuple):
    mtype: torch.Tensor   # i32 material type code
    color: Vec3           # reflectance
    param: torch.Tensor   # eta or exponent


def lookup_materials(scene: DeviceScene, material_id) -> MatLookup:
    mid = torch.clamp(material_id, 0, scene.mat_type.shape[0] - 1).long()
    return MatLookup(
        mtype=scene.mat_type[mid],
        color=Vec3(scene.mat_r[mid], scene.mat_g[mid], scene.mat_b[mid]),
        param=scene.mat_param[mid],
    )


class SampleRecord(NamedTuple):
    wo: Vec3
    is_pure_specular: torch.Tensor
    weight: Vec3          # valid when pure specular
    state: torch.Tensor   # advanced RNG state


def _plastic_f0(eta):
    r = (eta - 1.0) / (eta + 1.0)
    return r * r


def sample_brdf(mat: MatLookup, n: Vec3, wi: Vec3,
                state: torch.Tensor) -> SampleRecord:
    """Reference: sample_brdf (scene.h:422-464).  Consumes a fixed 3 draws
    per ray regardless of material."""
    state, u1, u2 = rng.next_uniform2(state)
    state, u3 = rng.next_uniform(state)
    wo, is_spec, weight = sample_brdf_from_uniforms(mat, n, wi, u1, u2, u3)
    return SampleRecord(wo, is_spec, weight, state)


def sample_brdf_from_uniforms(mat: MatLookup, n: Vec3, wi: Vec3, u1, u2, u3):
    """Lobe selection on pre-drawn uniforms.
    Returns (wo, is_pure_specular, weight)."""
    fx, fy = g.make_frame(n)
    refl = reflect(wi, n)

    wo_diff = g.frame_to_world(fx, fy, n, g.sample_cos_hemisphere(u1, u2))

    f_mirror = g.schlick_fresnel(mat.color, dot(n, refl))

    f0 = _plastic_f0(mat.param)
    f_plastic = g.schlick_fresnel(Vec3(f0, f0, f0), dot(n, wi))
    plastic_spec = u3 <= f_plastic.x

    rx, ry = g.make_frame(refl)
    wo_phong = g.frame_to_world(
        rx, ry, refl, g.sample_cos_n_hemisphere(u1, u2, mat.param))

    t = mat.mtype
    wo = where(t == MAT_MIRROR, refl, wo_diff)
    wo = where((t == MAT_PLASTIC) & plastic_spec, refl, wo)
    wo = where(t == MAT_PHONG, wo_phong, wo)

    is_spec = (t == MAT_MIRROR) | ((t == MAT_PLASTIC) & plastic_spec)
    one = torch.ones_like(u1)
    weight = where(t == MAT_MIRROR, f_mirror, Vec3(one, one, one))
    return wo, is_spec, weight


class EvalRecord(NamedTuple):
    value: Vec3
    pdf: torch.Tensor


def eval_brdf(mat: MatLookup, n: Vec3, wi: Vec3, wo: Vec3) -> EvalRecord:
    """Reference: eval_brdf (scene.h:364-412).  Mirror (and the plastic
    specular lobe) return 0 — handled by the sampler's weight."""
    n_dot_wo = torch.clamp_min(dot(wo, n), 0.0)
    cos_term = n_dot_wo * _INV_PI

    # diffuse
    val_diff = mat.color * cos_term
    pdf_diff = cos_term

    # plastic diffuse lobe
    f0 = _plastic_f0(mat.param)
    f = g.schlick_fresnel(Vec3(f0, f0, f0), dot(n, wi))
    val_plastic = (Vec3(1.0 - f.x, 1.0 - f.y, 1.0 - f.z)
                   * mat.color * cos_term)
    pdf_plastic = (1.0 - f.x) * cos_term

    # phong
    refl = reflect(wi, n)
    r_dot_wo = dot(refl, wo)
    lobe_ok = (r_dot_wo > 0.0) & (dot(n, wo) > 0.0)
    norm = (mat.param + 1.0) * (0.5 / math.pi)
    phong_resp = norm * torch.pow(torch.clamp_min(r_dot_wo, 1e-30), mat.param)
    phong_resp = torch.where(lobe_ok, phong_resp, 0.0)
    val_phong = mat.color * phong_resp
    pdf_phong = phong_resp

    t = mat.mtype
    zero = Vec3.zeros(n_dot_wo.shape, device=n_dot_wo.device)
    value = where(t == MAT_DIFFUSE, val_diff, zero)
    value = where(t == MAT_PLASTIC, val_plastic, value)
    value = where(t == MAT_PHONG, val_phong, value)
    pdf = torch.where(t == MAT_DIFFUSE, pdf_diff, 0.0)
    pdf = torch.where(t == MAT_PLASTIC, pdf_plastic, pdf)
    pdf = torch.where(t == MAT_PHONG, pdf_phong, pdf)
    return EvalRecord(value, pdf)
