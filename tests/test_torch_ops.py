"""Device-layer ops of the port against the JAX package, op for op.

The same inputs, made with numpy from a fixed seed, go through the JAX
function and its torch counterpart.  Tolerance rtol = atol = 1e-6 on
float32: the arithmetic is the same op sequence, so only transcendental
ulps (cos, sin, pow, arccos, atan2) differ.  Masks must be exactly equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pathtracer_cuda_interactive_tpu.models.device_scene import (
    DeviceScene as JaxDeviceScene)
from pathtracer_cuda_interactive_tpu.models.scenepack import (
    load_scene as jax_load_scene)
from pathtracer_cuda_interactive_tpu.ops import brdf as jbrdf
from pathtracer_cuda_interactive_tpu.ops import camera as jcamera
from pathtracer_cuda_interactive_tpu.ops import geometry as jg
from pathtracer_cuda_interactive_tpu.ops import shade as jshade
from pathtracer_cuda_interactive_tpu.ops.vec import Vec3 as JVec3
from pathtracer_cuda_interactive_tpu_torch import SCENES_DIR
from pathtracer_cuda_interactive_tpu_torch.models.device_scene import (
    DeviceScene)
from pathtracer_cuda_interactive_tpu_torch.models.scenepack import (
    MAT_DIFFUSE, MAT_MIRROR, MAT_PHONG, MAT_PLASTIC, load_scene)
from pathtracer_cuda_interactive_tpu_torch.ops import brdf, camera, shade
from pathtracer_cuda_interactive_tpu_torch.ops import geometry as g
from pathtracer_cuda_interactive_tpu_torch.ops.vec import Vec3

TOL = dict(rtol=1e-6, atol=1e-6)
N = 4096


def _pair(a):
    """numpy [..., 3] -> (JAX Vec3, torch Vec3)."""
    a = np.asarray(a, np.float32)
    return (JVec3(*(jnp.asarray(a[..., k]) for k in range(3))),
            Vec3(*(torch.from_numpy(a[..., k].copy()) for k in range(3))))


def _scalar_pair(a, dtype=np.float32):
    a = np.asarray(a, dtype)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _close(ref, got):
    """Compare a JAX result with a torch one: Vec3s componentwise, bool
    masks exactly, floats to TOL."""
    if isinstance(got, Vec3):
        for r, t in zip(ref, got):
            _close(r, t)
        return
    ref = np.asarray(ref)
    got = got.numpy()
    if ref.dtype == bool:
        np.testing.assert_array_equal(ref, got)
    else:
        np.testing.assert_allclose(got, ref, **TOL)


def _unit(rv, n):
    d = rv.normal(size=(n, 3))
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_intersect_sphere_hits_misses_and_degenerate():
    rv = np.random.default_rng(0)
    center = rv.uniform(-1, 1, (N, 3))
    radius = rv.uniform(0.2, 1.5, N)
    org = rv.uniform(-3, 3, (N, 3))
    # aim at points near the sphere: about half the rays hit, some graze;
    # some origins lie inside the sphere, where only the far root counts
    aim = center + _unit(rv, N) * radius[:, None] * rv.uniform(0, 2, (N, 1))
    dirn = aim - org
    dirn /= np.linalg.norm(dirn, axis=-1, keepdims=True)
    dirn[:64] = 0.0                        # a == 0: the linear branch
    dirn[64:128] *= 0.25                   # non-unit directions
    tnear = np.where(np.arange(N) % 2 == 0, 0.0, 1e-4).astype(np.float32)
    jo, to = _pair(org)
    jd, td = _pair(dirn)
    jc, tc = _pair(center)
    jr, tr = _scalar_pair(radius)
    jn, tn = _scalar_pair(tnear)
    t_ref, hit_ref = jg.intersect_sphere(jc, jr, jo, jd, jn, jnp.inf)
    t, hit = g.intersect_sphere(tc, tr, to, td, tn, float("inf"))
    _close(hit_ref, hit)
    h = np.asarray(hit_ref)
    np.testing.assert_allclose(t.numpy()[h], np.asarray(t_ref)[h], **TOL)
    assert 0.2 < h.mean() < 0.8            # both hits and misses
    assert not h[:64].any()                # a == 0 never hits
    # a finite tfar cuts hits beyond it
    t2_ref, hit2_ref = jg.intersect_sphere(jc, jr, jo, jd, jn, 1.0)
    t2, hit2 = g.intersect_sphere(tc, tr, to, td, tn, 1.0)
    _close(hit2_ref, hit2)


def test_intersect_triangle_hits_edges_and_parallel():
    rv = np.random.default_rng(1)
    p0 = rv.uniform(-1, 1, (N, 3))
    e1 = rv.uniform(-1, 1, (N, 3))
    e2 = rv.uniform(-1, 1, (N, 3))
    # aim at barycentric targets; a quarter sit exactly on an edge or corner
    uv = rv.uniform(0, 1, (N, 2))
    uv[: N // 8, 0] = 0.0
    uv[N // 8: N // 4, 0] = 1.0 - uv[N // 8: N // 4, 1]
    uv[N // 4: N // 4 + 32] = 0.0
    target = p0 + e1 * uv[:, :1] + e2 * uv[:, 1:]
    org = target + _unit(rv, N) * rv.uniform(0.5, 3, (N, 1))
    dirn = target - org
    dirn /= np.linalg.norm(dirn, axis=-1, keepdims=True)
    # rays parallel to the triangle plane: divisor == 0
    par = slice(N - 64, N)
    e1[par] = [1.0, 0.0, 0.0]
    e2[par] = [0.0, 1.0, 0.0]
    dirn[par] = [0.6, 0.8, 0.0]
    jp, tp = _pair(p0)
    je1, te1 = _pair(e1)
    je2, te2 = _pair(e2)
    jo, to = _pair(org)
    jd, td = _pair(dirn)
    ref = jg.intersect_triangle(jp, je1, je2, jo, jd, 0.0, jnp.inf)
    got = g.intersect_triangle(tp, te1, te2, to, td, 0.0, float("inf"))
    hit = np.asarray(ref[3])
    _close(ref[3], got[3])
    for r, t in zip(ref[:3], got[:3]):
        np.testing.assert_allclose(t.numpy()[hit], np.asarray(r)[hit], **TOL)
    assert 0.3 < hit.mean() < 1.0
    assert not hit[par].any()


def test_make_frame_is_orthonormal_and_matches():
    n = _unit(np.random.default_rng(2), N)
    n[:8] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 1, 0],
             [0, 0, -0.999999], [0.6, 0, -0.8], [0, -1, 0], [-1, 0, 0]]
    jn, tn = _pair(n)
    jx, jy = jg.make_frame(jn)
    x, y = g.make_frame(tn)
    _close(jx, x)
    _close(jy, y)
    xs = np.stack([c.numpy() for c in x], -1)
    ys = np.stack([c.numpy() for c in y], -1)
    np.testing.assert_allclose((xs * ys).sum(-1), 0.0, atol=2e-5)
    np.testing.assert_allclose((xs * n).sum(-1), 0.0, atol=2e-5)


def test_hemisphere_samplers_and_schlick():
    rv = np.random.default_rng(3)
    ju1, tu1 = _scalar_pair(rv.uniform(0, 1, N))
    ju2, tu2 = _scalar_pair(rv.uniform(0, 1, N))
    _close(jg.sample_cos_hemisphere(ju1, ju2), g.sample_cos_hemisphere(tu1, tu2))
    je, te = _scalar_pair(rv.uniform(1, 200, N))
    _close(jg.sample_cos_n_hemisphere(ju1, ju2, je),
           g.sample_cos_n_hemisphere(tu1, tu2, te))
    jf, tf = _pair(rv.uniform(0, 1, (N, 3)))
    jc, tc = _scalar_pair(rv.uniform(-1.2, 1.2, N))
    _close(jg.schlick_fresnel(jf, jc), g.schlick_fresnel(tf, tc))


def _material(mtype, rv):
    color = rv.uniform(0, 1, (N, 3))
    param = (rv.uniform(1.2, 2.0, N) if mtype == MAT_PLASTIC
             else rv.uniform(1, 100, N))
    jt, tt = _scalar_pair(np.full(N, mtype), np.int32)
    jc, tc = _pair(color)
    jp, tp = _scalar_pair(param)
    return jbrdf.MatLookup(jt, jc, jp), brdf.MatLookup(tt, tc, tp)


@pytest.mark.parametrize("mtype", [MAT_DIFFUSE, MAT_MIRROR, MAT_PLASTIC,
                                   MAT_PHONG])
def test_sample_and_eval_brdf(mtype):
    rv = np.random.default_rng(10 + mtype)
    jmat, tmat = _material(mtype, rv)
    n = _unit(rv, N)
    wi = _unit(rv, N)
    wi *= np.sign((wi * n).sum(-1, keepdims=True))   # viewer side
    jn, tn = _pair(n)
    jwi, twi = _pair(wi)
    us = [_scalar_pair(rv.uniform(0, 1, N)) for _ in range(3)]
    ref = jbrdf.sample_brdf_from_uniforms(jmat, jn, jwi, *(u[0] for u in us))
    got = brdf.sample_brdf_from_uniforms(tmat, tn, twi, *(u[1] for u in us))
    _close(ref[1], got[1])                 # is_pure_specular
    _close(ref[0], got[0])                 # wo
    _close(ref[2], got[2])                 # weight
    jwo, two = _pair(np.stack([np.asarray(c) for c in ref[0]], -1))
    ev_ref = jbrdf.eval_brdf(jmat, jn, jwi, jwo)
    ev = brdf.eval_brdf(tmat, tn, twi, two)
    _close(ev_ref.value, ev.value)
    np.testing.assert_allclose(ev.pdf.numpy(), np.asarray(ev_ref.pdf), **TOL)


def test_camera_ray_data_and_primary_rays():
    jcam = jcamera.Camera((0.0, 1.0, 1.9), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0),
                          60.0)
    cam = camera.Camera(jcam.lookfrom, jcam.lookat, jcam.up, jcam.vfov)
    ref_cd = jcamera.camera_ray_data(jcam, 64, 48)
    cd = camera.camera_ray_data(cam, 64, 48)
    np.testing.assert_array_equal(cd, ref_cd)
    rv = np.random.default_rng(4)
    ju, tu = _scalar_pair(rv.uniform(0, 1, N))
    jv, tv = _scalar_pair(rv.uniform(0, 1, N))
    jo, jd = jcamera.generate_primary_rays(jnp.asarray(ref_cd), ju, jv)
    o, d = camera.generate_primary_rays(torch.from_numpy(cd), tu, tv)
    _close(jo, o)
    _close(jd, d)
    assert cam.almost_equal(camera.Camera((0.0, 1.0, 1.9 + 5e-6),
                                          cam.lookat, cam.up, cam.vfov))
    assert not cam.almost_equal(camera.Camera((0.0, 1.0, 1.9 + 5e-5),
                                              cam.lookat, cam.up, cam.vfov))


@pytest.mark.parametrize("scene", ["spheres", "cbox_rect", "pointlight"])
def test_shade_setup(scene):
    path = str(SCENES_DIR / f"{scene}.xml")
    jscene = JaxDeviceScene.from_pack(jax_load_scene(path)[0])
    tscene = DeviceScene.from_pack(load_scene(path)[0])
    rv = np.random.default_rng(5)
    prim = rv.integers(-1, tscene.num_prims, N).astype(np.int32)
    org = rv.uniform(-1, 1, (N, 3)) + [0.0, 1.0, 3.0]
    dirn = _unit(rv, N)
    jo, to = _pair(org)
    jd, td = _pair(dirn)
    jp, tp = _scalar_pair(prim, np.int32)
    ref = jshade.shade_setup(jscene, jp, jo, jd, 1e-4)
    got = shade.shade_setup(tscene, tp, to, td, 1e-4)
    for name in ref._fields:
        r, t = getattr(ref, name), getattr(got, name)
        if name == "material_id":
            np.testing.assert_array_equal(np.asarray(r), t.numpy())
        elif name == "v":
            # sphere v = arccos(n.y)/pi, which near a pole turns one ulp of
            # n.y into 1e-6 and more; compare the well-conditioned cos(pi v)
            np.testing.assert_allclose(np.cos(np.pi * t.numpy()),
                                       np.cos(np.pi * np.asarray(r)), **TOL)
        else:
            _close(r, t)
