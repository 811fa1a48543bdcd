"""The wavefront's bounce step: the ray table and the device code around each
wave's trace.

The JAX package runs its whole wave loop as one jit program
(``pathtracer_cuda_interactive_tpu/ops/wavefront.py::_render_wavefront``),
and XLA fuses what surrounds the Pallas trace into a few device kernels.  In
the port that code is three hand-written kernels (csrc/wave_step.cu), each
with its plain torch version here:

* W1 ``wave_record`` — the 16-channel hit record of a wave from the trace's
  (t, slot): the winner's 32-float record, the Moller-Trumbore re-solve of
  (u, v), the resident spheres folded in (plain: ``record_plain``, i.e.
  ``_record_from_slots``);
* W2 ``wave_shade`` — with point lights the light term of the shadow waves'
  t (``_nee_term``, ``_sphere_tmin``), then one bounce of shading, BSDF
  sampling and Russian roulette (``_shade``) for every ray of the table,
  into a new table (the wave's own rows stay as its trace saw them), and
  the radiance of every ray whose path ended written to its (sample,
  pixel) (plain: ``shade_plain``).  Its first half,
  ``wave_shadow_rays``, gives the shadow rays' directions from the record
  before the shadow waves are traced (plain: ``shadow_rays_plain``);
* W3 ``wave_sort_key`` — the int32 coherence key of the next wave, with
  INT32_MAX for a ray that is no longer live (``_sort_key``, ``_sig_key``;
  plain: ``sort_key_plain``).

The ray table is float32 [16, N], one contiguous row a column: origin (rows
0-2), direction (3-5), throughput (6-8), radiance (9-11), the PCG state,
pixel and sample as int32 bits (12-14) and the live flag, 1 or 0 (15).  One
``index_select`` along the ray axis permutes or compacts every column at
once, and each row stays a contiguous [N] tensor, as the trace kernels take
them.

Each wrapper dispatches on the device of its tensors: CUDA tensors launch
the kernel and never fall back, CPU tensors run the plain version.
``STEPS`` holds the wrappers and ``PLAIN_STEPS`` the plain versions, which
the chip smoke runs on the card to hold the kernels to them.

The wave loop's counted schedule (ops/wavefront.py::_ChunkWaves) keeps a
chunk's rays in one table of fixed capacity and its counts in an int64
control block on the card (``new_control``: the live rays at the head of
the wave's table, ``COUNT``; the next wave's live count being summed,
``NEXT``; the columns the last wave wrote, ``VALID``; the depth; the waves
and rays traced; ``CURSOR`` and ``LEVELS`` for the drain).
``record_counted``, ``shade_counted`` and ``key_counted`` are W1-W3 over
the table's first ``COUNT`` columns, read on the card, and ``tally`` moves
the counts on from one wave to the next, so that no wave needs a host read.
Once the live count is small, ``drain_counted`` carries every live path of
the carried table to its end at once: the kernel ``wave_drain`` on a card,
each level B2's walk and W1's and W2's per-ray code, or its plain version
``drain_plain``, the same trace, record and shade level by level over the
live columns, unsorted.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import torch

from ..models.bricks import BRICK_ROWS, STACK_DEPTH, BrickSet
from . import brdf, cuda_build, rng
from .brickkernel import (slot_rows, trace_bricks_plain, triangle_record,
                          walk_pointers)
from .geometry import intersect_sphere
from .integrator import SECONDARY_TNEAR
from .vec import Vec3, cross, dot, max_elem, normalize, where

INF = float("inf")
INT32_MAX = 2 ** 31 - 1
SORT_MODES = ("sig_mort", "mort_oct", "none")

# rows of the ray table
ORG, DIR, THROUGHPUT, RADIANCE = 0, 3, 6, 9
STATE, PIX, SAMP, LIVE = 12, 13, 14, 15
TABLE_ROWS = 16

# slots of the counted schedule's control block (csrc/wave_step.cu); the
# drain's: the next column no lane has taken, the most levels a path ran
COUNT, NEXT, VALID, DEPTH, WAVES, RAYS, CURSOR, LEVELS = range(8)
CONTROL_SLOTS = 8

SOURCE = cuda_build.CSRC_DIR / "wave_step.cu"
BUILD_DIR = cuda_build.BUILD_DIR

_lib = None


# -- the ray table ------------------------------------------------------------

def make_table(org: Vec3, dirn: Vec3, state, pix, samp) -> torch.Tensor:
    """A fresh ray table of N live rays: origins and directions as given,
    throughput 1, radiance 0, int32 states, pixels and samples [N]."""
    n = int(state.numel())
    table = torch.zeros((TABLE_ROWS, n), dtype=torch.float32,
                        device=state.device)
    table[ORG:ORG + 3] = torch.stack(tuple(org))
    table[DIR:DIR + 3] = torch.stack(tuple(dirn))
    table[THROUGHPUT:THROUGHPUT + 3] = 1.0
    int_rows(table).copy_(torch.stack((state, pix, samp)))
    table[LIVE] = 1.0
    return table


def int_rows(table: torch.Tensor) -> torch.Tensor:
    """The table's state, pixel and sample rows as an int32 [3, N] view."""
    return table[STATE:SAMP + 1].view(torch.int32)


def rows3(table: torch.Tensor, row: int) -> Vec3:
    """Rows row .. row + 2 of the table as a Vec3 of [N] views."""
    return Vec3(table[row], table[row + 1], table[row + 2])


# -- sort keys (plain versions of W3) -----------------------------------------

def _spread3(x):
    """Interleave the low 10 bits of int32 x with two zero bits each."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _octant(dirn: Vec3):
    i32 = torch.int32
    return ((dirn.x > 0).to(i32) * 4 + (dirn.y > 0).to(i32) * 2
            + (dirn.z > 0).to(i32))


def _morton(org: Vec3, lo, inv_extent, top: float):
    def q(c, l, s):
        return torch.clamp((c - l) * s * top, 0.0, top).to(torch.int32)

    mx = _spread3(q(org.x, lo[0], inv_extent[0]))
    my = _spread3(q(org.y, lo[1], inv_extent[1]))
    mz = _spread3(q(org.z, lo[2], inv_extent[2]))
    return (mx << 2) | (my << 1) | mz


def _dead_to_tail(key, active):
    """INT32_MAX where ``active`` is False (None: every ray live), so that
    ended rays sink to the tail of the sort."""
    if active is None:
        return key
    return torch.where(active, key, INT32_MAX)


def _sort_key(org: Vec3, dirn: Vec3, lo, inv_extent, active=None):
    """"mort_oct": 21-bit Morton code of the origin (scene-box normalized)
    above the direction octant; INT32_MAX where ``active`` is False."""
    key = (_morton(org, lo, inv_extent, 127.0) << 3) | _octant(dirn)
    return _dead_to_tail(key, active)


def _sig_key(org: Vec3, dirn: Vec3, lo, inv_extent, coarse, active=None):
    """"sig_mort": the high K = len(coarse) bits say which coarse scene
    regions (models/bricks.py::_coarse_cut) the ray's forward line can
    touch, the low 3 * mb bits (mb = min(7, (30 - K) // 3)) are the origin
    Morton code; INT32_MAX where ``active`` is False."""
    inv = Vec3(1.0 / dirn.x, 1.0 / dirn.y, 1.0 / dirn.z)
    col = lambda v: v.reshape(-1)[:, None]
    o = Vec3(col(org.x), col(org.y), col(org.z))
    iv = Vec3(col(inv.x), col(inv.y), col(inv.z))
    # all K boxes at once, [N, K]; same elementwise arithmetic as the JAX
    # per-box loop
    tx0 = (coarse[:, 0] - o.x) * iv.x
    tx1 = (coarse[:, 3] - o.x) * iv.x
    ty0 = (coarse[:, 1] - o.y) * iv.y
    ty1 = (coarse[:, 4] - o.y) * iv.y
    tz0 = (coarse[:, 2] - o.z) * iv.z
    tz1 = (coarse[:, 5] - o.z) * iv.z
    tn = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                     torch.minimum(ty0, ty1)),
                       torch.minimum(tz0, tz1))
    tf = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                     torch.maximum(ty0, ty1)),
                       torch.maximum(tz0, tz1))
    hit = (tf >= torch.maximum(tn, torch.zeros_like(tn))) & (coarse[:, 6] > 0.0)
    K = int(coarse.shape[0])
    bits = torch.tensor([1 << k for k in range(K)], dtype=torch.int32,
                        device=tn.device)
    sig = (hit.to(torch.int32) * bits).sum(dim=1, dtype=torch.int32)
    sig = sig.reshape(org.x.shape)

    # Morton bits shrink as the signature widens so the key stays in int32
    mb = min(7, (30 - K) // 3)
    key = (sig << (3 * mb)) | _morton(org, lo, inv_extent, float(2 ** mb - 1))
    return _dead_to_tail(key, active)


def sort_key_plain(table: torch.Tensor, mode: str, lo, inv_extent,
                   coarse=None) -> torch.Tensor:
    """W3's plain version: the int32 [N] key of the table's rays by
    ``mode`` (``SORT_MODES``; "none" keys every live ray 0, so a stable sort
    keeps their order), INT32_MAX for a ray that is not live."""
    org, dirn = rows3(table, ORG), rows3(table, DIR)
    active = table[LIVE] > 0.0
    if mode == "sig_mort":
        return _sig_key(org, dirn, lo, inv_extent, coarse, active)
    if mode == "mort_oct":
        return _sort_key(org, dirn, lo, inv_extent, active)
    return _dead_to_tail(torch.zeros_like(org.x, dtype=torch.int32), active)


# -- the record (plain version of W1) -----------------------------------------

def _sphere_tmin(sph_rows, S: int, org: Vec3, dirn: Vec3, tnear: float, t):
    """Fold the resident sphere table into a best t (shadow rays)."""
    for j in range(S):
        c = Vec3(sph_rows[j, 1], sph_rows[j, 2], sph_rows[j, 3])
        ts, hit = intersect_sphere(c, sph_rows[j, 4], org, dirn, tnear, t)
        t = torch.where(hit & (ts < t), ts, t)
    return t


def _solve_uv(rows, org: Vec3, dirn: Vec3):
    """Barycentric (u, v) of each ray on the triangle of its 32-float record
    ``rows`` [m, 32]: one Moller-Trumbore solve (0 / 1 where the ray is
    parallel to the triangle)."""
    gv = lambda j: Vec3(rows[:, j], rows[:, j + 1], rows[:, j + 2])
    p0, e1, e2 = gv(1), gv(4), gv(7)
    pv = cross(dirn, e2)
    det = dot(e1, pv)
    det_s = torch.where(det == 0.0, 1.0, det)
    tvec = org - p0
    u = dot(tvec, pv) / det_s
    qv = cross(tvec, e1)
    v = dot(dirn, qv) / det_s
    return u, v


def _record_from_rows(rows, u, v, t, slot, sph, S: int, org: Vec3,
                      dirn: Vec3, tnear: float):
    """The 16-channel hit record of a wave from each ray's winning triangle
    (its record ``rows`` [m, 32], barycentrics, t and slot, -1 = miss), with
    the ``S`` resident spheres of table ``sph`` folded in after the
    triangles by a strict ``ts < t``, so a triangle wins an equal-t tie.
    Every ray of the table is live, so there is no active mask."""
    ns, pos, mt, alb, mp, em, emit = triangle_record(rows, u, v)
    t = torch.where(slot >= 0, t, INF)

    for j in range(S):
        c = Vec3(sph[j, 1], sph[j, 2], sph[j, 3])
        ts, hit = intersect_sphere(c, sph[j, 4], org, dirn, tnear, t)
        closer = hit & (ts < t)
        spos = Vec3(org.x + dirn.x * ts, org.y + dirn.y * ts,
                    org.z + dirn.z * ts)
        sns = Vec3(spos.x - c.x, spos.y - c.y, spos.z - c.z)
        t = torch.where(closer, ts, t)
        pos = where(closer, spos, pos)
        ns = where(closer, sns, ns)
        mt = torch.where(closer, sph[j, 19], mt)
        mp = torch.where(closer, sph[j, 23], mp)
        alb = where(closer, Vec3(sph[j, 20], sph[j, 21], sph[j, 22]), alb)
        em = where(closer, Vec3(sph[j, 24], sph[j, 25], sph[j, 26]), em)
        emit = torch.where(closer, sph[j, 27], emit)
    return (t, ns.x, ns.y, ns.z, pos.x, pos.y, pos.z, mt,
            alb.x, alb.y, alb.z, mp, em.x, em.y, em.z, emit)


def _record_from_slots(bricks: BrickSet, t, slot, org: Vec3, dirn: Vec3,
                       tnear: float):
    """The 16-channel hit record of the JAX package's full trace kernel from
    B2's (t, slot): one 32-float gather per ray of the winning triangle's
    record, a Moller-Trumbore re-solve for (u, v), then the resident
    spheres."""
    rows = slot_rows(bricks, slot)
    u, v = _solve_uv(rows, org, dirn)
    return _record_from_rows(rows, u, v, t, slot, bricks.sph_rows,
                             bricks.num_spheres, org, dirn, tnear)


def record_plain(bricks: BrickSet, t, slot, org: Vec3, dirn: Vec3,
                 tnear: float) -> torch.Tensor:
    """W1's plain version: ``_record_from_slots`` as one [16, N] tensor."""
    return torch.stack(_record_from_slots(bricks, t, slot, org, dirn, tnear))


# -- the bounce (plain versions of W2) ----------------------------------------

def _material(rec) -> brdf.MatLookup:
    mt, ar, ag, ab, mp = rec[7], rec[8], rec[9], rec[10], rec[11]
    return brdf.MatLookup(mtype=mt.to(torch.int32), color=Vec3(ar, ag, ab),
                          param=mp)


def _light_dir(light, pos: Vec3):
    """(wo, dist2, dist): the unit direction from ``pos`` to the light of row
    ``light`` (position, intensity), its squared distance and distance."""
    d = Vec3(light[0] - pos.x, light[1] - pos.y, light[2] - pos.z)
    dist2 = dot(d, d)
    dist = torch.sqrt(dist2)
    return d * (1.0 / torch.clamp_min(dist, 1e-20)), dist2, dist


def shadow_rays_plain(rec: torch.Tensor, light_rows) -> torch.Tensor:
    """The plain version of W2's first half: per light the direction of each
    ray's shadow ray from its hit position in ``rec`` [16, N], a float32
    [L, 3, N] tensor."""
    pos = Vec3(rec[4], rec[5], rec[6])
    return torch.stack([torch.stack(tuple(_light_dir(light_rows[l], pos)[0]))
                        for l in range(int(light_rows.shape[0]))])


def _nee_term(rec, dirn: Vec3, T: Vec3, light_rows, shadow_t, sph_rows,
              S: int) -> Vec3:
    """Point-light next-event estimation for one wave: the direct light to
    add at each hit (ops/integrator.py::_direct_point_lights semantics; no
    RNG draws).  ``shadow_t`` [L, N] is the closest triangle hit of each
    ray's shadow ray toward light l (inf where none was traced); the ``S``
    resident spheres of ``sph_rows`` are folded into it here."""
    t, nsx, nsy, nsz, px, py, pz = rec[:7]
    zero = Vec3.zeros(t.shape, device=t.device)
    hit = t < INF
    ns = normalize(Vec3(nsx, nsy, nsz))
    wi = -dirn
    cos_view = dot(wi, ns)
    n = where(cos_view < 0.0, -ns, ns)
    mat = _material(rec)
    pos = Vec3(px, py, pz)
    out = zero
    for l in range(int(light_rows.shape[0])):
        wo, dist2, dist = _light_dir(light_rows[l], pos)
        ev_value, _ = brdf.eval_brdf(mat, n, wi, wo)
        ts = _sphere_tmin(sph_rows, S, pos, wo, SECONDARY_TNEAR, shadow_t[l])
        occ = ts < dist * (1.0 - 1e-3)
        inten = Vec3(light_rows[l, 3], light_rows[l, 4], light_rows[l, 5])
        contrib = T * ev_value * inten * (1.0 / torch.clamp_min(dist2, 1e-20))
        out = out + where(hit & ~occ, contrib, zero)
    return out


def _shade(rec, org: Vec3, dirn: Vec3, T: Vec3, L: Vec3, state, depth: int,
           bg: Vec3, rr_start_depth: int, max_depth: int):
    """One bounce of the radiance.cuh:21-79 state machine for every ray of
    the table, given its hit record.  Returns (org, dirn, T, L, active,
    state); ``active`` False marks rays whose path ended."""
    (t, nsx, nsy, nsz, px, py, pz, _mt, _ar, _ag, _ab, _mp,
     er, eg, eb, em) = rec
    zero = Vec3.zeros(t.shape, device=t.device)
    miss = t == INF
    L = L + where(miss, T * bg, zero)
    active = ~miss

    ns = normalize(Vec3(nsx, nsy, nsz))
    wi = -dirn
    cos_view = dot(wi, ns)

    front_emit = active & (em > 0.0) & (cos_view > 0.0)
    L = L + where(front_emit, T * Vec3(er, eg, eb), zero)

    n = where(cos_view < 0.0, -ns, ns)

    state, u1 = rng.next_uniform(state)
    state, u2 = rng.next_uniform(state)
    state, u3 = rng.next_uniform(state)
    mat = _material(rec)
    wo, is_spec, weight = brdf.sample_brdf_from_uniforms(mat, n, wi,
                                                         u1, u2, u3)
    ev_value, ev_pdf = brdf.eval_brdf(mat, n, wi, wo)

    ok_spec = max_elem(weight) > 0.0
    ok_scatter = (max_elem(ev_value) > 0.0) & (ev_pdf > 0.0)
    pdf_safe = torch.where(ev_pdf > 0.0, ev_pdf, 1.0)
    contrib = where(is_spec, weight, ev_value * (1.0 / pdf_safe))
    ok = torch.where(is_spec, ok_spec, ok_scatter)

    T = where(active & ok, T * contrib, T)
    active = active & ok

    org = where(active, Vec3(px, py, pz), org)
    dirn = where(active, wo, dirn)

    state, ru = rng.next_uniform(state)
    if depth > rr_start_depth:
        p = torch.clamp_min(1.0 - max_elem(T), 0.5)
        kill = ru < p
        scale = 1.0 / torch.where(~kill & (p < 1.0), 1.0 - p, 1.0)
        T = where(active & ~kill, T * scale, T)
        active = active & ~kill

    if depth + 1 >= max_depth:
        active = torch.zeros_like(active)
    return org, dirn, T, L, active, state


def shade_plain(table: torch.Tensor, rec: torch.Tensor, depth: int, bg,
                rr_start_depth: int, max_depth: int, out: torch.Tensor,
                light_rows=None, shadow_t=None, sph_rows=None,
                num_spheres: int = 0) -> torch.Tensor:
    """W2's plain version: with ``light_rows`` [L, 6] the light term of the
    shadow waves' ``shadow_t`` [L, N] (``_nee_term``), then ``_shade`` at
    ``depth`` over the table's rays and their record ``rec`` [16, N] (``bg``
    the background, [3]).  Returns the new ray table (rays, states and live
    flags after the bounce) and writes the radiance of every ray whose path
    ended into ``out`` [num_samples, pixels, 3] at its (sample, pixel)."""
    org, dirn = rows3(table, ORG), rows3(table, DIR)
    T, L = rows3(table, THROUGHPUT), rows3(table, RADIANCE)
    state, pix, samp = int_rows(table)
    rec = tuple(rec.unbind(0))
    if light_rows is not None:
        L = L + _nee_term(rec, dirn, T, light_rows, shadow_t, sph_rows,
                          num_spheres)
    org, dirn, T, L, active, state = _shade(
        rec, org, dirn, T, L, state, depth, Vec3(bg[0], bg[1], bg[2]),
        rr_start_depth, max_depth)
    dead = ~active
    out[samp[dead].long(), pix[dead].long()] = L.to_array()[dead]
    new = torch.empty_like(table)
    new[:RADIANCE + 3] = torch.stack((*org, *dirn, *T, *L))
    int_rows(new).copy_(torch.stack((state, pix, samp)))
    new[LIVE] = active.to(torch.float32)
    return new


# -- the kernels on the card --------------------------------------------------

def load_library() -> ctypes.CDLL:
    """Build (if needed) csrc/wave_step.cu (W1-W3) and load it, once per
    process.  Raises if nvcc is missing or the build fails."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(SOURCE, BUILD_DIR)
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.pt_wave_record_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr,   # ox oy oz dx dy dz
            ptr, ptr, i32, f32,             # t, slot, n, tnear
            ptr, ptr, i32,                  # brick_data, sph_rows, S
            ptr, ptr, ptr]                  # out, ctl, stream
        lib.pt_wave_shadow_rays_launch.argtypes = [
            ptr, i32, ptr, i32, ptr, ptr]   # rec, n, lights, L, out, stream
        lib.pt_wave_shade_launch.argtypes = [
            ptr, ptr, ctypes.c_longlong,    # table, next, next_stride
            ptr, i32, ptr,                  # rec, n, shadow_t
            ptr, i32, ptr, i32, ptr,        # lights, L, sph_rows, S, bg
            i32, i32, i32,                  # depth, rr_start, max_depth
            ptr, i32, ptr, ptr]             # out, pixels, ctl, stream
        lib.pt_wave_sort_key_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr,   # ox oy oz dx dy dz
            ptr, i32, i32,                  # live, n, mode
            ptr, ptr, ptr, i32,             # lo, inv_extent, coarse, K
            ptr, ptr, ptr]                  # out, ctl, stream
        lib.pt_wave_tally_launch.argtypes = [ptr, ptr]  # ctl, stream
        lib.pt_wave_drain_launch.argtypes = [
            ptr, ctypes.c_longlong,         # table, stride
            ptr, ptr, ptr, ptr,             # nodes, tris, gates, brick_data
            ptr, i32, ptr,                  # sph_rows, S, bg
            i32, i32, ptr, i32,             # rr_start, max_depth, out, pixels
            ptr, i32, ptr]                  # ctl, lanes, stream
        lib.pt_wave_drain_lanes.argtypes = [i32, ctypes.POINTER(i32)]
        for fn in (lib.pt_wave_record_launch, lib.pt_wave_shadow_rays_launch,
                   lib.pt_wave_shade_launch, lib.pt_wave_sort_key_launch,
                   lib.pt_wave_tally_launch, lib.pt_wave_drain_launch,
                   lib.pt_wave_drain_lanes):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(device, named) -> None:
    """Each of ``named`` ((label, tensor, dtype, shape or None)) must be a
    contiguous tensor of that dtype and shape on ``device``, a card."""
    if device.type != "cuda":
        raise ValueError(f"the wave step kernels need CUDA tensors, got "
                         f"{device}")
    for label, t, dtype, shape in named:
        if (t.device != device or t.dtype != dtype or not t.is_contiguous()
                or (shape is not None and tuple(t.shape) != tuple(shape))):
            raise ValueError(f"{label}: need a contiguous {dtype} tensor of "
                             f"shape {shape} on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _launch(name: str, fn, device, *args) -> None:
    """Call launch function ``fn`` with ``args`` and the current stream of
    ``device``; raises if it returns a CUDA error."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _control(ctl, device):
    """The data pointer of a control block ``ctl`` (a null pointer for
    None), checked to be an int64 [CONTROL_SLOTS] tensor on ``device``."""
    if ctl is None:
        return None
    _check(device, [("ctl", ctl, torch.int64, (CONTROL_SLOTS,))])
    return ctl.data_ptr()


def wave_record_cuda(bricks: BrickSet, t, slot, org: Vec3, dirn: Vec3,
                     tnear: float, ctl=None) -> torch.Tensor:
    """Launch W1 on the current stream: the [16, N] record of a wave's rays
    (contiguous float32 [N] components on one card) from the trace's t [N]
    f32 and slot [N] i32.  Adds one to ``wave_record_cuda.launches`` per
    launch; an empty wave launches nothing.  With a control block ``ctl``
    only its ``COUNT`` first rays are recorded (the rest of the record is
    left unwritten)."""
    device = t.device
    n = int(t.numel())
    _check(device, [(f"ray row {k}", c, torch.float32, (n,))
                    for k, c in enumerate((*org, *dirn))]
           + [("t", t, torch.float32, (n,)), ("slot", slot, torch.int32, (n,)),
              ("bricks.brick_data", bricks.brick_data, torch.float32, None),
              ("bricks.sph_rows", bricks.sph_rows, torch.float32, None)])
    if tuple(bricks.brick_data.shape[1:]) != (BRICK_ROWS, 128):
        raise ValueError("bricks.brick_data: need [B, 136, 128]")
    out = torch.empty((16, n), dtype=torch.float32, device=device)
    if n:
        _launch("wave_record", load_library().pt_wave_record_launch, device,
                *(c.data_ptr() for c in (*org, *dirn)), t.data_ptr(),
                slot.data_ptr(), n, float(tnear), bricks.brick_data.data_ptr(),
                bricks.sph_rows.data_ptr(), bricks.num_spheres,
                out.data_ptr(), _control(ctl, device))
        wave_record_cuda.launches += 1
    return out


wave_record_cuda.launches = 0


def wave_shadow_rays_cuda(rec: torch.Tensor, light_rows) -> torch.Tensor:
    """Launch W2's first half on the current stream: the [L, 3, N]
    directions of the shadow rays of record ``rec`` [16, N] toward the
    lights ``light_rows`` [L, 6].  Adds one to
    ``wave_shadow_rays_cuda.launches`` per launch."""
    device = rec.device
    n = int(rec.shape[1]) if rec.ndim == 2 else -1
    n_lights = int(light_rows.shape[0])
    _check(device, [("rec", rec, torch.float32, (16, n)),
                    ("light_rows", light_rows, torch.float32, (n_lights, 6))])
    out = torch.empty((n_lights, 3, n), dtype=torch.float32, device=device)
    if n and n_lights:
        _launch("wave_shadow_rays", load_library().pt_wave_shadow_rays_launch,
                device, rec.data_ptr(), n, light_rows.data_ptr(), n_lights,
                out.data_ptr())
        wave_shadow_rays_cuda.launches += 1
    return out


wave_shadow_rays_cuda.launches = 0


def wave_shade_cuda(table: torch.Tensor, rec: torch.Tensor, depth: int, bg,
                    rr_start_depth: int, max_depth: int, out: torch.Tensor,
                    light_rows=None, shadow_t=None, sph_rows=None,
                    num_spheres: int = 0, ctl=None,
                    into=None) -> torch.Tensor:
    """Launch W2 on the current stream: ``shade_plain``'s contract on a
    table of N rays on one card; returns the fresh new table, or writes it
    into ``into`` (float32 [16, N] with contiguous rows) and returns that.
    Adds one to ``wave_shade_cuda.launches`` per launch; an empty wave
    launches nothing.  With a control block ``ctl`` only its ``COUNT``
    first rays are shaded, at its ``DEPTH`` (``depth`` is not read), and
    the rest of the new table is left unwritten."""
    device = table.device
    n = int(table.shape[1]) if table.ndim == 2 else -1
    named = [("table", table, torch.float32, (16, n)),
             ("rec", rec, torch.float32, (16, n)),
             ("bg", bg, torch.float32, (3,)),
             ("out", out, torch.float32, None)]
    n_lights = 0
    if light_rows is not None:
        n_lights = int(light_rows.shape[0])
        named += [("light_rows", light_rows, torch.float32, (n_lights, 6)),
                  ("shadow_t", shadow_t, torch.float32, (n_lights, n)),
                  ("sph_rows", sph_rows, torch.float32, None)]
    _check(device, named)
    if out.ndim != 3 or out.shape[2] != 3:
        raise ValueError("out: need [num_samples, pixels, 3]")
    new = torch.empty_like(table) if into is None else into
    if (new.device != device or new.dtype != torch.float32
            or tuple(new.shape) != (16, n) or new.stride(1) != 1):
        raise ValueError(f"into: need a float32 [16, {n}] tensor with "
                         f"contiguous rows on {device}")
    if n:
        lib = load_library()
        ptr = lambda t: None if t is None or not n_lights else t.data_ptr()
        _launch("wave_shade", lib.pt_wave_shade_launch, device,
                table.data_ptr(), new.data_ptr(), new.stride(0),
                rec.data_ptr(), n, ptr(shadow_t), ptr(light_rows), n_lights,
                ptr(sph_rows), num_spheres if n_lights else 0, bg.data_ptr(),
                int(depth), int(rr_start_depth), int(max_depth),
                out.data_ptr(), int(out.shape[1]), _control(ctl, device))
        wave_shade_cuda.launches += 1
    return new


wave_shade_cuda.launches = 0


def wave_sort_key_cuda(table: torch.Tensor, mode: str, lo, inv_extent,
                       coarse=None, ctl=None, out=None) -> torch.Tensor:
    """Launch W3 on the current stream: ``sort_key_plain``'s contract on a
    table of N rays on one card (rows contiguous); ``lo`` and
    ``inv_extent`` are [3] float32 tensors there.  Returns a fresh int32
    [N] key, or writes it into ``out`` and returns that.  Adds one to
    ``wave_sort_key_cuda.launches`` per launch; an empty wave launches
    nothing.  With a control block ``ctl`` every column at or past its
    ``COUNT`` keys to INT32_MAX and the live count is added to its
    ``NEXT``."""
    if mode not in SORT_MODES:
        raise ValueError(f"unknown sort mode {mode!r}")
    device = table.device
    n = int(table.shape[1]) if table.ndim == 2 else -1
    if table.ndim != 2 or table.shape[0] != 16 or table.stride(1) != 1:
        raise ValueError(f"table: need a float32 [16, N] tensor with "
                         f"contiguous rows, got {tuple(table.shape)}")
    named = [("table row", table[0], torch.float32, (n,)),
             ("lo", lo, torch.float32, (3,)),
             ("inv_extent", inv_extent, torch.float32, (3,))]
    K = 0
    if mode == "sig_mort":
        K = int(coarse.shape[0])
        named.append(("coarse", coarse, torch.float32, (K, 8)))
    if out is None:
        out = torch.empty(n, dtype=torch.int32, device=device)
    named.append(("out", out, torch.int32, (n,)))
    _check(device, named)
    if n:
        _launch("wave_sort_key", load_library().pt_wave_sort_key_launch,
                device, *(table[r].data_ptr() for r in range(ORG, DIR + 3)),
                table[LIVE].data_ptr(), n, SORT_MODES.index(mode),
                lo.data_ptr(), inv_extent.data_ptr(),
                coarse.data_ptr() if K else None, K, out.data_ptr(),
                _control(ctl, device))
        wave_sort_key_cuda.launches += 1
    return out


wave_sort_key_cuda.launches = 0


def drain_lanes(device) -> int:
    """The drain's resident lanes on card ``device``: its SMs times the
    drain's blocks one SM holds at once (by the CUDA occupancy query)
    times the block's 128 threads."""
    device = torch.device(device)
    _check(device, [])
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    lanes = ctypes.c_int(0)
    err = load_library().pt_wave_drain_lanes(index, ctypes.byref(lanes))
    if err != 0:
        raise RuntimeError(f"wave_drain occupancy failed: CUDA error {err}")
    return lanes.value


def wave_drain_cuda(bricks: BrickSet, table: torch.Tensor, ctl, bg,
                    rr_start_depth: int, max_depth: int, out: torch.Tensor,
                    lanes: int) -> None:
    """Launch the drain and its tally on the current stream with ``lanes``
    threads (a multiple of 128; ``drain_lanes``): ``drain_plain``'s contract
    on the carried table ``table`` (float32 [16, C], rows contiguous) and
    the control block ``ctl`` on one card.  Adds one to
    ``wave_drain_cuda.launches`` per launch."""
    device = table.device
    if (table.ndim != 2 or table.shape[0] != TABLE_ROWS
            or table.dtype != torch.float32 or table.stride(1) != 1):
        raise ValueError(f"table: need a float32 [16, C] tensor with "
                         f"contiguous rows, got {table.dtype} "
                         f"{tuple(table.shape)}")
    _check(device, [("bg", bg, torch.float32, (3,)),
                    ("out", out, torch.float32, None),
                    ("bricks.brick_data", bricks.brick_data, torch.float32,
                     None),
                    ("bricks.sph_rows", bricks.sph_rows, torch.float32,
                     None)])
    if out.ndim != 3 or out.shape[2] != 3:
        raise ValueError("out: need [num_samples, pixels, 3]")
    if tuple(bricks.brick_data.shape[1:]) != (BRICK_ROWS, 128):
        raise ValueError("bricks.brick_data: need [B, 136, 128]")
    if bricks.top_depth + 2 > STACK_DEPTH:
        raise ValueError(f"top tree of depth {bricks.top_depth} is too deep "
                         f"for the kernel's stack of {STACK_DEPTH} slots")
    if lanes <= 0 or lanes % 128:
        raise ValueError(f"lanes: need a positive multiple of 128, got "
                         f"{lanes}")
    nodes, tris, gates = walk_pointers(bricks)
    _launch("wave_drain", load_library().pt_wave_drain_launch, device,
            table.data_ptr(), table.stride(0), nodes, tris, gates,
            bricks.brick_data.data_ptr(), bricks.sph_rows.data_ptr(),
            bricks.num_spheres, bg.data_ptr(), int(rr_start_depth),
            int(max_depth), out.data_ptr(), int(out.shape[1]),
            _control(ctl, device), int(lanes))
    wave_drain_cuda.launches += 1


wave_drain_cuda.launches = 0


# -- dispatch -----------------------------------------------------------------

def _on(device, name: str) -> bool:
    """True for a card, False for the CPU; raises for any other device."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"no {name} for device {device}")
    return True


def wave_record(bricks: BrickSet, t, slot, org: Vec3, dirn: Vec3,
                tnear: float) -> torch.Tensor:
    """The [16, N] hit record of a wave: W1 on CUDA tensors, its plain
    version on CPU tensors."""
    if bricks.device != t.device:
        raise ValueError(f"bricks on {bricks.device}, rays on {t.device}")
    if _on(t.device, "wave record"):
        return wave_record_cuda(bricks, t, slot, org, dirn, tnear)
    return record_plain(bricks, t, slot, org, dirn, tnear)


def wave_shadow_rays(rec: torch.Tensor, light_rows) -> torch.Tensor:
    """The [L, 3, N] shadow ray directions of a record: W2's first half on
    CUDA tensors, its plain version on CPU tensors."""
    if _on(rec.device, "shadow rays"):
        return wave_shadow_rays_cuda(rec, light_rows)
    return shadow_rays_plain(rec, light_rows)


def wave_shade(table: torch.Tensor, rec: torch.Tensor, depth: int, bg,
               rr_start_depth: int, max_depth: int, out: torch.Tensor,
               light_rows=None, shadow_t=None, sph_rows=None,
               num_spheres: int = 0) -> torch.Tensor:
    """One bounce of every ray of the table into a new table
    (``shade_plain``): W2 on CUDA tensors, its plain version on CPU
    tensors."""
    step = wave_shade_cuda if _on(table.device, "wave shade") else shade_plain
    return step(table, rec, depth, bg, rr_start_depth, max_depth, out, light_rows,
         shadow_t, sph_rows, num_spheres)


def wave_sort_key(table: torch.Tensor, mode: str, lo, inv_extent,
                  coarse=None) -> torch.Tensor:
    """The int32 [N] key of the next wave (``sort_key_plain``): W3 on CUDA
    tensors, its plain version on CPU tensors."""
    if _on(table.device, "sort key"):
        return wave_sort_key_cuda(table, mode, lo, inv_extent, coarse)
    return sort_key_plain(table, mode, lo, inv_extent, coarse)


# -- the counted schedule's steps ---------------------------------------------

def new_control(device) -> torch.Tensor:
    """A zeroed control block (``COUNT`` .. ``RAYS``) on ``device``."""
    return torch.zeros(CONTROL_SLOTS, dtype=torch.int64, device=device)


def _head(ctl, n: int) -> int:
    """The plain versions' prefix of an n-column table that holds the
    wave's rays (a read of ``ctl``, on the CPU)."""
    return min(int(ctl[COUNT]), n)


def record_counted(bricks: BrickSet, t, slot, org: Vec3, dirn: Vec3,
                   tnear: float, ctl) -> torch.Tensor:
    """W1 over the first ``ctl[COUNT]`` of a wave's N columns: a [16, N]
    record, whose other columns are left unwritten (zeros on the CPU)."""
    if _on(t.device, "wave record"):
        return wave_record_cuda(bricks, t, slot, org, dirn, tnear, ctl)
    m = _head(ctl, int(t.numel()))
    rec = torch.zeros((16, int(t.numel())), dtype=torch.float32)
    head = lambda v: Vec3(*(c[:m] for c in v))
    rec[:, :m] = record_plain(bricks, t[:m], slot[:m], head(org), head(dirn),
                              tnear)
    return rec


def shade_counted(table: torch.Tensor, into: torch.Tensor, rec: torch.Tensor,
                  ctl, bg, rr_start_depth: int, max_depth: int,
                  out: torch.Tensor) -> torch.Tensor:
    """W2 without lights over the first ``ctl[COUNT]`` rays of ``table``
    [16, N], at depth ``ctl[DEPTH]``, into the same columns of ``into``
    ([16, N], rows contiguous; its other columns stay as they were);
    returns ``into``."""
    if _on(table.device, "wave shade"):
        return wave_shade_cuda(table, rec, 0, bg, rr_start_depth, max_depth,
                               out, ctl=ctl, into=into)
    m = _head(ctl, int(table.shape[1]))
    into[:, :m] = shade_plain(table[:, :m], rec[:, :m], int(ctl[DEPTH]), bg,
                              rr_start_depth, max_depth, out)
    return into


def key_counted(table: torch.Tensor, mode: str, lo, inv_extent, coarse, ctl,
                key: torch.Tensor) -> torch.Tensor:
    """W3 into ``key`` (int32 [N]) over ``table`` [16, N] (rows
    contiguous), INT32_MAX at and past ``ctl[COUNT]``, and the live count
    added to ``ctl[NEXT]``; returns ``key``."""
    if _on(table.device, "sort key"):
        return wave_sort_key_cuda(table, mode, lo, inv_extent, coarse, ctl,
                                  key)
    m = _head(ctl, int(table.shape[1]))
    key.fill_(INT32_MAX)
    key[:m] = sort_key_plain(table[:, :m], mode, lo, inv_extent, coarse)
    ctl[NEXT] += int((table[LIVE, :m] > 0.0).sum())
    return key


def tally(ctl) -> None:
    """The control block's step from one wave to the next: the wave just
    traced (``COUNT`` rays) adds to ``WAVES`` and ``RAYS`` and its columns
    become ``VALID``, the live count summed in ``NEXT`` becomes ``COUNT``,
    and ``DEPTH`` goes up by one (the kernel ``wave_tally`` on a card)."""
    if _on(ctl.device, "tally"):
        _launch("wave_tally", load_library().pt_wave_tally_launch, ctl.device,
                _control(ctl, ctl.device))
        return
    n = int(ctl[COUNT])
    ctl[WAVES] += int(n > 0)
    ctl[RAYS] += n
    ctl[VALID] = n
    ctl[COUNT] = ctl[NEXT]
    ctl[NEXT] = 0
    ctl[DEPTH] += 1


def drain_plain(bricks: BrickSet, table: torch.Tensor, ctl, bg,
                rr_start_depth: int, max_depth: int, out: torch.Tensor,
                trace=None, steps=None) -> None:
    """The drain's plain version: the live columns among the first
    ``ctl[VALID]`` of the carried table ``table`` [16, C], from depth
    ``ctl[DEPTH]`` on, traced (``trace(bricks, org, dirn, tnear) -> (t,
    slot)``, default the plain walk), recorded and shaded (``steps``,
    default ``PLAIN_STEPS``) level by level, unsorted, until none is live;
    each path's radiance written to ``out`` [num_samples, pixels, 3] at its
    (sample, pixel) when it ends.  The rays traced add to ``ctl[RAYS]``,
    the levels (the waves the uncounted schedule would have run) to
    ``WAVES`` and ``DEPTH``; no ray is left (``COUNT``, ``NEXT``,
    ``VALID`` 0).  Given the wave step's kernels (``STEPS`` and kernel B2)
    on a card it runs what the drain kernel fuses, launch by launch."""
    trace = trace or trace_bricks_plain
    steps = steps or PLAIN_STEPS
    rows = table[:, :min(int(ctl[VALID]), int(table.shape[1]))]
    live = rows[:, rows[LIVE] > 0.0]
    depth, levels, rays = int(ctl[DEPTH]), 0, 0
    while live.shape[1]:
        org, dirn = rows3(live, ORG), rows3(live, DIR)
        t, slot = trace(bricks, org, dirn, SECONDARY_TNEAR)[:2]
        rec = steps.record(bricks, t, slot, org, dirn, SECONDARY_TNEAR)
        new = steps.shade(live, rec, depth, bg, rr_start_depth, max_depth,
                          out)
        rays += int(live.shape[1])
        levels += 1
        depth += 1
        live = new[:, new[LIVE] > 0.0]
    ctl[WAVES] += levels
    ctl[RAYS] += rays
    ctl[DEPTH] += levels
    for k in (COUNT, NEXT, VALID, CURSOR, LEVELS):
        ctl[k] = 0


def drain_counted(bricks: BrickSet, table: torch.Tensor, ctl, bg,
                  rr_start_depth: int, max_depth: int, out: torch.Tensor,
                  lanes: int) -> None:
    """The drain of the carried table ``table`` under the control block
    ``ctl``: the kernel with ``lanes`` threads on a card, ``drain_plain``
    on the CPU."""
    if _on(table.device, "drain"):
        wave_drain_cuda(bricks, table, ctl, bg, rr_start_depth, max_depth,
                        out, lanes)
    else:
        drain_plain(bricks, table, ctl, bg, rr_start_depth, max_depth, out)


class WaveSteps(NamedTuple):
    """The bounce step's functions, as ``render_waves`` calls them."""
    record: Callable        # (bricks, t, slot, org, dirn, tnear) -> [16, N]
    shadow_rays: Callable   # (rec, light_rows) -> [L, 3, N]
    shade: Callable         # (table, rec, depth, bg, ...) -> new table
    key: Callable           # (table, mode, lo, inv_extent, coarse) -> [N]


STEPS = WaveSteps(wave_record, wave_shadow_rays, wave_shade, wave_sort_key)
PLAIN_STEPS = WaveSteps(record_plain, shadow_rays_plain, shade_plain,
                        sort_key_plain)


def recording_steps(log: list, steps: WaveSteps = STEPS) -> WaveSteps:
    """``steps`` that first append each call's name ("record",
    "shadow_rays", "shade" or "key") and a copy of its arguments to ``log``:
    a render's own inputs to each step, which the chip smoke and the tests
    hold the kernels to their plain versions on."""
    def copy(a):
        if isinstance(a, Vec3):
            return Vec3(*(c.clone() for c in a))
        return a.clone() if isinstance(a, torch.Tensor) else a

    def wrap(name, fn):
        def call(*args):
            log.append((name, tuple(copy(a) for a in args)))
            return fn(*args)
        return call

    return WaveSteps(*(wrap(name, fn)
                       for name, fn in zip(WaveSteps._fields, steps)))
