"""The "mx" large-scene path: ray/triangle intersection as library
products over the bricks of an ``MXSet``.

The port of ``pathtracer_cuda_interactive_tpu/experiments/mxtrace.py``.
Per wave:

  1. CULL: packets of ``MX_PACKET`` consecutive rays are bounded (origin
     box and direction interval) and tested against ALL brick boxes at once
     by interval arithmetic, and each packet's overlapped bricks are ordered
     by conservative entry distance.  The cull is the pair tracer's
     (ops/pairtrace.py::visit_lists with packets of one row of 128 rays).
  2. INTERSECT: rounds.  In round r every packet that still needs its r-th
     brick intersects its 128 rays with the brick's T triangles by ONE
     [128, 10] x [10, 4T] product in the Plucker feature basis (mxset.py),
     then a sign-corrected validity test and a min over the triangles
     update each ray's closest hit.  A packet is done as soon as every ray's
     best t is at or below the entry bound of its next brick.

This path holds no hand-written kernel, as the JAX path holds no Pallas
kernel: there the product is a ``dot_general`` of XLA's outside any kernel,
here it is ``torch.bmm``.  It must run in full float32: TF32 keeps three
decimal digits, and the validity test ``su + sv <= sd`` would flip on
edges, so ``_mx_rounds`` switches ``torch.backends.cuda.matmul.allow_tf32``
off while it runs.  Where the JAX round computes every packet and masks the
ones that are done, a round here gathers only the packets that need their
brick; the result is the same.

Attributes are fetched once per wave by a gather of the winning slot's
32-float row, and the resident spheres are folded in
(ops/wave_step.py::_record_from_rows), which gives the 16-channel record of
the wavefront; the wave loop is the wavefront's own (``render_waves``).
"""

from __future__ import annotations

import contextlib

import torch

from ..ops.integrator import MAX_DEPTH, RR_START_DEPTH
from ..ops.pairtrace import LANES, visit_lists
from ..ops.vec import Vec3
from ..ops.wave_step import _record_from_rows
from ..ops.wavefront import render_waves
from .mxset import MXSet

INF = float("inf")
MX_PACKET = LANES        # rays per cull packet
# Wave cap for THIS path, far below the wavefront's 2^21: a round
# materializes up to [M, 128, 4T] f32 (M = wave / 128), 537 MB at 2^18 rays
# and T = 128; one 640x480 frame is cut into two slot slices.
MX_MAX_RAYS_PER_WAVE = 1 << 18


@contextlib.contextmanager
def full_float32_products():
    """No TF32 in CUDA matrix products inside the block."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _features(org: Vec3, dirn: Vec3) -> torch.Tensor:
    """[..., 10] Plucker ray features [o, d, o x d, 1] (mxset.py)."""
    cx = org.y * dirn.z - org.z * dirn.y
    cy = org.z * dirn.x - org.x * dirn.z
    cz = org.x * dirn.y - org.y * dirn.x
    return torch.stack([org.x, org.y, org.z, dirn.x, dirn.y, dirn.z,
                        cx, cy, cz, torch.ones_like(org.x)], dim=-1)


def _mx_rounds(coeff, order, slb, feats, live, tnear: float, T: int,
               stats=None):
    """Nearest-brick rounds.  feats [M, P, 10]; live [M, P]; order / slb
    [M, B] (each packet's bricks near first and their conservative entry
    bounds, inf = not listed).  Returns (t, u, v, slot) per ray [M, P],
    slot = brick * T + k or -1.  ``stats``, a dict, gets the rounds run
    ("rounds") and the (packet, brick) products made ("products") added."""
    M, P = live.shape
    dev = feats.device
    bt = torch.full((M, P), INF, dtype=torch.float32, device=dev)
    bu = torch.zeros((M, P), dtype=torch.float32, device=dev)
    bv = torch.zeros((M, P), dtype=torch.float32, device=dev)
    bslot = torch.full((M, P), -1, dtype=torch.int32, device=dev)
    with full_float32_products():
        for r in range(int(order.shape[1])):
            lbr = slb[:, r]
            need = ((live & (bt > lbr[:, None])).any(dim=1)
                    & torch.isfinite(lbr))
            idx = torch.nonzero(need).reshape(-1)
            if idx.numel() == 0:
                break
            if stats is not None:
                stats["rounds"] = stats.get("rounds", 0) + 1
                stats["products"] = stats.get("products", 0) + idx.numel()
            bid = order[idx, r].to(torch.int64)
            out = torch.bmm(feats[idx], coeff[bid])      # [m, P, 4T]
            det = out[..., 0 * T:1 * T]
            U = out[..., 1 * T:2 * T]
            V = out[..., 2 * T:3 * T]
            Tt = out[..., 3 * T:4 * T]
            s = torch.sign(det)
            su, sv, sd = U * s, V * s, det * s
            tt = Tt / torch.where(det == 0.0, 1.0, det)
            b0 = bt[idx]
            valid = ((det != 0.0) & (su >= 0.0) & (sv >= 0.0)
                     & (su + sv <= sd) & (tt > tnear) & (tt < b0[..., None])
                     & live[idx][..., None])
            tv = torch.where(valid, tt, INF)
            # the first of equal minima, as jnp.argmin
            ke = torch.argmin(tv, dim=-1, keepdim=True)          # [m, P, 1]
            tm = torch.gather(tv, -1, ke)[..., 0]
            better = tm < b0
            dk = torch.gather(det, -1, ke)[..., 0]
            inv_d = 1.0 / torch.where(dk == 0.0, 1.0, dk)
            um = torch.gather(U, -1, ke)[..., 0] * inv_d
            vm = torch.gather(V, -1, ke)[..., 0] * inv_d
            slot = (bid[:, None] * T + ke[..., 0]).to(torch.int32)
            bt[idx] = torch.where(better, tm, b0)
            bu[idx] = torch.where(better, um, bu[idx])
            bv[idx] = torch.where(better, vm, bv[idx])
            bslot[idx] = torch.where(better, slot, bslot[idx])
    return bt, bu, bv, bslot


def _trace_mx(mx: MXSet, org: Vec3, dirn: Vec3, tnear: float,
              stats=None):
    """(t, slot, u, v) closest triangle hit of one wave of rays ([N]
    components, any N) over the bricks of ``mx``: the cull, then the
    rounds.  t is inf and slot -1 on a miss."""
    dev = org.x.device
    if mx.device != dev:
        raise ValueError(f"MX set on {mx.device}, rays on {dev}")
    n = int(org.x.numel())
    if n == 0:
        empty = torch.empty(0, dtype=torch.float32, device=dev)
        return (empty, torch.empty(0, dtype=torch.int32, device=dev),
                empty, empty)
    order, slb, _ = visit_lists(mx, org, dirn, tnear, 1)
    M = order.shape[0]
    pad = M * MX_PACKET - n
    rp = lambda a: torch.nn.functional.pad(a, (0, pad)).view(M, MX_PACKET)
    live = rp(torch.ones(n, dtype=torch.bool, device=dev))
    feats = _features(Vec3(*(rp(c) for c in org)),
                      Vec3(*(rp(c) for c in dirn)))
    t, u, v, slot = _mx_rounds(mx.coeff, order, slb, feats, live, tnear,
                               mx.brick_prims, stats)
    flat = lambda a: a.reshape(-1)[:n]
    return flat(t), flat(slot), flat(u), flat(v)


def _record_mx(mx: MXSet, t, slot, u, v, org: Vec3, dirn: Vec3,
               tnear: float):
    """The wave's 16-channel record from the rounds' winners: the (u, v) are
    the product's own, u*det / det and v*det / det."""
    rows = mx.tri_rows[torch.clamp_min(slot, 0).to(torch.int64)]
    return _record_from_rows(rows, u, v, t, slot, mx.sph_rows,
                             mx.num_spheres, org, dirn, tnear)


def render_samples_mx(mx: MXSet, cam_data: torch.Tensor, width: int,
                      height: int, sample_start: int, num_samples: int = 1,
                      seed: int = 1984, max_depth: int = MAX_DEPTH,
                      rr_start_depth: int = RR_START_DEPTH,
                      sort_mode: str = "mort_oct", nee: bool = False,
                      stats=None, pix_slots=None,
                      num_real=None) -> torch.Tensor:
    """"mx" drop-in for ops.wavefront.render_samples_wavefront: the [H, W, 3]
    radiance SUM of ``num_samples`` passes on ``cam_data``'s device.
    ``sort_mode`` is "mort_oct" or "none" ("sig_mort" needs a BrickSet).
    ``stats``, a dict, gets the traced waves and rays and the rounds and
    products of ``_mx_rounds`` added to it.  ``pix_slots`` and ``num_real``
    pick the slots and the passes that count (ops/wavefront.py::
    render_waves)."""
    stats = {} if stats is None else stats
    tracer = lambda scene, o, d, tnear: _trace_mx(scene, o, d, tnear, stats)
    return render_waves(mx, cam_data, width, height, sample_start,
                        num_samples, seed, max_depth, rr_start_depth,
                        sort_mode, nee, mx.scene_lo, mx.scene_hi,
                        (tracer,) * max_depth, _record_mx, stats,
                        max_rays=MX_MAX_RAYS_PER_WAVE, pix_slots=pix_slots,
                        num_real=num_real)
