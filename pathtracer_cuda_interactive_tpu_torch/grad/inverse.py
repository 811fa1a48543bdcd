"""Pixel gradients: an L2 image loss and its gradients with respect to the
scene's continuous parameters, on one device or across a mesh.

The port of ``pathtracer_cuda_interactive_tpu/grad/inverse.py``: material
albedo and parameters, emitted radiance, background and point-light
intensity, checked against finite differences.  Discrete decisions carry no
gradient: hit ids come from a search under ``torch.no_grad``
(ops/bruteforce.py, ops/trace.py), BRDF lobe choices and Russian-roulette
draws depend on the RNG alone.  Every continuous factor (reflectance,
Fresnel weight, cosines, emitted radiance) is differentiable through the
fixed Python loop of bounces of ``ops/integrator.py::radiance_fixed``.  No
hand-written kernel takes part, as no Pallas kernel does in the JAX package.

On a mesh (parallel/sharding.py) ``torch.distributed.all_reduce`` is not
differentiable, so the step is written out: each rank renders its rows and
passes with autograd, the partial sums are all-reduced detached, the loss
and ``dL/dimg`` are computed without autograd, each rank backpropagates
``dL/dimg`` on its own rows into its own partial sum, and the gradients are
all-reduced over the world.  The sum holds exactly ``num_samples`` passes
on every mesh (the forward rule of parallel/sharding.py), so the sharded
loss and gradients equal the single-device ones for every sample count.
The JAX step divides by ``ceil(S / n_s) * n_s`` without masking the
surplus passes; where ``n_s`` divides ``S`` the two agree.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.device_scene import DeviceScene
from ..ops import camera, rng
from ..ops.integrator import radiance_fixed
from ..parallel.sharding import LANES, Mesh, _padded_grid, _sample_shard

# The continuous scene parameters exposed to optimisation.  Geometry is
# differentiable through shade_setup too, but its edges need
# silhouette-aware estimators this does not claim; these interior
# parameters have unbiased gradients under fixed sampling.
DIFF_PARAMS = ("mat_r", "mat_g", "mat_b", "mat_param",
               "prim_em_r", "prim_em_g", "prim_em_b",
               "bg_r", "bg_g", "bg_b", "light_intensity")


def split_params(scene: DeviceScene):
    """-> (params dict, the scene): ``merge_params`` overwrites only the
    parameters, so the scene keeps every other field."""
    return {k: getattr(scene, k) for k in DIFF_PARAMS}, scene


def merge_params(scene: DeviceScene, params) -> DeviceScene:
    return dataclasses.replace(scene, **params)


def _auto_nee(scene: DeviceScene, nee) -> bool:
    """nee=None -> on exactly when the scene has point lights: they reach
    the image only through NEE, so without it light_intensity's gradient
    is zero."""
    if nee is None:
        return int(scene.light_pos.shape[0]) > 0
    return bool(nee)


def render_pixels_diff(scene: DeviceScene, cam_data: torch.Tensor,
                       pix: torch.Tensor, width: int, height: int,
                       sample_start: int, num_samples: int,
                       seed: int = 1984, num_bounces: int = 6,
                       nee=None) -> torch.Tensor:
    """Differentiable counterpart of ops.integrator.render_pixel_sums: the
    same camera and RNG streams, a Python loop over the samples, each
    through ``radiance_fixed``.  Returns the sums, shaped pix.shape +
    (3,)."""
    nee = _auto_nee(scene, nee)
    i = (pix % width).to(torch.float32)
    j = (pix // width).to(torch.float32)
    acc = torch.zeros(pix.shape + (3,), dtype=torch.float32,
                      device=pix.device)
    for k in range(num_samples):
        state = rng.seed_rays(pix, sample_start + k, seed)
        state, u1 = rng.next_uniform(state)
        state, u2 = rng.next_uniform(state)
        org, dirn = camera.generate_primary_rays(
            cam_data, (i + u1) / width, (j + u2) / height)
        L = radiance_fixed(scene, org, dirn, state, num_bounces, nee=nee)
        acc = acc + L.to_array()
    return acc


def image_to_grid(img, n_tiles: int = 1):
    """[H, W, 3] -> ([rows, 128, 3] in ``_padded_grid``'s pixel order,
    valid mask [rows, 128]), on the image's device (numpy: the CPU)."""
    img = torch.as_tensor(img, dtype=torch.float32)
    H, W = img.shape[:2]
    pix, rows = _padded_grid(W, H, n_tiles)
    flat = torch.zeros((rows * LANES, 3), dtype=torch.float32,
                       device=img.device)
    flat[:H * W] = img.reshape(H * W, 3)
    valid = torch.from_numpy(pix < H * W).to(img.device)
    return flat.reshape(rows, LANES, 3), valid


def _leaves(params: dict, device) -> dict:
    """Each parameter as a float32 tensor on ``device`` that autograd
    differentiates: a tensor that requires grad as it is, anything else
    (a tensor or a numpy array) as a new leaf."""
    out = {}
    for k, v in params.items():
        if isinstance(v, torch.Tensor):
            if v.requires_grad:
                out[k] = v
                continue
            v = v.detach()
        out[k] = torch.as_tensor(v, dtype=torch.float32,
                                 device=device).clone().requires_grad_(True)
    return out


def _grads(outputs, leaves: dict, grad_outputs=None) -> dict:
    """d outputs / d leaf for every leaf; zeros for a leaf the outputs do
    not reach (light_intensity without point lights), as JAX's grad."""
    names = list(leaves)
    if not outputs.requires_grad:
        return {k: torch.zeros_like(leaves[k]) for k in names}
    gs = torch.autograd.grad(outputs, [leaves[k] for k in names],
                             grad_outputs=grad_outputs, allow_unused=True)
    return {k: torch.zeros_like(leaves[k]) if g is None else g
            for k, g in zip(names, gs)}


def _sq_err(img, target_grid, valid):
    m = valid[..., None].to(torch.float32)
    err = (img - target_grid) * m
    return err * err, err


def loss_and_grad(params: dict, scene: DeviceScene, cam_data: torch.Tensor,
                  target_grid: torch.Tensor, valid: torch.Tensor,
                  pix: torch.Tensor, width: int, height: int,
                  sample_start: int, num_samples: int, seed: int = 1984,
                  num_bounces: int = 6, nee=None):
    """L2 image loss over the valid pixels, divided by ``width*height*3``,
    and its gradients with respect to ``params`` (a dict of the
    DIFF_PARAMS, tensors or numpy arrays) on one device, that of
    ``cam_data``.  Returns (loss, {name: gradient})."""
    leaves = _leaves(params, cam_data.device)
    acc = render_pixels_diff(merge_params(scene, leaves), cam_data, pix,
                             width, height, sample_start, num_samples, seed,
                             num_bounces, nee)
    sq, _ = _sq_err(acc / num_samples, target_grid, valid)
    loss = sq.sum() / (width * height * 3)
    return loss.detach(), _grads(loss, leaves)


def make_sharded_loss_and_grad(mesh: Mesh, width: int, height: int,
                               num_samples: int, seed: int = 1984,
                               num_bounces: int = 6, nee=None):
    """The step across ``mesh``: ``step(params, scene, cam_data,
    target_grid, valid, pix, sample_start) -> (loss, grads)``, where
    ``pix``, ``target_grid`` and ``valid`` are this rank's rows
    (``shard_grid_inputs``).  Every rank returns the global loss and the
    gradients summed over the world."""
    denom = float(width * height * 3)
    _, rows = _padded_grid(width, height, mesh.n_tiles)
    per = rows // mesh.n_tiles
    r0 = mesh.t_idx * per

    def step(params, scene, cam_data, target_grid, valid, pix,
             sample_start):
        dev = cam_data.device
        local_start, _, num_real = _sample_shard(mesh, sample_start,
                                                 num_samples)
        leaves = _leaves(params, dev)
        acc = render_pixels_diff(merge_params(scene, leaves), cam_data, pix,
                                 width, height, local_start, num_real, seed,
                                 num_bounces, nee)
        # the image: every rank's partial sum on its rows of the frame's
        # grid, summed over the world (sample shards add, tiles are apart)
        full = torch.zeros((rows, LANES, 3), dtype=torch.float32, device=dev)
        full[r0:r0 + per] = acc.detach()
        img = mesh.all_reduce(full)[r0:r0 + per] / num_samples
        sq, err = _sq_err(img, target_grid, valid)
        # each tile's sum is held by its n_s sample shards alike
        loss = mesh.all_reduce(sq.sum().reshape(1) / denom) / mesh.n_samples
        # dL/dacc on this rank's rows: dL/dimg / S
        grads = _grads(acc, leaves, 2.0 * err / (denom * num_samples))
        for g in grads.values():
            mesh.all_reduce(g)
        return loss[0], grads

    return step


def shard_grid_inputs(mesh: Mesh, target_img):
    """This rank's rows of the pixel grid, of the target image in grid
    layout and of the valid mask, on the mesh's device: (pix int32
    [rows/n_tiles, 128], target [.., 128, 3], valid [.., 128])."""
    target_img = torch.as_tensor(target_img, dtype=torch.float32)
    H, W = target_img.shape[:2]
    pix, rows = _padded_grid(W, H, mesh.n_tiles)
    tgt, valid = image_to_grid(target_img, mesh.n_tiles)
    per = rows // mesh.n_tiles
    mine = slice(mesh.t_idx * per, (mesh.t_idx + 1) * per)
    return (torch.from_numpy(pix[mine]).to(mesh.device),
            tgt[mine].to(mesh.device), valid[mine].to(mesh.device))
