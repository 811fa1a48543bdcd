"""Entry points of the port: a one-device render step and a
multi-device dry run.

The port's counterpart of the repo's ``__graft_entry__.py``, on the in-repo
scenes (the reference's cbox and teapot are not in the repo):

  * ``entry(device)`` -> ``(fn, args)``: ``fn(scene, cam_data,
    sample_start)`` is one progressive step of the plain integrator
    (``ops/integrator.py::render_samples``, 160x120, 1 spp, depth 8) on
    ``scenes/cbox_rect.xml``;
  * ``dryrun_multichip(n, device)`` starts ``n`` ranks and runs on each
    what the JAX dry run runs: the sharded forward step ("xla") and the
    sharded loss-and-grad step at 32x16, 2 spp, 3 bounces
    (``sample_parallel`` 2 when ``n`` is even), the sharded megakernel, and
    on ``scenes/blob_box.xml`` the wavefront, "mx" and "mx2" modes, each
    image checked finite and not constant and equal on every rank; then
    ``scaling_report`` for each of those modes, one JSON line each.

    python -m pathtracer_cuda_interactive_tpu_torch.entry --dryrun N \
        [--device cuda|cpu]

Both default to ``cuda`` and raise without it.  The dry run's ranks use
``nccl``, rank r on card r, when the host has ``n`` cards, and ``gloo``
otherwise (on one card its ranks share it).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

import numpy as np
import torch

from . import SCENES_DIR
from .models.scenepack import load_scene
from .ops.camera import Camera, camera_ray_data

CBOX = SCENES_DIR / "cbox_rect.xml"
BLOB = SCENES_DIR / "blob_box.xml"
DRY_W, DRY_H, DRY_SPP, DRY_BOUNCES = 32, 16, 2, 3
DRY_TIMEOUT_S = 900.0       # the whole world, its ranks' start included


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return device


def _load(xml, width: int, height: int, device):
    """(pack, camera data on ``device``) of a scene file."""
    pack, parsed = load_scene(str(xml))
    cd = torch.as_tensor(camera_ray_data(Camera.from_parsed(parsed.camera),
                                         width, height), device=device)
    return pack, cd


def entry(device="cuda"):
    """(fn, example_args): one progressive-render step on the Cornell box
    (triangle meshes, BVH, area light) through the plain integrator."""
    from .models.device_scene import DeviceScene
    from .ops.integrator import render_samples

    W, H = 160, 120
    device = _device(device)
    pack, cd = _load(CBOX, W, H, device)
    scene = DeviceScene.from_pack(pack).to(device)

    def fn(scene, cam_data, sample_start):
        return render_samples(scene, cam_data, W, H, sample_start,
                              num_samples=1, max_depth=8)

    return fn, (scene, cd, 0)


def _image_stats(img: torch.Tensor, label: str) -> dict:
    """Checks one sharded image: [H, W, 3], finite, not constant."""
    img = img.cpu().numpy()
    if img.shape != (DRY_H, DRY_W, 3) or not np.isfinite(img).all():
        raise RuntimeError(f"dry run {label}: image {img.shape} not finite")
    if not img.std() > 0.0:
        raise RuntimeError(f"dry run {label}: constant image")
    return {"mean": float(img.mean()), "std": float(img.std())}


def dryrun_rank(rank: int, world_size: int, device_type: str) -> dict:
    """One rank of the dry run (run by ``run_world``): image statistics by
    mode, the loss, and the scaling reports."""
    from .experiments.mx2set import MX2Set
    from .experiments.mxset import MXSet
    from .grad import inverse as inv
    from .models.bricks import BrickSet
    from .models.device_scene import DeviceScene
    from .parallel import sharding as sh

    sp = 2 if world_size % 2 == 0 else 1
    mesh = sh.make_mesh(sample_parallel=sp,
                        device="cpu" if device_type == "cpu" else None)
    W, H, SPP, B = DRY_W, DRY_H, DRY_SPP, DRY_BOUNCES
    pack, cd = _load(CBOX, W, H, mesh.device)
    scene_r = sh.replicate_scene(DeviceScene.from_pack(pack), mesh)
    out = {"device": str(mesh.device), "images": {}}

    # forward progressive step, then the training step (loss and grads
    # summed across the mesh)
    img = sh.render_samples_sharded(scene_r, cd, W, H, 0, SPP, mesh,
                                    max_depth=B)
    out["images"]["xla"] = _image_stats(img, "xla")
    params, _ = inv.split_params(scene_r)
    step = inv.make_sharded_loss_and_grad(mesh, W, H, SPP, num_bounces=B)
    pix_s, tgt_s, valid_s = inv.shard_grid_inputs(
        mesh, np.zeros((H, W, 3), np.float32))
    loss, grads = step(params, scene_r, cd, tgt_s, valid_s, pix_s, 0)
    if not (torch.isfinite(loss)
            and all(torch.isfinite(g).all() for g in grads.values())):
        raise RuntimeError("dry run: loss or gradients not finite")
    out["loss"] = float(loss)

    # the render paths with a kernel: the megakernel over pixel ranges,
    # the wave paths over blocks of the slot map
    img = sh.render_samples_sharded(scene_r, cd, W, H, 0, SPP, mesh,
                                    max_depth=B, mode="megakernel")
    out["images"]["megakernel"] = _image_stats(img, "megakernel")
    blob, blob_cd = _load(BLOB, W, H, mesh.device)
    sets = {"wavefront": BrickSet, "mx": MXSet, "mx2": MX2Set}
    sets = {mode: sh.replicate_scene(cls.from_pack(blob), mesh)
            for mode, cls in sets.items()}
    for mode, scene in sets.items():
        img = sh.render_samples_sharded(scene, blob_cd, W, H, 0, SPP, mesh,
                                        max_depth=B, mode=mode)
        out["images"][mode] = _image_stats(img, mode)

    out["reports"] = [
        sh.scaling_report(scene, cam, mesh, width=W, height=H,
                          num_samples=SPP, mode=mode, max_depth=B)
        for mode, scene, cam in [("xla", scene_r, cd),
                                 ("megakernel", scene_r, cd),
                                 *[(m, s, blob_cd) for m, s in sets.items()]]]
    return out


def dryrun_multichip(n_devices: int, device="cuda", backend=None) -> dict:
    """Run the full multi-device step in a world of ``n_devices`` ranks
    and print one ``{"scaling_report": ...}`` JSON line per mode.  Returns
    rank 0's results (``dryrun_rank``).  ``backend`` None takes ``nccl``
    when ``device`` is a card and the host has ``n_devices`` cards, else
    ``gloo``.  Raises when a rank fails or its images differ from rank
    0's."""
    from .parallel.world import run_world

    device = _device(device)
    if backend is None:
        backend = ("nccl" if device.type == "cuda"
                   and torch.cuda.device_count() >= n_devices else "gloo")
    with tempfile.TemporaryDirectory() as workdir:
        results = run_world(dryrun_rank, n_devices, workdir,
                            args=(device.type,), timeout=DRY_TIMEOUT_S,
                            backend=backend)
    first = results[0]
    for rank, res in enumerate(results):
        if res["images"] != first["images"]:
            raise RuntimeError(f"dry run: rank {rank}'s images differ from "
                               "rank 0's")
    devices = sorted({res["device"] for res in results})
    print(json.dumps({"dryrun": {"n_devices": n_devices, "backend": backend,
                                 "devices": devices, "loss": first["loss"],
                                 "images": first["images"]}}))
    if len(devices) < n_devices:
        print(json.dumps({"note": f"{n_devices} ranks share {devices}: "
                          "their speed-up measures time-slicing, not the "
                          "split"}))
    for rep in first["reports"]:
        print(json.dumps({"scaling_report": rep}))
    return first


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="torrey-torch-entry",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--dryrun", type=int, default=None, metavar="N",
                    help="run the multi-device dry run on N ranks (else one "
                         "step of entry())")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.dryrun:
        dryrun_multichip(args.dryrun, device=args.device)
    else:
        fn, fargs = entry(args.device)
        img = fn(*fargs)
        print(json.dumps({"entry": {"shape": list(img.shape),
                                    "mean": float(img.mean())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
