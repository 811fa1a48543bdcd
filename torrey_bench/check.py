"""What decides ``correct``: the timed path's accumulated image against the
plain reference, on a set of pixel tiles drawn from the seed.

Before the window the harness keeps the tiles' accumulated sums
(``Tiles.snapshot``); after it, what the window added to them is the sum of
every sample of the window's sample range, pixel by pixel.  The reference
(``reference/``) parses the scene files itself, builds its own tree and
traces the same (pixel, sample) paths on the same RNG streams.  Each tile
channel's difference of means is measured in units of the reference
mean's standard error (from the reference's own per-sample spread):

* ``z_rms``: the root mean square of these over the tiles;
* ``z_max``: the largest of them.

A sound program traces the same paths as the reference and departs from
them only where a float rounding sends one path elsewhere, so its numbers
stay near 0 whatever the sample count; a program that renders other paths
(a lower precision, a dropped or altered sample) reads as two independent
estimates, about 1 and more.  The limits are in the configuration's file,
set from sound runs and from the control (``calibrate.py``).
"""

from __future__ import annotations

import numpy as np

TILE = 4
# a floor under the standard error, as a share of the tiles' mean
# radiance: where the reference's samples do not spread (an unlit or
# always-lit pixel) a difference is measured against this
SE_FLOOR = 1e-5


def tile_pixels(seed: int, width: int, height: int, tiles: int) -> np.ndarray:
    """The flat pixel indices of ``tiles`` distinct TILE x TILE tiles drawn
    from ``seed``, in drawing order."""
    tx, ty = width // TILE, height // TILE
    tiles = max(1, min(tiles, tx * ty))
    rng = np.random.default_rng([seed & 0xFFFFFFFFFFFFFFFF, 0x7E57])
    picked = rng.choice(tx * ty, size=tiles, replace=False)
    dy, dx = np.meshgrid(np.arange(TILE), np.arange(TILE), indexing="ij")
    x = (picked % tx)[:, None] * TILE + dx.reshape(-1)[None]
    y = (picked // tx)[:, None] * TILE + dy.reshape(-1)[None]
    return (y * width + x).reshape(-1)


def tiles_for_budget(rays: float, samples: int, rays_per_sample: float,
                     width: int, height: int) -> int:
    """How many tiles the reference can trace within ``rays`` rays when
    every pixel takes ``samples`` samples."""
    per_tile = TILE * TILE * max(samples, 1) * rays_per_sample
    return int(max(1, min(rays // per_tile,
                          (width // TILE) * (height // TILE))))


def pick_tiles(cell, size: dict, samples: int, seed: int) -> np.ndarray:
    """The pixels a run compares: as many tiles as the configuration's ray
    budget (``check.rays``) allows at ``samples`` samples a pixel, drawn
    from ``seed``.  The reference's shadow rays, where it traces any, count
    against the budget beside its path rays."""
    fixed = cell.config["fixed_work"]
    tiles = tiles_for_budget(cell.config["check"]["rays"], samples,
                             fixed["rays_per_sample"]
                             + fixed.get("shadow_rays_per_sample", 0),
                             size["width"], size["height"])
    return tile_pixels(seed, size["width"], size["height"], tiles)


def gaps(prog_sum: np.ndarray, ref_sum: np.ndarray, ref_sq: np.ndarray,
         n: int) -> dict:
    """``z_rms`` and ``z_max`` of a program's per-pixel sums over ``n``
    samples against the reference's sums and sums of squares ([P, 3])."""
    ref_mean = ref_sum / n
    var = np.maximum(ref_sq / n - ref_mean * ref_mean, 0.0)
    se = np.sqrt(var / n)
    floor = SE_FLOOR * max(float(np.abs(ref_mean).mean()), 1e-12)
    z = (prog_sum / n - ref_mean) / np.maximum(se, floor)
    return {"z_rms": float(np.sqrt(np.mean(z * z))),
            "z_max": float(np.abs(z).max())}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number at or under its
    limit.  A number without a limit, or a non-finite one, fails."""
    rows = [(k, numbers[k], limits.get(k)) for k in sorted(numbers)]
    ok = all(lim is not None and np.isfinite(v) and v <= lim
             for _, v, lim in rows)
    return ok, rows


def reference_sums(cell, size: dict, pix: np.ndarray, first: int,
                   count: int, seed: int, device, camera=None,
                   store_dtype=None) -> tuple:
    """The reference's (sums, sums of squares) [P, 3] of samples ``first``
    .. ``first + count`` at flat pixels ``pix``: the scene parsed, built
    and traced by ``reference/`` alone, on ``device``.  ``camera``
    (lookfrom, lookat, up, vfov), where the motion moved it, else the
    scene file's; ``store_dtype`` rounds every path's state through that
    type after each bounce (the control)."""
    import torch

    from . import BENCH_DIR, reference
    scene, cam, _ = reference.build_scene(
        str(BENCH_DIR / cell.config["scene"]), size["subdivide_levels"])
    if camera is not None:
        cam = reference.Camera(*camera)
    cam_data = torch.as_tensor(
        reference.camera_ray_data(cam, size["width"], size["height"]),
        device=device)
    return reference.pixel_sample_sums(
        scene.to(device), cam_data, pix, size["width"], size["height"],
        first, count, seed, size["max_depth"], size["rr_start_depth"],
        nee=bool(cell.render_config.get("enable_nee", False)),
        store_dtype=store_dtype)
