"""Midpoint (1:4) triangle-mesh subdivision (host numpy).

The port of ``pathtracer_cuda_interactive_tpu/models/subdivide.py``,
unchanged.  It makes large scenes from small meshes: every triangle splits
into four at the edge midpoints, so three levels turn the 5,120-triangle
blob of ``scenes/blob_box.xml`` into 327,680 triangles (bunny scale) with
the same surface shape and materials.  chip_smoke.py renders that scene.
"""

from __future__ import annotations

import numpy as np

from .ir import ParsedScene, ParsedSphere, ParsedTriangleMesh


def subdivide_mesh(mesh: ParsedTriangleMesh,
                   levels: int = 1) -> ParsedTriangleMesh:
    """Split every triangle into 4 at edge midpoints, ``levels`` times.
    Midpoint vertices are deduplicated per edge; shading normals (if any)
    are midpoint-interpolated and renormalized, uvs midpoint-averaged."""
    pos = np.asarray(mesh.positions, np.float64)
    idx = np.asarray(mesh.indices, np.int64)
    nrm = None if mesh.normals is None else np.asarray(mesh.normals,
                                                       np.float64)
    uv = None if mesh.uvs is None else np.asarray(mesh.uvs, np.float64)

    for _ in range(levels):
        a, b, c = idx[:, 0], idx[:, 1], idx[:, 2]
        # unique undirected edges -> one midpoint vertex per edge
        e = np.concatenate([np.stack([a, b], 1), np.stack([b, c], 1),
                            np.stack([c, a], 1)])
        e.sort(axis=1)
        uniq, inv = np.unique(e, axis=0, return_inverse=True)
        mid_of = len(pos) + inv.reshape(3, -1)      # [3, F] midpoint ids
        mab, mbc, mca = mid_of

        mid_pos = 0.5 * (pos[uniq[:, 0]] + pos[uniq[:, 1]])
        pos = np.concatenate([pos, mid_pos])
        if nrm is not None:
            mn = nrm[uniq[:, 0]] + nrm[uniq[:, 1]]
            n = np.linalg.norm(mn, axis=1, keepdims=True)
            mn = np.where(n > 1e-12, mn / np.maximum(n, 1e-12), mn)
            nrm = np.concatenate([nrm, mn])
        if uv is not None:
            uv = np.concatenate([uv, 0.5 * (uv[uniq[:, 0]] + uv[uniq[:, 1]])])

        idx = np.concatenate([
            np.stack([a, mab, mca], 1),
            np.stack([mab, b, mbc], 1),
            np.stack([mca, mbc, c], 1),
            np.stack([mab, mbc, mca], 1)])

    return ParsedTriangleMesh(
        material_id=mesh.material_id,
        area_light_id=mesh.area_light_id,
        positions=pos.astype(np.float32),
        indices=idx.astype(np.int32),
        normals=None if nrm is None else nrm.astype(np.float32),
        uvs=None if uv is None else uv.astype(np.float32))


def subdivide_scene(parsed: ParsedScene, levels: int = 1,
                    min_tris: int = 1000) -> ParsedScene:
    """Subdivide every triangle mesh with >= ``min_tris`` triangles (small
    meshes like ground planes keep their shape exactly anyway but stay
    cheap)."""
    shapes = []
    for s in parsed.shapes:
        if (isinstance(s, ParsedTriangleMesh)
                and s.indices.shape[0] >= min_tris):
            shapes.append(subdivide_mesh(s, levels))
        else:
            shapes.append(s)
    return ParsedScene(camera=parsed.camera, materials=parsed.materials,
                       lights=parsed.lights, shapes=shapes,
                       background_color=parsed.background_color,
                       samples_per_pixel=parsed.samples_per_pixel)


def table_scenes(parsed: ParsedScene) -> dict:
    """Two larger primitive tables from a small all-triangle scene (the rect
    Cornell box, 32 triangles), for the megakernel's cases above one
    primitive a lane: ``mixed`` is every mesh subdivided once (128
    triangles) with 42 small spheres on a 7 x 6 grid in the middle of the
    scene's box, their materials taken in turn from the scene's (spheres
    and triangles in one table, more than 32 of each), and ``full`` every
    mesh subdivided twice (512 triangles, the megakernel's limit)."""
    once = subdivide_scene(parsed, levels=1, min_tris=1)
    pos = np.concatenate([s.positions for s in parsed.shapes
                          if isinstance(s, ParsedTriangleMesh)])
    lo, hi = pos.min(0), pos.max(0)
    size = hi - lo
    spheres = [
        ParsedSphere(material_id=(i + j) % len(parsed.materials),
                     area_light_id=-1,
                     center=(lo + size * np.array([(i + 1) / 8.0,
                                                   (j + 1) / 7.0,
                                                   0.3 + 0.05 * ((i + j) % 5)])
                             ).astype(np.float32),
                     radius=float(0.04 * size.min()))
        for i in range(7) for j in range(6)]
    mixed = ParsedScene(camera=once.camera, materials=once.materials,
                        lights=once.lights, shapes=once.shapes + spheres,
                        background_color=once.background_color,
                        samples_per_pixel=once.samples_per_pixel)
    return {"mixed": mixed,
            "full": subdivide_scene(parsed, levels=2, min_tris=1)}
