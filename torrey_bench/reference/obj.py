"""Wavefront OBJ loader.

TPU-native replacement for the reference's ``parse_obj.cpp`` (C8 in
SURVEY.md).  Same capabilities: v/vt/vn/f records, ``v``, ``v/vt``,
``v//vn``, ``v/vt/vn`` face corners, 1-based and negative indices
(parse_obj.cpp:67-107), per-corner vertex deduplication (parse_obj.cpp:75-77),
quad → two triangles (parse_obj.cpp:180-194), n-gon rejection
(parse_obj.cpp:195-198), ``vt`` flipped to ``(s, 1-t)`` (parse_obj.cpp:135-138)
and the object-to-world transform applied at load time (positions via the
matrix, normals via its inverse-transpose — parse_obj.cpp:83, 98).
"""

from __future__ import annotations

import os

import numpy as np

from .ir import ParsedTriangleMesh
from . import math3d as m3


class ObjParseError(RuntimeError):
    pass


def _parse_corner(token: str) -> tuple:
    """Face-corner token 'v[/vt[/vn]]' -> (v, vt, vn), 0 meaning absent."""
    parts = token.split("/")
    v = int(parts[0]) if parts[0] else 0
    vt = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    vn = int(parts[2]) if len(parts) > 2 and parts[2] else 0
    return (v, vt, vn)


def parse_obj(filename: str, to_world: np.ndarray | None = None) -> ParsedTriangleMesh:
    if to_world is None:
        to_world = m3.identity()
    if not os.path.exists(filename):
        raise ObjParseError(f"Unable to open the obj file: {filename}")

    pos_pool: list = []
    st_pool: list = []
    nor_pool: list = []

    # First pass: collect pools and raw face corners.
    raw_faces: list = []  # each entry: list of corner tuples (3 or 4)
    with open(filename, "r", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line[0] == "#":
                continue
            parts = line.split()
            tok = parts[0]
            if tok == "v":
                x, y, z = float(parts[1]), float(parts[2]), float(parts[3])
                w = float(parts[4]) if len(parts) > 4 else 1.0
                pos_pool.append((x / w, y / w, z / w))
            elif tok == "vt":
                s = float(parts[1])
                t = float(parts[2]) if len(parts) > 2 else 0.0
                st_pool.append((s, 1.0 - t))
            elif tok == "vn":
                nor_pool.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif tok == "f":
                corners = [_parse_corner(p) for p in parts[1:]]
                if len(corners) > 4:
                    raise ObjParseError(
                        "The object file contains n-gon (n>4) that we do not support.")
                raw_faces.append(corners)

    pos_pool_np = np.asarray(pos_pool, dtype=np.float64).reshape(-1, 3)
    st_pool_np = np.asarray(st_pool, dtype=np.float64).reshape(-1, 2)
    nor_pool_np = np.asarray(nor_pool, dtype=np.float64).reshape(-1, 3)
    if len(nor_pool_np):
        nor_pool_np = m3.normalize(nor_pool_np, eps=1e-30)

    # Resolve negative/1-based indices and deduplicate (v, vt, vn) corners in
    # first-occurrence order, like the reference's std::map-based dedup.
    corner_map: dict = {}
    corner_list: list = []

    def corner_id(c: tuple) -> int:
        v, vt, vn = c
        v = v - 1 if v > 0 else len(pos_pool_np) + v
        vt = vt - 1 if vt > 0 else (len(st_pool_np) + vt if vt < 0 else -1)
        vn = vn - 1 if vn > 0 else (len(nor_pool_np) + vn if vn < 0 else -1)
        key = (v, vt, vn)
        idx = corner_map.get(key)
        if idx is None:
            idx = len(corner_list)
            corner_map[key] = idx
            corner_list.append(key)
        return idx

    tri_indices: list = []
    for corners in raw_faces:
        ids = [corner_id(c) for c in corners]
        tri_indices.append((ids[0], ids[1], ids[2]))
        if len(ids) == 4:
            tri_indices.append((ids[0], ids[2], ids[3]))

    keys = np.asarray(corner_list, dtype=np.int64).reshape(-1, 3)
    positions = m3.xform_point(to_world, pos_pool_np[keys[:, 0]]) if len(keys) \
        else np.zeros((0, 3), np.float32)

    uvs = None
    if len(st_pool_np) and len(keys) and np.all(keys[:, 1] >= 0):
        uvs = st_pool_np[keys[:, 1]].astype(np.float32)

    normals = None
    if len(nor_pool_np) and len(keys) and np.all(keys[:, 2] >= 0):
        inv = m3.inverse(to_world)
        normals = m3.xform_normal(inv, nor_pool_np[keys[:, 2]])

    return ParsedTriangleMesh(
        positions=np.asarray(positions, dtype=np.float32),
        indices=np.asarray(tri_indices, dtype=np.int32).reshape(-1, 3),
        normals=normals,
        uvs=uvs,
    )
