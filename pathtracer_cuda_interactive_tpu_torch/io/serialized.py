"""Mitsuba ``.serialized`` mesh loader.

TPU-native replacement for the reference's miniz-based
``parse_serialized.cpp`` (C10 in SURVEY.md).  Python's built-in ``zlib``
replaces the vendored miniz, and the per-float read loop becomes one
``np.frombuffer`` slice over the inflated blob.

Format (reference: parse_serialized.cpp:9-22, 104-122, 175-257):
  uint16 magic, uint16 version (V3=3, V4=4), then a zlib stream per shape;
  an offset table at the file end (uint64 offsets for V4, uint32 for V3,
  followed by a uint32 shape count) locates shape ``shape_index``.
  Inflated payload: uint32 flags, (V4: null-terminated name), uint64
  vertex_count, uint64 triangle_count, positions, then optional normals /
  uvs / colors per flags, then int32 face indices.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ..models.ir import ParsedTriangleMesh
from ..utils import math3d as m3

MTS_FILEFORMAT_VERSION_V3 = 0x0003
MTS_FILEFORMAT_VERSION_V4 = 0x0004

EHasNormals = 0x0001
EHasTexcoords = 0x0002
EHasTangents = 0x0004
EHasColors = 0x0008
EFaceNormals = 0x0010
ESinglePrecision = 0x1000
EDoublePrecision = 0x2000


class SerializedParseError(RuntimeError):
    pass


def parse_serialized(filename: str, shape_index: int = 0,
                     to_world: np.ndarray | None = None) -> ParsedTriangleMesh:
    if to_world is None:
        to_world = m3.identity()
    with open(filename, "rb") as f:
        data = f.read()

    if len(data) < 8:
        raise SerializedParseError("serialized file too small")
    version = struct.unpack_from("<H", data, 2)[0]

    # Locate the zlib stream for shape_index (reference skip_to_idx,
    # parse_serialized.cpp:104-122).
    offset = 4
    if shape_index > 0:
        (count,) = struct.unpack_from("<I", data, len(data) - 4)
        if version == MTS_FILEFORMAT_VERSION_V4:
            table_pos = len(data) - 8 * (count - shape_index) - 4
            (offset,) = struct.unpack_from("<Q", data, table_pos)
        else:
            table_pos = len(data) - 4 * (count - shape_index + 1)
            (offset,) = struct.unpack_from("<I", data, table_pos)
        offset += 4  # skip the per-shape uint16 magic + version header

    blob = zlib.decompressobj().decompress(data[offset:])

    pos = 0

    def take(n: int) -> bytes:
        nonlocal pos
        out = blob[pos:pos + n]
        if len(out) != n:
            raise SerializedParseError("serialized stream truncated")
        pos += n
        return out

    (flags,) = struct.unpack("<I", take(4))
    if version == MTS_FILEFORMAT_VERSION_V4:
        end = blob.index(b"\x00", pos)
        pos = end + 1
    (vertex_count,) = struct.unpack("<Q", take(8))
    (triangle_count,) = struct.unpack("<Q", take(8))

    fdt = np.dtype("<f8") if (flags & EDoublePrecision) else np.dtype("<f4")

    def read_floats(n: int) -> np.ndarray:
        return np.frombuffer(take(n * fdt.itemsize), dtype=fdt).astype(np.float64)

    positions = read_floats(vertex_count * 3).reshape(-1, 3)
    positions_w = m3.xform_point(to_world, positions)

    normals = None
    if flags & EHasNormals:
        n = read_floats(vertex_count * 3).reshape(-1, 3)
        normals = m3.xform_normal(m3.inverse(to_world), n)

    uvs = None
    if flags & EHasTexcoords:
        uvs = read_floats(vertex_count * 2).reshape(-1, 2).astype(np.float32)

    if flags & EHasColors:
        read_floats(vertex_count * 3)  # parsed and dropped, like the reference

    indices = np.frombuffer(take(triangle_count * 12), dtype="<i4")
    indices = indices.reshape(-1, 3).astype(np.int32)

    return ParsedTriangleMesh(
        positions=positions_w.astype(np.float32),
        indices=indices,
        normals=normals,
        uvs=uvs,
    )
