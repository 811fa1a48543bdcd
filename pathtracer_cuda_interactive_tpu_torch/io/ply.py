"""PLY mesh loader (numpy-vectorized).

TPU-native replacement for the reference's tinyply-based ``parse_ply.cpp``
(C9 in SURVEY.md).  Capabilities matched: ascii / binary little- and
big-endian, float32/float64 vertex attributes, positions required with
optional per-vertex normals (nx/ny/nz) and uvs (u/v or s/t)
(parse_ply.cpp:15-34), index lists of any of int8..uint32 with any count
type (parse_ply.cpp:40-120), fan-triangulation of >3-gons, and the
to-world transform applied at load (positions by the matrix, normals by its
inverse-transpose).
"""

from __future__ import annotations

import numpy as np

from ..models.ir import ParsedTriangleMesh
from ..utils import math3d as m3


class PlyParseError(RuntimeError):
    pass


_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def _read_header(data: bytes):
    end = data.find(b"end_header")
    if end < 0:
        raise PlyParseError("PLY: no end_header")
    end = data.find(b"\n", end) + 1
    header = data[:end].decode("ascii", errors="replace")
    lines = [l.strip() for l in header.splitlines() if l.strip()]
    if not lines or lines[0] != "ply":
        raise PlyParseError("not a PLY file")
    fmt = None
    elements = []  # (name, count, [(prop_kind, dtype(s), name)])
    for line in lines[1:]:
        parts = line.split()
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "comment" or parts[0] == "obj_info":
            continue
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if not elements:
                raise PlyParseError("property before element")
            if parts[1] == "list":
                elements[-1][2].append(("list", (parts[2], parts[3]), parts[4]))
            else:
                elements[-1][2].append(("scalar", parts[1], parts[2]))
        elif parts[0] == "end_header":
            break
    return fmt, elements, end


def parse_ply(filename: str, to_world: np.ndarray | None = None) -> ParsedTriangleMesh:
    if to_world is None:
        to_world = m3.identity()
    with open(filename, "rb") as f:
        data = f.read()
    fmt, elements, body_off = _read_header(data)

    if fmt == "ascii":
        vertex_data, face_indices = _parse_ascii_body(data[body_off:], elements)
    else:
        bo = "<" if fmt == "binary_little_endian" else ">"
        vertex_data, face_indices = _parse_binary_body(data[body_off:], elements, bo)

    if "x" not in vertex_data:
        raise PlyParseError("PLY: vertex positions are required")

    positions = np.stack([vertex_data["x"], vertex_data["y"], vertex_data["z"]],
                         axis=-1).astype(np.float64)
    positions_w = m3.xform_point(to_world, positions)

    normals = None
    if "nx" in vertex_data:
        n = np.stack([vertex_data["nx"], vertex_data["ny"], vertex_data["nz"]],
                     axis=-1).astype(np.float64)
        normals = m3.xform_normal(m3.inverse(to_world), n)

    uvs = None
    for u_name, v_name in (("u", "v"), ("s", "t")):
        if u_name in vertex_data and v_name in vertex_data:
            uvs = np.stack([vertex_data[u_name], vertex_data[v_name]],
                           axis=-1).astype(np.float32)
            break

    return ParsedTriangleMesh(
        positions=positions_w.astype(np.float32),
        indices=face_indices.astype(np.int32),
        normals=normals,
        uvs=uvs,
    )


def _vertex_struct_dtype(props, bo):
    fields = []
    for kind, dt, name in props:
        if kind != "scalar":
            raise PlyParseError("list property on vertex element unsupported")
        fields.append((name, bo + _PLY_DTYPES[dt]))
    return np.dtype(fields)


def _parse_binary_body(body: bytes, elements, bo):
    vertex_data = {}
    face_indices = None
    off = 0
    for name, count, props in elements:
        if name == "vertex":
            dt = _vertex_struct_dtype(props, bo)
            arr = np.frombuffer(body, dtype=dt, count=count, offset=off)
            off += dt.itemsize * count
            for pname in dt.names:
                vertex_data[pname] = arr[pname]
        elif name == "face":
            face_indices, off = _parse_binary_faces(body, off, count, props, bo)
        else:
            # Skip unknown fixed-size elements; bail on lists we can't size.
            fixed = all(k == "scalar" for k, _, _ in props)
            if not fixed:
                raise PlyParseError(f"cannot skip element '{name}' with list props")
            dt = _vertex_struct_dtype(props, bo)
            off += dt.itemsize * count
    if face_indices is None:
        face_indices = np.zeros((0, 3), np.int64)
    return vertex_data, face_indices


def _parse_binary_faces(body, off, count, props, bo):
    list_props = [(i, p) for i, p in enumerate(props) if p[0] == "list"]
    if len(props) != 1 or len(list_props) != 1:
        raise PlyParseError("face element must be a single index list")
    _, (count_t, index_t), _ = props[0]
    cdt = np.dtype(bo + _PLY_DTYPES[count_t])
    idt = np.dtype(bo + _PLY_DTYPES[index_t])

    # Fast path: probe the first face's count; if every face is a triangle the
    # whole block has a fixed stride and parses in one frombuffer.
    first_n = int(np.frombuffer(body, dtype=cdt, count=1, offset=off)[0])
    stride = cdt.itemsize + first_n * idt.itemsize
    if off + stride * count <= len(body):
        block = np.frombuffer(body, dtype=np.uint8, count=stride * count,
                              offset=off).reshape(count, stride)
        counts = block[:, :cdt.itemsize].copy().view(cdt).reshape(count)
        if np.all(counts == first_n):
            idx = block[:, cdt.itemsize:].copy().view(idt).reshape(count, first_n)
            idx = idx.astype(np.int64)
            if first_n == 3:
                return idx, off + stride * count
            # fan-triangulate fixed n-gons
            tris = [np.stack([idx[:, 0], idx[:, k], idx[:, k + 1]], axis=-1)
                    for k in range(1, first_n - 1)]
            return np.concatenate(tris, axis=0), off + stride * count

    # General path: variable-size lists.
    tris = []
    pos = off
    for _ in range(count):
        n = int(np.frombuffer(body, dtype=cdt, count=1, offset=pos)[0])
        pos += cdt.itemsize
        idx = np.frombuffer(body, dtype=idt, count=n, offset=pos).astype(np.int64)
        pos += n * idt.itemsize
        for k in range(1, n - 1):
            tris.append((idx[0], idx[k], idx[k + 1]))
    return np.asarray(tris, dtype=np.int64).reshape(-1, 3), pos


def _parse_ascii_body(body: bytes, elements):
    lines = body.decode("ascii", errors="replace").splitlines()
    li = 0
    vertex_data = {}
    face_indices = np.zeros((0, 3), np.int64)
    for name, count, props in elements:
        chunk = [lines[li + k].split() for k in range(count)]
        li += count
        if name == "vertex":
            arr = np.asarray(chunk, dtype=np.float64)
            for i, (_, _, pname) in enumerate(props):
                vertex_data[pname] = arr[:, i]
        elif name == "face":
            tris = []
            for row in chunk:
                n = int(row[0])
                idx = [int(x) for x in row[1:1 + n]]
                for k in range(1, n - 1):
                    tris.append((idx[0], idx[k], idx[k + 1]))
            face_indices = np.asarray(tris, dtype=np.int64).reshape(-1, 3)
    return vertex_data, face_indices
