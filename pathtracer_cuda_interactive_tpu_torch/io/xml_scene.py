"""Mitsuba-0.6-style XML scene parser.

TPU-native replacement for the reference's pugixml-based
``parse_scene.cpp`` (C7 in SURVEY.md), using Python's ``xml.etree``.
Capability-par semantics, with file:line citations to
jayHuggie/PathTracer_CUDA_Interactive:

* ``<default name=.. value=..>`` with ``$var`` substitution
  (parse_scene.cpp:63-137, 812-815)
* sRGB decode incl. ``#rrggbb`` hex (parse_scene.cpp:31-38, 139-163)
* ``<transform>`` stacks: scale/translate/rotate/lookat/matrix
  (parse_scene.cpp:189-265); matrices compose left-multiplied
* ``<sensor>`` + ``<film>`` + ``<sampler>`` with fovAxis
  x/y/diagonal/smaller/larger conversion to vertical FOV
  (parse_scene.cpp:305-384)
* ``<texture type="bitmap">`` ids (parse_scene.cpp:386-426)
* ``<bsdf>``: diffuse/mirror/plastic/phong/blinn(+microfacet)/twosided
  (parse_scene.cpp:468-561)
* ``<emitter type="point">`` (parse_scene.cpp:563-589)
* ``<shape>``: obj/ply/serialized/sphere/rectangle, rectangle expanded to a
  2-triangle mesh, nested ``<emitter type="area">`` attaching a
  DiffuseAreaLight (parse_scene.cpp:591-790)
* asset paths resolved relative to the scene file's directory (the reference
  chdir's during parsing, parse_scene.cpp:862-877; we resolve explicitly)

Defaults match the reference: fov 45, 256x256 film, 16 spp, 0.5-gray
background (parse_scene.cpp:13-15, 806-810).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Tuple

import numpy as np

from ..models.ir import (Color, ImageTexture, ParsedBlinnPhong,
                         ParsedBlinnPhongMicrofacet, ParsedCamera,
                         ParsedDiffuse, ParsedDiffuseAreaLight, ParsedMirror,
                         ParsedPhong, ParsedPlastic, ParsedPointLight,
                         ParsedScene, ParsedSphere, ParsedTriangleMesh)
from ..utils import math3d as m3
from ..utils.trace import setup_span
from .obj import parse_obj
from .ply import parse_ply
from .serialized import parse_serialized

C_DEFAULT_FOV = 45.0
C_DEFAULT_RES = 256
C_DEFAULT_BACKGROUND = np.array([0.5, 0.5, 0.5], np.float32)
C_DEFAULT_SPP = 16


class SceneParseError(RuntimeError):
    pass


def _sub_default(value: str, defaults: Dict[str, str]) -> str:
    if value and value[0] == "$":
        key = value[1:]
        if key not in defaults:
            raise SceneParseError(
                f"Reference default variable ${key} not found.")
        return defaults[key]
    return value


def _parse_float(value: str, defaults) -> float:
    return float(_sub_default(value, defaults))


def _parse_int(value: str, defaults) -> int:
    return int(_sub_default(value, defaults))


def _parse_bool(value: str, defaults) -> bool:
    v = _sub_default(value, defaults)
    if v == "true":
        return True
    if v == "false":
        return False
    raise SceneParseError(f"parse_boolean failed: {v}")


def _parse_vec3(value: str, defaults) -> np.ndarray:
    value = _sub_default(value, defaults)
    import re
    parts = [p for p in re.split(r"[, ]+", value.strip()) if p]
    if len(parts) == 1:
        x = float(parts[0])
        return np.array([x, x, x], np.float32)
    if len(parts) == 3:
        return np.array([float(p) for p in parts], np.float32)
    raise SceneParseError(f"parse_vector3 failed: {value!r}")


def _parse_srgb(value: str, defaults) -> np.ndarray:
    value = _sub_default(value, defaults)
    if len(value) == 7 and value[0] == "#":
        encoded = int(value[1:], 16)
        srgb = np.array([(encoded >> 16) & 0xFF, (encoded >> 8) & 0xFF,
                         encoded & 0xFF], np.float64) / 255.0
        return srgb.astype(np.float32)
    raise SceneParseError(f"Unknown SRGB format: {value}")


def _parse_matrix(value: str, defaults) -> np.ndarray:
    import re
    value = _sub_default(value, defaults)
    parts = [p for p in re.split(r"[, ]+", value.strip()) if p]
    if len(parts) != 16:
        raise SceneParseError("parse_matrix4x4 failed")
    return np.array([float(p) for p in parts], np.float64).reshape(4, 4)


def _parse_transform(node: ET.Element, defaults) -> np.ndarray:
    """Accumulate child transforms, each left-multiplied onto the stack
    (reference: parse_scene.cpp:189-265)."""
    tform = m3.identity()
    for child in node:
        name = child.tag.lower()
        if name == "scale":
            x = y = z = 1.0
            if child.get("x") is not None:
                x = _parse_float(child.get("x"), defaults)
            if child.get("y") is not None:
                y = _parse_float(child.get("y"), defaults)
            if child.get("z") is not None:
                z = _parse_float(child.get("z"), defaults)
            if child.get("value") is not None:
                x, y, z = _parse_vec3(child.get("value"), defaults)
            tform = m3.scale((x, y, z)) @ tform
        elif name == "translate":
            x = y = z = 0.0
            if child.get("x") is not None:
                x = _parse_float(child.get("x"), defaults)
            if child.get("y") is not None:
                y = _parse_float(child.get("y"), defaults)
            if child.get("z") is not None:
                z = _parse_float(child.get("z"), defaults)
            if child.get("value") is not None:
                x, y, z = _parse_vec3(child.get("value"), defaults)
            tform = m3.translate((x, y, z)) @ tform
        elif name == "rotate":
            x = y = z = 0.0
            angle = 0.0
            if child.get("x") is not None:
                x = _parse_float(child.get("x"), defaults)
            if child.get("y") is not None:
                y = _parse_float(child.get("y"), defaults)
            if child.get("z") is not None:
                z = _parse_float(child.get("z"), defaults)
            if child.get("angle") is not None:
                angle = _parse_float(child.get("angle"), defaults)
            tform = m3.rotate(angle, (x, y, z)) @ tform
        elif name == "lookat":
            pos = _parse_vec3(child.get("origin"), defaults)
            target = _parse_vec3(child.get("target"), defaults)
            up = _parse_vec3(child.get("up"), defaults)
            tform = m3.look_at(pos, target, up) @ tform
        elif name == "matrix":
            tform = _parse_matrix(child.get("value"), defaults) @ tform
    return tform


def _parse_texture(node: ET.Element, defaults, base_dir: str) -> Color:
    ttype = node.get("type")
    if ttype == "bitmap":
        filename = ""
        uscale = vscale = 1.0
        uoffset = voffset = 0.0
        for child in node:
            name = child.get("name")
            if name == "filename":
                filename = _sub_default(child.get("value"), defaults)
            elif name == "uvscale":
                uscale = vscale = _parse_float(child.get("value"), defaults)
            elif name == "uscale":
                uscale = _parse_float(child.get("value"), defaults)
            elif name == "vscale":
                vscale = _parse_float(child.get("value"), defaults)
            elif name == "uoffset":
                uoffset = _parse_float(child.get("value"), defaults)
            elif name == "voffset":
                voffset = _parse_float(child.get("value"), defaults)
        path = filename if os.path.isabs(filename) else os.path.join(base_dir, filename)
        return ImageTexture(path, uscale, vscale, uoffset, voffset)
    raise SceneParseError(f"Unknown texture type: {ttype}")


def _parse_color(node: ET.Element, texture_map, defaults, base_dir) -> Color:
    tag = node.tag
    if tag == "rgb":
        return _parse_vec3(node.get("value"), defaults)
    if tag == "srgb":
        return m3.srgb_to_rgb(_parse_srgb(node.get("value"), defaults))
    if tag == "ref":
        ref_id = node.get("id")
        if ref_id not in texture_map:
            raise SceneParseError(f"Texture not found. ID = {ref_id}")
        return texture_map[ref_id]
    if tag == "texture":
        return _parse_texture(node, defaults, base_dir)
    raise SceneParseError(f"Unknown spectrum texture type: {tag}")


def _parse_intensity(node: ET.Element, defaults) -> np.ndarray:
    if node.tag == "rgb":
        return _parse_vec3(node.get("value"), defaults)
    if node.tag == "srgb":
        return m3.srgb_to_rgb(_parse_srgb(node.get("value"), defaults))
    return np.array([1.0, 1.0, 1.0], np.float32)


def _parse_bsdf(node: ET.Element, texture_map, defaults, base_dir,
                parent_id: str = "") -> Tuple[str, object]:
    """Reference: parse_scene.cpp:468-561."""
    btype = node.get("type")
    bid = node.get("id") or parent_id

    if btype == "twosided":
        # All our BSDFs are two-sided already (radiance.cuh:45-47 flips the
        # shading normal toward the ray) — unwrap the inner bsdf.
        for child in node:
            if child.tag == "bsdf":
                return _parse_bsdf(child, texture_map, defaults, base_dir, bid)
        raise SceneParseError("twosided bsdf without inner bsdf")

    def get_color(name: str, default: np.ndarray) -> Color:
        out: Color = default
        for child in node:
            if child.get("name") == name:
                out = _parse_color(child, texture_map, defaults, base_dir)
        return out

    def get_float(names: Tuple[str, ...], default: float) -> float:
        out = default
        for child in node:
            if child.get("name") in names:
                out = _parse_float(child.get("value"), defaults)
        return out

    gray = np.array([0.5, 0.5, 0.5], np.float32)
    if btype == "diffuse":
        return bid, ParsedDiffuse(get_color("reflectance", gray))
    if btype == "mirror":
        white = np.array([1.0, 1.0, 1.0], np.float32)
        return bid, ParsedMirror(get_color("reflectance", white))
    if btype == "plastic":
        return bid, ParsedPlastic(get_float(("ior", "eta"), 1.5),
                                  get_color("reflectance", gray))
    if btype == "phong":
        return bid, ParsedPhong(get_color("reflectance", gray),
                                get_float(("exponent", "alpha"), 5.0))
    if btype in ("blinn", "blinnphong"):
        return bid, ParsedBlinnPhong(get_color("reflectance", gray),
                                     get_float(("exponent", "alpha"), 5.0))
    if btype in ("blinn_microfacet", "blinnphong_microfacet"):
        return bid, ParsedBlinnPhongMicrofacet(get_color("reflectance", gray),
                                               get_float(("exponent", "alpha"), 5.0))
    raise SceneParseError(f"Unknown BSDF: {btype}")


def _parse_emitter(node: ET.Element, defaults) -> ParsedPointLight:
    """Reference: parse_scene.cpp:563-589."""
    etype = node.get("type")
    if etype != "point":
        raise SceneParseError(f"Unknown emitter: {etype}")
    position = np.zeros(3, np.float32)
    intensity = np.ones(3, np.float32)
    for child in node:
        name = child.get("name")
        if name == "position":
            for i, axis in enumerate("xyz"):
                if child.get(axis) is not None:
                    position[i] = _parse_float(child.get(axis), defaults)
        elif name == "intensity":
            intensity = _parse_intensity(child, defaults)
    return ParsedPointLight(position, intensity)


def _parse_sensor(node: ET.Element, defaults) -> Tuple[ParsedCamera, str, int]:
    """Reference: parse_scene.cpp:305-384, incl. fovAxis → vertical FOV."""
    lookfrom = np.array([0, 0, 0], np.float32)
    lookat = np.array([0, 0, -1], np.float32)
    up = np.array([0, 1, 0], np.float32)
    fov = C_DEFAULT_FOV
    width = height = C_DEFAULT_RES
    filename = "image.exr"
    fov_axis = "x"
    sample_count = C_DEFAULT_SPP

    stype = node.get("type")
    if stype != "perspective":
        raise SceneParseError(f"Unsupported sensor: {stype}")

    for child in node:
        name = child.get("name")
        if name == "fov":
            fov = _parse_float(child.get("value"), defaults)
        elif name in ("toWorld", "to_world"):
            for grand in child:
                if grand.tag.lower() == "lookat":
                    lookfrom = _parse_vec3(grand.get("origin"), defaults)
                    lookat = _parse_vec3(grand.get("target"), defaults)
                    up = _parse_vec3(grand.get("up"), defaults)
                else:
                    raise SceneParseError(
                        "Only support LookAt transform in a sensor.")
        elif name in ("fovAxis", "fov_axis"):
            fov_axis = child.get("value")
            if fov_axis not in ("x", "y", "diagonal", "smaller", "larger"):
                raise SceneParseError(f"Unknown fovAxis value: {fov_axis}")

    for child in node:
        if child.tag == "film":
            for grand in child:
                name = grand.get("name")
                if name == "width":
                    width = _parse_int(grand.get("value"), defaults)
                elif name == "height":
                    height = _parse_int(grand.get("value"), defaults)
                elif name == "filename":
                    filename = _sub_default(grand.get("value"), defaults)
        elif child.tag == "sampler":
            for grand in child:
                if grand.get("name") in ("sampleCount", "sample_count"):
                    sample_count = _parse_int(grand.get("value"), defaults)

    # Convert to vertical FOV (parse_scene.cpp:364-375).
    if (fov_axis == "x" or (fov_axis == "smaller" and width < height)
            or (fov_axis == "larger" and height < width)):
        fov = float(m3.degrees(
            2 * np.arctan(np.tan(m3.radians(fov) / 2) * height / width)))
    elif fov_axis == "diagonal":
        aspect = height / width
        diagonal = 2 * np.tan(m3.radians(fov) / 2)
        h = diagonal / np.sqrt(1 + 1 / (aspect * aspect))
        fov = float(m3.degrees(2 * np.arctan(h / 2)))

    camera = ParsedCamera(lookfrom, lookat, up, fov, width, height)
    return camera, filename, sample_count


def _parse_shape(node: ET.Element, materials: List, material_map: Dict,
                 texture_map: Dict, lights: List, shapes: List,
                 defaults: Dict, base_dir: str):
    """Reference: parse_scene.cpp:591-790."""
    material_id = -1
    for child in node:
        if child.tag == "ref":
            ref_id = child.get("id")
            if ref_id is None:
                raise SceneParseError("Material reference id not specified.")
            if ref_id not in material_map:
                raise SceneParseError(
                    f"Material reference {ref_id} not found.")
            material_id = material_map[ref_id]
        elif child.tag == "bsdf":
            mat_name, mat = _parse_bsdf(child, texture_map, defaults, base_dir)
            if mat_name:
                material_map[mat_name] = len(materials)
            material_id = len(materials)
            materials.append(mat)

    stype = node.get("type")

    def get_common():
        filename = ""
        to_world = m3.identity()
        face_normals = False
        shape_index = 0
        for child in node:
            name = child.get("name")
            if name == "filename":
                filename = _sub_default(child.get("value"), defaults)
            elif name in ("toWorld", "to_world") and child.tag == "transform":
                to_world = _parse_transform(child, defaults)
            elif name in ("faceNormals", "face_normals"):
                face_normals = _parse_bool(child.get("value"), defaults)
            elif name in ("shapeIndex", "shape_index"):
                shape_index = _parse_int(child.get("value"), defaults)
        path = filename if os.path.isabs(filename) else os.path.join(base_dir, filename)
        return path, to_world, face_normals, shape_index

    if stype in ("obj", "ply", "serialized"):
        path, to_world, face_normals, shape_index = get_common()
        if stype == "obj":
            mesh = parse_obj(path, to_world)
        elif stype == "ply":
            mesh = parse_ply(path, to_world)
        else:
            mesh = parse_serialized(path, shape_index, to_world)
        if face_normals:
            mesh.normals = None
        elif mesh.normals is None or len(mesh.normals) == 0:
            mesh.normals = m3.compute_vertex_normals(mesh.positions, mesh.indices)
        shape = mesh
    elif stype == "sphere":
        center = np.zeros(3, np.float32)
        radius = 1.0
        for child in node:
            name = child.get("name")
            if name == "center":
                center = np.array([
                    _parse_float(child.get("x"), defaults),
                    _parse_float(child.get("y"), defaults),
                    _parse_float(child.get("z"), defaults)], np.float32)
            elif name == "radius":
                radius = _parse_float(child.get("value"), defaults)
        shape = ParsedSphere(-1, -1, center, radius)
    elif stype == "rectangle":
        # Built-in unit quad at z=0, expanded to 2 triangles
        # (parse_scene.cpp:728-766).
        to_world = m3.identity()
        flip_normals = False
        for child in node:
            name = child.get("name")
            if name in ("toWorld", "to_world") and child.tag == "transform":
                to_world = _parse_transform(child, defaults)
            elif name in ("flipNormals", "flip_normals"):
                flip_normals = _parse_bool(child.get("value"), defaults)
        positions = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                             np.float64)
        normals = np.tile(np.array([0.0, 0.0, -1.0 if flip_normals else 1.0]),
                          (4, 1))
        shape = ParsedTriangleMesh(
            positions=m3.xform_point(to_world, positions),
            indices=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
            normals=m3.xform_normal(m3.inverse(to_world), normals),
            uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
        )
    else:
        raise SceneParseError(f"Unknown shape: {stype}")

    shape.material_id = material_id

    # Nested area emitter (parse_scene.cpp:773-787).
    for child in node:
        if child.tag == "emitter":
            radiance = np.ones(3, np.float32)
            for grand in child:
                if grand.get("name") == "radiance":
                    radiance = _parse_intensity(grand, defaults)
            shape.area_light_id = len(lights)
            lights.append(ParsedDiffuseAreaLight(len(shapes), radiance))

    return shape


@setup_span("setup.parse")
def parse_scene(filename: str) -> ParsedScene:
    """Parse a Mitsuba-0.6 scene XML file (reference: parse_scene.cpp:862-877)."""
    tree = ET.parse(filename)
    root = tree.getroot()
    if root.tag != "scene":
        root = root.find("scene")
        if root is None:
            raise SceneParseError("no <scene> element")
    base_dir = os.path.dirname(os.path.abspath(filename))

    camera = ParsedCamera(
        np.array([0, 0, 0], np.float32), np.array([0, 0, -1], np.float32),
        np.array([0, 1, 0], np.float32), C_DEFAULT_FOV,
        C_DEFAULT_RES, C_DEFAULT_RES)
    materials: List = []
    lights: List = []
    shapes: List = []
    defaults: Dict[str, str] = {}
    texture_map: Dict[str, Color] = {}
    material_map: Dict[str, int] = {}
    background = C_DEFAULT_BACKGROUND.copy()
    sample_count = C_DEFAULT_SPP

    for child in root:
        tag = child.tag
        if tag == "default":
            if child.get("name") is not None and child.get("value") is not None:
                defaults[child.get("name")] = child.get("value")
        elif tag == "sensor":
            camera, _filename, sample_count = _parse_sensor(child, defaults)
        elif tag == "bsdf":
            mat_name, mat = _parse_bsdf(child, texture_map, defaults, base_dir)
            if mat_name:
                material_map[mat_name] = len(materials)
                materials.append(mat)
        elif tag == "emitter":
            lights.append(_parse_emitter(child, defaults))
        elif tag == "shape":
            shapes.append(_parse_shape(child, materials, material_map,
                                       texture_map, lights, shapes,
                                       defaults, base_dir))
        elif tag == "texture":
            tid = child.get("id")
            if tid in texture_map:
                raise SceneParseError(f"Duplicated texture ID: {tid}")
            texture_map[tid] = _parse_texture(child, defaults, base_dir)
        elif tag == "background":
            for grand in child:
                if grand.get("name") == "radiance":
                    background = _parse_intensity(grand, defaults)

    return ParsedScene(camera, materials, lights, shapes,
                       np.asarray(background, np.float32), sample_count)
