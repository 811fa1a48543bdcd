"""Parsed-scene intermediate representation.

TPU-native equivalent of the reference's ``Parsed*`` variant IR
(parse_scene.h:10-121 in jayHuggie/PathTracer_CUDA_Interactive).  The
reference uses ``std::variant`` tagged unions; here each entity is a plain
dataclass and the scene holds Python lists of them.  This IR is host-only —
it is flattened into SoA device arrays by
scenepack.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Union

import numpy as np


@dataclass
class ParsedCamera:
    """Reference: parse_scene.h:10-16."""
    lookfrom: np.ndarray  # [3]
    lookat: np.ndarray    # [3]
    up: np.ndarray        # [3]
    vfov: float           # vertical FOV in degrees (already fovAxis-converted)
    width: int
    height: int


@dataclass
class ImageTexture:
    """Reference: parse_scene.h ParsedImageTexture (parsed; bitmap lookup is a
    capability the reference parses but does not implement at render time —
    texture.h:18-56).  We store it so scenes parse, and resolve to the mean
    color if the image cannot be loaded."""
    filename: str
    uscale: float = 1.0
    vscale: float = 1.0
    uoffset: float = 0.0
    voffset: float = 0.0


Color = Union[np.ndarray, ImageTexture]  # constant RGB [3] or texture ref


@dataclass
class ParsedDiffuse:
    reflectance: Color


@dataclass
class ParsedMirror:
    reflectance: Color


@dataclass
class ParsedPlastic:
    eta: float
    reflectance: Color


@dataclass
class ParsedPhong:
    reflectance: Color
    exponent: float


@dataclass
class ParsedBlinnPhong:
    """Parsed for scene compatibility (parse_scene.cpp:531-543).  The
    reference silently *drops* blinn materials during Scene construction,
    which mis-aligns every following material id (scene.cpp:96-112, a known
    reference bug we do not replicate); we instead keep the slot and shade it
    as a Phong lobe of the same exponent."""
    reflectance: Color
    exponent: float


@dataclass
class ParsedBlinnPhongMicrofacet:
    reflectance: Color
    exponent: float


ParsedMaterial = Union[ParsedDiffuse, ParsedMirror, ParsedPlastic, ParsedPhong,
                       ParsedBlinnPhong, ParsedBlinnPhongMicrofacet]


@dataclass
class ParsedPointLight:
    """Reference: parse_scene.h:61-64.  NOTE: the reference GPU integrator
    never samples point lights (SURVEY.md §3.5); we keep them in the IR and
    expose an optional NEE path that can use them."""
    position: np.ndarray   # [3]
    intensity: np.ndarray  # [3]


@dataclass
class ParsedDiffuseAreaLight:
    """Reference: parse_scene.h:66-69."""
    shape_id: int
    radiance: np.ndarray  # [3]


ParsedLight = Union[ParsedPointLight, ParsedDiffuseAreaLight]


@dataclass
class ParsedSphere:
    material_id: int
    area_light_id: int
    center: np.ndarray  # [3]
    radius: float


@dataclass
class ParsedTriangleMesh:
    material_id: int = -1
    area_light_id: int = -1
    positions: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    indices: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.int32))
    normals: Optional[np.ndarray] = None  # [V,3] or None (face normals)
    uvs: Optional[np.ndarray] = None      # [V,2] or None


ParsedShape = Union[ParsedSphere, ParsedTriangleMesh]


@dataclass
class ParsedScene:
    """Reference: parse_scene.h:114-121."""
    camera: ParsedCamera
    materials: List[ParsedMaterial]
    lights: List[ParsedLight]
    shapes: List[ParsedShape]
    background_color: np.ndarray  # [3]
    samples_per_pixel: int

    @property
    def num_triangles(self) -> int:
        return sum(int(s.indices.shape[0]) for s in self.shapes
                   if isinstance(s, ParsedTriangleMesh))

    @property
    def num_spheres(self) -> int:
        return sum(1 for s in self.shapes if isinstance(s, ParsedSphere))
