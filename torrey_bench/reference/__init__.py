"""The benchmark's plain reference: a frozen copy of the port's plain path
tracer in numpy and torch ops, with nothing of the port imported.

It parses the scene files itself (``xml_scene.py``, ``obj.py``), subdivides
(``subdivide.py``), packs and builds its own BVH (``scenepack.py``,
``bvh.py``, numpy only), and traces every path with the plain integrator
(``integrator.py``: brute force up to 512 primitives, the skip-link BVH walk
above), its RNG streams keyed by pixel and sample index as the reference
CUDA renderer's are.  ``tests/test_bench_imports.py`` holds it to importing
nothing of the port, of the JAX package or of JAX.
"""

from __future__ import annotations

from .camera import Camera, camera_ray_data
from .device_scene import DeviceScene
from .integrator import pixel_sample_sums
from .scenepack import pack_scene
from .subdivide import subdivide_scene
from .xml_scene import parse_scene

__all__ = ["Camera", "build_scene", "camera_ray_data", "pixel_sample_sums"]


def build_scene(xml_path: str, levels: int = 0):
    """(DeviceScene on the CPU, Camera, (width, height)) of a scene file,
    its meshes of 1,000 triangles or more subdivided ``levels`` times."""
    parsed = parse_scene(str(xml_path))
    if levels:
        parsed = subdivide_scene(parsed, levels=levels)
    return (DeviceScene.from_pack(pack_scene(parsed)),
            Camera.from_parsed(parsed.camera),
            (parsed.camera.width, parsed.camera.height))
