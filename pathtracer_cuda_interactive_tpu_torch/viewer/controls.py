"""Camera interaction controller — the ImGui/GLFW input layer rebuilt.

The port of ``pathtracer_cuda_interactive_tpu/viewer/controls.py``: plain
Python on the port's ``Camera`` and ``RenderConfig``.  A host-side state
machine with the exact semantics of the reference's
`imgui_manager.cpp` handlers, decoupled from any windowing toolkit so the
web viewer (viewer/server.py), tests and future frontends share it:

  * WASD fly (imgui_manager.cpp:138-193): move ``lookfrom`` along the view
    front/right by ``move_speed``; ``lookat`` snaps to lookfrom + front
    (unit distance) after every move.
  * Orbit drag (imgui_manager.cpp:195-287): on press, capture the current
    lookat, camera distance, and yaw/pitch of the view direction; on drag,
    yaw += dx*sensitivity, pitch += -dy*sensitivity clamped to +/-89 deg;
    lookfrom = captured_lookat - dir(yaw, pitch) * distance.
  * R / Reset button (imgui_manager.cpp:289-307): restore the initial
    camera.
  * FOV slider 10..120, samples-per-frame slider 1..10
    (imgui_manager.cpp:101-105).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from ..ops.camera import Camera
from ..utils.config import RenderConfig


def _norm(v):
    n = math.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    n = n if n > 0 else 1.0
    return (v[0] / n, v[1] / n, v[2] / n)


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _madd(a, b, s):
    return (a[0] + b[0] * s, a[1] + b[1] * s, a[2] + b[2] * s)


@dataclass
class CameraController:
    """Mutates a Camera in response to UI events; the renderer polls
    ``camera`` and applies its epsilon-compare reset logic."""

    initial: Camera
    config: RenderConfig = field(default_factory=RenderConfig)

    def __post_init__(self):
        self.camera = self.initial
        self._dragging = False
        self._yaw = 0.0
        self._pitch = 0.0
        self._orbit_lookat = self.initial.lookat
        self._orbit_dist = 1.0
        self._last_xy: Optional[tuple] = None

    # -- WASD fly ---------------------------------------------------------
    def fly(self, forward: float = 0.0, strafe: float = 0.0) -> None:
        """forward/strafe in key-press units (+1 W / -1 S, +1 D / -1 A)."""
        cam = self.camera
        front = _norm(_sub(cam.lookat, cam.lookfrom))
        right = _norm(_cross(front, cam.up))
        speed = self.config.move_speed
        lookfrom = _madd(cam.lookfrom, front, forward * speed)
        lookfrom = _madd(lookfrom, right, strafe * speed)
        # lookat rides one unit ahead (imgui_manager.cpp:180)
        lookat = _madd(lookfrom, front, 1.0)
        self.camera = Camera(lookfrom, lookat, cam.up, cam.vfov)

    # -- orbit drag -------------------------------------------------------
    def orbit_begin(self, x: float, y: float) -> None:
        cam = self.camera
        self._dragging = True
        self._last_xy = (x, y)
        self._orbit_lookat = cam.lookat
        self._orbit_dist = math.dist(cam.lookfrom, cam.lookat)
        d = _norm(_sub(cam.lookat, cam.lookfrom))
        self._pitch = math.degrees(math.asin(max(-1.0, min(1.0, d[1]))))
        self._yaw = math.degrees(math.atan2(d[2], d[0]))

    def orbit_drag(self, x: float, y: float) -> None:
        if not self._dragging:
            return
        lx, ly = self._last_xy
        self._last_xy = (x, y)
        sens = self.config.mouse_sensitivity
        self._yaw += (x - lx) * sens
        self._pitch += (ly - y) * sens
        self._pitch = max(-89.0, min(89.0, self._pitch))
        cy, sy = math.cos(math.radians(self._yaw)), math.sin(
            math.radians(self._yaw))
        cp, sp = math.cos(math.radians(self._pitch)), math.sin(
            math.radians(self._pitch))
        d = _norm((cy * cp, sp, sy * cp))
        lookfrom = _madd(self._orbit_lookat, d, -self._orbit_dist)
        self.camera = Camera(lookfrom, self._orbit_lookat,
                             self.camera.up, self.camera.vfov)

    def orbit_end(self) -> None:
        self._dragging = False
        self._last_xy = None

    # -- widgets ----------------------------------------------------------
    def set_fov(self, vfov: float) -> None:
        vfov = max(self.config.fov_min, min(self.config.fov_max, float(vfov)))
        cam = self.camera
        self.camera = Camera(cam.lookfrom, cam.lookat, cam.up, vfov)

    def set_lookfrom(self, p) -> None:
        cam = self.camera
        self.camera = Camera(tuple(map(float, p)), cam.lookat, cam.up,
                             cam.vfov)

    def set_lookat(self, p) -> None:
        cam = self.camera
        self.camera = Camera(cam.lookfrom, tuple(map(float, p)), cam.up,
                             cam.vfov)

    def reset(self) -> None:
        self.camera = self.initial
        self._dragging = False
        self._last_xy = None
