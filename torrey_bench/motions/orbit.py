"""An orbit drag: before every timed frame the camera turns about the
scene's lookat in yaw, as the viewer's orbit drag turns it
(``viewer/controls.py::CameraController.orbit_drag``), the scene's pitch
and distance kept.  The yaw's offset from the scene's view is
``SWING_DEG * sin(2 pi frame / PERIOD_FRAMES)``: at the viewer's
``mouse_sensitivity`` of 0.1 degree a pixel, a drag of up to 13 pixels a
frame.  It depends on the frame index alone, so every run sees the same
views whatever its seed; frame 0 is the scene's own view, and every later
frame moves the camera and so restarts the accumulation."""

import dataclasses
import math

SWING_DEG = 25.0
PERIOD_FRAMES = 120


def yaw_offset(frame: int) -> float:
    """Degrees of yaw away from the scene's view at timed frame
    ``frame``."""
    return SWING_DEG * math.sin(2.0 * math.pi * frame / PERIOD_FRAMES)


def camera_at(initial, frame: int):
    """``initial`` (a camera with ``lookfrom``, ``lookat``) turned about its
    lookat by ``yaw_offset(frame)``, as the viewer's drag computes it."""
    lookat = initial.lookat
    d = [a - b for a, b in zip(lookat, initial.lookfrom)]
    dist = math.sqrt(sum(x * x for x in d))
    pitch = math.asin(max(-1.0, min(1.0, d[1] / dist)))
    yaw = math.atan2(d[2], d[0]) + math.radians(yaw_offset(frame))
    way = (math.cos(yaw) * math.cos(pitch), math.sin(pitch),
           math.sin(yaw) * math.cos(pitch))
    return dataclasses.replace(
        initial, lookfrom=tuple(c - dist * w for c, w in zip(lookat, way)))


def before_frame(renderer, frame, rng):
    """Set ``renderer``'s camera to the orbit's view at timed frame
    ``frame`` (``set_camera`` restarts the accumulation where it moved);
    ``rng`` is not drawn from."""
    renderer.set_camera(camera_at(renderer.initial_camera, frame))
