"""The port's viewer (viewer/controls.py, viewer/server.py) on the CPU.

The camera controller is plain Python: each case of tests/test_viewer.py
runs the same event sequence through the port's controller and the JAX
package's, and the cameras must agree within 1e-12 (the same float64
arithmetic; only the last bit of a libm call may differ).  The server
cases drive a viewer on scenes/cbox_rect.xml at 32x24, depth 4, on the CPU,
over HTTP with timeouts and bounded polling.  The last case holds /frame to
a sum and a sample count of the same step while the render loop runs.
"""

import json
import math
import time
import urllib.request

import numpy as np
import pytest
import torch

from pathtracer_cuda_interactive_tpu.ops.camera import Camera as JaxCamera
from pathtracer_cuda_interactive_tpu.utils.config import (
    RenderConfig as JaxRenderConfig)
from pathtracer_cuda_interactive_tpu.viewer.controls import (
    CameraController as JaxCameraController)
from pathtracer_cuda_interactive_tpu_torch import SCENES_DIR
from pathtracer_cuda_interactive_tpu_torch.ops.camera import Camera
from pathtracer_cuda_interactive_tpu_torch.render.renderer import (
    ProgressiveRenderer)
from pathtracer_cuda_interactive_tpu_torch.utils import image
from pathtracer_cuda_interactive_tpu_torch.utils.config import RenderConfig
from pathtracer_cuda_interactive_tpu_torch.viewer import server
from pathtracer_cuda_interactive_tpu_torch.viewer.controls import (
    CameraController)
from pathtracer_cuda_interactive_tpu_torch.viewer.server import Viewer

CBOX = str(SCENES_DIR / "cbox_rect.xml")
W, H = 32, 24
TIMEOUT = 30            # seconds for one HTTP request and for one poll

torch.set_num_threads(1)

FRONT = ((0.0, 0.0, 0.0), (0.0, 0.0, -1.0), (0.0, 1.0, 0.0), 45.0)
SIDE = ((3.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 45.0)


def _pair(fields):
    """(port controller, JAX controller) on the same camera."""
    return (CameraController(Camera(*fields)),
            JaxCameraController(JaxCamera(*fields), JaxRenderConfig()))


def _run(events, fields=FRONT):
    """Apply ``events`` [(method, args)] to both controllers; check that
    their cameras agree within 1e-12 after each one; return the port's."""
    ours, theirs = _pair(fields)
    for name, args in events:
        getattr(ours, name)(*args)
        getattr(theirs, name)(*args)
        a, b = ours.camera, theirs.camera
        np.testing.assert_allclose(
            np.array(a.lookfrom + a.lookat + a.up + (a.vfov,)),
            np.array(b.lookfrom + b.lookat + b.up + (b.vfov,)),
            rtol=0, atol=1e-12, err_msg=name)
    return ours


def test_fly_forward_moves_along_front():
    c = _run([("fly", (1.0,))])
    # front is -z; speed 0.5 (imgui_manager.cpp:143)
    np.testing.assert_allclose(c.camera.lookfrom, (0, 0, -0.5), atol=1e-6)
    # lookat rides one unit ahead of lookfrom (imgui_manager.cpp:180)
    np.testing.assert_allclose(c.camera.lookat, (0, 0, -1.5), atol=1e-6)


def test_fly_strafe_moves_along_right():
    c = _run([("fly", (0.0, 1.0))])
    right = np.cross((0, 0, -1), (0, 1, 0))
    np.testing.assert_allclose(c.camera.lookfrom, tuple(0.5 * right),
                               atol=1e-6)


def test_orbit_preserves_distance_and_lookat():
    c = _run([("orbit_begin", (100, 100)), ("orbit_drag", (150, 80)),
              ("orbit_drag", (170, 60)), ("orbit_end", ())], SIDE)
    got = c.camera
    assert got.lookat == SIDE[1]             # orbits the captured lookat
    assert abs(math.dist(got.lookfrom, got.lookat) - 3.0) < 1e-6
    assert not np.allclose(got.lookfrom, SIDE[0])


def test_orbit_pitch_clamped_to_89_degrees():
    # screen y grows downward: dragging far UP pitches the view up until
    # the +89 degree clamp; the camera ends below the lookat
    c = _run([("orbit_begin", (0, 0)), ("orbit_drag", (0, -100000))], SIDE)
    y = c.camera.lookfrom[1]
    assert y < 0
    assert abs(-y / 3.0 - math.sin(math.radians(89))) < 1e-4


def test_fov_clamp_lookfrom_lookat_and_reset():
    c = _run([("set_fov", (500,))])
    assert c.camera.vfov == 120.0   # imgui_manager.cpp:101 slider max
    c = _run([("set_fov", (1,)), ("set_lookfrom", ((1, 2, 3),)),
              ("set_lookat", ((0, 2, 0),))])
    assert c.camera == Camera((1.0, 2.0, 3.0), (0.0, 2.0, 0.0), FRONT[2],
                              10.0)
    c = _run([("fly", (1.0,)), ("orbit_begin", (0, 0)), ("reset", ()),
              ("orbit_drag", (50, 50))])
    assert c.camera == Camera(*FRONT)


def test_no_drag_without_begin():
    c = _run([("orbit_drag", (50, 50))])
    assert c.camera == Camera(*FRONT)


@pytest.fixture(scope="module")
def viewer():
    r = ProgressiveRenderer.from_xml(CBOX, RenderConfig(max_depth=4),
                                     width=W, height=H, device="cpu")
    v = Viewer(r, port=0)  # ephemeral port
    v.start()
    yield v
    v.stop()


def _get(v, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{v.port}{path}",
                                timeout=TIMEOUT) as resp:
        return resp.read()


def _post(v, ev):
    req = urllib.request.Request(f"http://127.0.0.1:{v.port}/event",
                                 data=json.dumps(ev).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        return resp.read()


def _poll(v, until, what):
    """/state until ``until(state)`` holds, at most TIMEOUT seconds."""
    deadline = time.monotonic() + TIMEOUT
    while time.monotonic() < deadline:
        st = json.loads(_get(v, "/state"))
        if until(st):
            return st
        time.sleep(0.02)
    raise AssertionError(f"{what} within {TIMEOUT} s")


def _png(data, tmp_path):
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    path = tmp_path / "frame.png"
    path.write_bytes(data)
    return image.read_png(str(path))


def test_viewer_serves_page_and_frames(viewer, tmp_path):
    page = _get(viewer, "/")
    assert b"Scene Controls" in page and b"Performance" in page
    _poll(viewer, lambda st: st["samples"] > 0, "no frame rendered")
    img = _png(_get(viewer, "/frame"), tmp_path)
    assert img.shape == (H, W, 3) and img.std() > 0
    state = json.loads(_get(viewer, "/state"))
    assert state["size"] == [W, H]
    assert state["camera"]["vfov"] > 0 and state["fps"] > 0


def test_viewer_events_drive_camera_and_reset(viewer):
    state0 = _poll(viewer, lambda st: st["samples"] >= 20,
                   "samples never accumulated")
    lookfrom0 = state0["camera"]["lookfrom"]
    _post(viewer, {"type": "orbit_begin", "x": 100, "y": 100})
    _post(viewer, {"type": "orbit_drag", "x": 140, "y": 90})
    # the move restarts the sum: the count drops below what it had reached
    _poll(viewer, lambda st: not np.allclose(st["camera"]["lookfrom"],
                                             lookfrom0)
          and st["samples"] < state0["samples"], "camera never moved")
    _post(viewer, {"type": "orbit_end"})
    _post(viewer, {"type": "reset"})
    _poll(viewer, lambda st: np.allclose(st["camera"]["lookfrom"],
                                         lookfrom0), "reset never applied")
    assert json.loads(_post(viewer, {"type": "spf", "value": 99})) == {}
    st = _poll(viewer, lambda st: st["spf"] == 10, "spf never clamped")
    assert st["spf"] == 10  # clamped to slider max


def test_frame_never_mixes_two_sample_counts(tmp_path):
    """Every sample adds 0.25 to every channel, so a frame tonemapped with
    its own count is 127 everywhere (sqrt(0.25) * 255.99).  The step leaves
    a window between the sum and the count, as the renderer's does; a
    /frame that read inside it would see another value."""
    r = ProgressiveRenderer.from_xml(CBOX, RenderConfig(max_depth=4),
                                     width=W, height=H, device="cpu")

    def step(num_samples=None, sync=None):
        ns = num_samples or r.samples_per_frame
        r.accum += 0.25 * ns
        time.sleep(0.002)
        r.sample_count += ns

    r.step = step
    v = Viewer(r, port=0)
    v.start()
    try:
        _poll(v, lambda st: st["samples"] > 0, "no frame rendered")
        for k in range(30):
            if k % 10 == 5:   # a camera move zeroes sum and count
                _post(v, {"type": "fly", "forward": 1.0})
            img = _png(_get(v, "/frame"), tmp_path)
            assert (img == 127).all(), np.unique(img)
    finally:
        v.stop()
    assert r.sample_count > 0


def test_viewer_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the card is there: the CLI would serve")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        server.main([CBOX, "--port", "0"])
