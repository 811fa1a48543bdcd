"""Interactive web viewer — the OpenGL/GLFW/ImGui stack rebuilt as a
remote frame stream (SURVEY.md C28-C30).

The port of ``pathtracer_cuda_interactive_tpu/viewer/server.py``, on the
port's ``ProgressiveRenderer`` (``--device``, default ``cuda``).  A
background thread runs the progressive render loop (main.cu:272-344
semantics) while a small dependency-free HTTP server streams tonemapped PNG
frames to a browser canvas and feeds mouse and key events back into the
shared :class:`~.controls.CameraController`.

Endpoints:
  GET  /        HTML page: canvas + the "Scene Controls" / "Performance"
                panels (lookfrom/lookat widgets, FOV 10-120, samples/frame
                1-10, Reset — imgui_manager.cpp:75-124)
  GET  /frame   latest tonemapped frame (image/png)
  GET  /state   JSON: fps, frame ms, accumulated samples, camera
  POST /event   JSON UI events: orbit_begin/orbit_drag/orbit_end, fly,
                fov, spf, lookfrom, lookat, reset

Run:  python -m pathtracer_cuda_interactive_tpu_torch.viewer scene.xml
          [--device cuda|cpu] [--port N] [--width W --height H]
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..render.renderer import ProgressiveRenderer
from ..utils import image as img_util
from ..utils.config import RenderConfig
from .controls import CameraController


STOP_TIMEOUT_S = 60.0


class _FrameWanted:
    """A /frame handler's request for the accumulation buffer, served by
    the render thread between two steps."""

    def __init__(self):
        self.done = threading.Event()
        self.accum = None
        self.sample_count = 0


class ViewerState:
    """Shared state between the render thread and HTTP handlers.

    ``lock`` guards the controller, samples per frame, FPS, frame count and
    the list of frame requests; it is taken inside ``render_lock``, never
    the other way round.  ``render_lock`` makes a step (which does
    ``accum += new`` in place and only then ``sample_count += ns``) and a
    read of the accumulation buffer mutually exclusive, so a frame is never
    tonemapped with a count that does not match its sum.  While the render
    loop runs, a /frame handler does not contend for ``render_lock``: a
    small scene's step takes under a millisecond on the card, and the loop
    can retake the lock (which is not fair) before a waiting handler
    wakes, frame after frame.  The handler queues a request instead, which
    the loop serves right after its next step; the tonemap and the PNG
    encode stay on the handler thread."""

    def __init__(self, renderer: ProgressiveRenderer):
        self.renderer = renderer
        self.controls = CameraController(renderer.camera, renderer.config)
        self.samples_per_frame = renderer.samples_per_frame
        self.lock = threading.Lock()
        self.render_lock = threading.Lock()
        self.fps = 0.0
        self.frames = 0                 # render-loop turns so far
        self.stop = threading.Event()
        self._looping = False
        self._wanted: list = []

    # -- render loop (the while !glfwWindowShouldClose body) --------------
    def run_render_loop(self) -> None:
        r = self.renderer
        on_card = (torch.cuda.device(r.device) if r.device.type == "cuda"
                   else contextlib.nullcontext())
        with self.lock:
            self._looping = True
        last = time.perf_counter()
        try:
            with on_card:
                while not self.stop.is_set():
                    with self.lock:
                        cam = self.controls.camera
                        spf = self.samples_per_frame
                    with self.render_lock:
                        r.set_camera(cam)       # epsilon-compare + reset
                        r.set_samples_per_frame(spf)
                        r.step()                # synced: frame_ms is honest
                        # requests made during the step too; a step that
                        # raises leaves them to the finally below
                        with self.lock:
                            wanted, self._wanted = self._wanted, []
                        self._serve(wanted)
                    now = time.perf_counter()
                    with self.lock:
                        dt = now - last
                        self.fps = 1.0 / dt if dt > 0 else 0.0
                        self.frames += 1
                    last = now
        finally:
            with self.lock:
                self._looping = False
                wanted, self._wanted = self._wanted, []
            with self.render_lock:
                self._serve(wanted)
        # The frame PNG is produced ON DEMAND (frame_png_now): the
        # reference's display reads the accumulation buffer at display
        # time (opengl_display.cpp:99-117); encoding a PNG every loop turn
        # would cap the loop at the encoder's rate.

    def _serve(self, wanted: list) -> None:
        """Hand one read of the buffer to every queued request (under
        ``render_lock``)."""
        if not wanted:
            return
        # a copy: on the CPU, .cpu() would hand out the live buffer
        accum = self.renderer.accum.to("cpu", copy=True).numpy()
        count = self.renderer.sample_count
        for req in wanted:
            req.accum, req.sample_count = accum, count
            req.done.set()

    def frame_now(self) -> np.ndarray:
        """The tonemapped frame [H, W, 3] uint8, read between two steps."""
        req = _FrameWanted()
        with self.lock:
            queued = self._looping
            if queued:
                self._wanted.append(req)
        if queued:
            req.done.wait()
            return img_util.tonemap(req.accum, req.sample_count)
        with self.render_lock:
            return self.renderer.framebuffer()

    def frame_png_now(self) -> bytes:
        return img_util.encode_png(self.frame_now(), level=1)

    def handle_event(self, ev: dict) -> None:
        c = self.controls
        with self.lock:
            kind = ev.get("type")
            if kind == "orbit_begin":
                c.orbit_begin(ev["x"], ev["y"])
            elif kind == "orbit_drag":
                c.orbit_drag(ev["x"], ev["y"])
            elif kind == "orbit_end":
                c.orbit_end()
            elif kind == "fly":
                c.fly(ev.get("forward", 0.0), ev.get("strafe", 0.0))
            elif kind == "fov":
                c.set_fov(ev["value"])
            elif kind == "lookfrom":
                c.set_lookfrom(ev["value"])
            elif kind == "lookat":
                c.set_lookat(ev["value"])
            elif kind == "spf":
                v = int(ev["value"])
                lo, hi = c.config.spf_min, c.config.spf_max
                self.samples_per_frame = max(lo, min(hi, v))
            elif kind == "reset":
                c.reset()

    def state_json(self) -> bytes:
        r = self.renderer
        with self.lock:
            cam = self.controls.camera
            payload = {
                "fps": round(self.fps, 1),
                "frame_ms": round(r.frame_ms, 2),
                "samples": r.sample_count,
                "spf": self.samples_per_frame,
                "camera": {"lookfrom": cam.lookfrom, "lookat": cam.lookat,
                           "up": cam.up, "vfov": cam.vfov},
                "size": [r.width, r.height],
            }
        return json.dumps(payload).encode()


_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>torrey-tpu</title>
<style>
 body{margin:0;background:#111;color:#ddd;font:13px monospace;display:flex}
 #panel{padding:12px;min-width:260px}
 #panel div{margin:6px 0}
 canvas{image-rendering:pixelated;margin:12px}
 input[type=range]{width:140px;vertical-align:middle}
 input[type=number]{width:60px;background:#222;color:#ddd;border:1px solid #444}
 button{background:#333;color:#ddd;border:1px solid #555;padding:2px 10px}
</style></head><body>
<canvas id="cv" tabindex="0"></canvas>
<div id="panel">
 <b>Scene Controls</b>
 <div>lookfrom <span id="lf"></span></div>
 <div>lookat &nbsp; <span id="la"></span></div>
 <div>FOV <input id="fov" type="range" min="10" max="120" step="1">
      <span id="fovv"></span></div>
 <div>samples/frame <input id="spf" type="range" min="1" max="10" step="1">
      <span id="spfv"></span></div>
 <div><button id="reset">Reset Camera (R)</button></div>
 <hr><b>Performance</b>
 <div>FPS: <span id="fps"></span></div>
 <div>frame: <span id="ms"></span> ms</div>
 <div>accumulated samples: <span id="acc"></span></div>
 <div>drag = orbit &middot; WASD = fly</div>
</div>
<script>
const cv=document.getElementById('cv'),ctx_=cv.getContext('2d');
let drag=false;
function post(ev){fetch('/event',{method:'POST',body:JSON.stringify(ev)});}
cv.addEventListener('mousedown',e=>{drag=true;post({type:'orbit_begin',x:e.offsetX,y:e.offsetY});});
window.addEventListener('mouseup',()=>{if(drag){drag=false;post({type:'orbit_end'});}});
cv.addEventListener('mousemove',e=>{if(drag)post({type:'orbit_drag',x:e.offsetX,y:e.offsetY});});
window.addEventListener('keydown',e=>{
  const k=e.key.toLowerCase();
  if(k==='w')post({type:'fly',forward:1});
  if(k==='s')post({type:'fly',forward:-1});
  if(k==='a')post({type:'fly',strafe:-1});
  if(k==='d')post({type:'fly',strafe:1});
  if(k==='r')post({type:'reset'});
});
document.getElementById('fov').oninput=e=>post({type:'fov',value:+e.target.value});
document.getElementById('spf').oninput=e=>post({type:'spf',value:+e.target.value});
document.getElementById('reset').onclick=()=>post({type:'reset'});
async function frames(){
  while(true){
    try{
      const blob=await (await fetch('/frame')).blob();
      const img=await createImageBitmap(blob);
      cv.width=img.width;cv.height=img.height;ctx_.drawImage(img,0,0);
    }catch(e){}
    await new Promise(r=>setTimeout(r,50));
  }
}
async function stats(){
  while(true){
    try{
      const s=await (await fetch('/state')).json();
      fps.textContent=s.fps; ms.textContent=s.frame_ms;
      acc.textContent=s.samples;
      lf.textContent=s.camera.lookfrom.map(v=>v.toFixed(2)).join(', ');
      la.textContent=s.camera.lookat.map(v=>v.toFixed(2)).join(', ');
      fovv.textContent=s.camera.vfov.toFixed(0);
      spfv.textContent=s.spf;
      document.getElementById('fov').value=s.camera.vfov;
      document.getElementById('spf').value=s.spf;
    }catch(e){}
    await new Promise(r=>setTimeout(r,250));
  }
}
frames();stats();
</script></body></html>"""


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, ctype, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/":
                self._send(200, "text/html", _PAGE.encode())
            elif self.path == "/frame":
                self._send(200, "image/png", state.frame_png_now())
            elif self.path == "/state":
                self._send(200, "application/json", state.state_json())
            else:
                self._send(404, "text/plain", b"not found")

        def do_POST(self):
            if self.path == "/event":
                n = int(self.headers.get("Content-Length", 0))
                try:
                    ev = json.loads(self.rfile.read(n) or b"{}")
                    state.handle_event(ev)
                    self._send(200, "application/json", b"{}")
                except (ValueError, KeyError) as e:
                    self._send(400, "text/plain", str(e).encode())
            else:
                self._send(404, "text/plain", b"not found")

        def log_message(self, *a):  # quiet
            pass

    return Handler


class Viewer:
    """Owns the HTTP server + render thread.  start()/stop() for embedding
    and tests; serve_forever() for the CLI."""

    def __init__(self, renderer: ProgressiveRenderer, port: int = 8421,
                 host: str = "127.0.0.1"):
        self.state = ViewerState(renderer)
        self.httpd = ThreadingHTTPServer((host, port),
                                         make_handler(self.state))
        self.port = self.httpd.server_address[1]
        self._threads = []

    def start(self) -> None:
        t1 = threading.Thread(target=self.state.run_render_loop, daemon=True)
        t2 = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t1.start()
        t2.start()
        self._threads = [t1, t2]

    def stop(self) -> None:
        """Stop the loop and the server and join both threads; raises
        TimeoutError if one is still running after STOP_TIMEOUT_S seconds
        (a step in flight finishes first)."""
        self.state.stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        for t in self._threads:
            t.join(STOP_TIMEOUT_S)
        alive = [t.name for t in self._threads if t.is_alive()]
        if alive:
            raise TimeoutError(f"viewer threads still running: {alive}")

    def serve_forever(self) -> None:
        self.start()
        print(f"viewer: http://127.0.0.1:{self.port}/  (Ctrl-C to quit)")
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            self.stop()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="torrey-torch-viewer")
    ap.add_argument("scene")
    ap.add_argument("--port", type=int, default=8421)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: cuda)")
    args = ap.parse_args(argv)

    renderer = ProgressiveRenderer.from_xml(
        args.scene, RenderConfig(), width=args.width, height=args.height,
        device=args.device)
    Viewer(renderer, port=args.port, host=args.host).serve_forever()
    return 0
