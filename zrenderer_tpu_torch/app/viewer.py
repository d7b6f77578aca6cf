"""Interactive viewer, a window and message pump over localhost HTTP
(counterpart of ``zrenderer_tpu/app/viewer.py``).

The "window" is a localhost HTTP surface:

- ``GET /``          a canvas page that shows the latest frame and posts
                     mouse/keyboard events
- ``GET /frame.png`` the most recent rendered frame
- ``GET /state``     frame index + stats line (the window title)
- ``POST /events``   queued input events (JSON list)
- ``POST /quit``     close the "window"

Every frame the viewer drains the event queue into the imgui
:class:`~zrenderer_tpu_torch.app.imgui.InputState`, runs the UI (stats and
scene outliner windows: draggable, collapsible, live), routes mouse drags
the UI did not capture and WASD keys to the fly camera, renders through
the Renderer on its device, composites the UI with the overlay pass (K8
and K8b on a card) and publishes the PNG.

    python -m zrenderer_tpu_torch.app.viewer --scene content/scenes/test_scene \
        --width 960 --height 540 --port 8765 --device cuda

``--scene`` takes a scene folder or a .gltf/.glb file, as the app's does.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from zrenderer_tpu_torch.app.camera import CameraController
from zrenderer_tpu_torch.app.imgui import Context
from zrenderer_tpu_torch.app.overlay_ui import ImguiOverlay
from zrenderer_tpu_torch.engine.config import PIPELINES, RenderConfig
from zrenderer_tpu_torch.engine.renderer import Renderer
from zrenderer_tpu_torch.app.main import bind_scene_textures, load_scene_path
from zrenderer_tpu_torch.utils.png import encode_png

log = logging.getLogger("zrenderer_torch.viewer")

LOOK_SPEED = 0.005  # rad / pixel
MOVE_SPEED = 3.0  # units / s
WHEEL_SPEED = 0.5  # units / wheel notch

_PAGE = """<!doctype html>
<html><head><title>zrenderer-tpu</title><style>
  body { margin: 0; background: #101014; color: #ddd;
         font-family: monospace; }
  #bar { padding: 4px 8px; font-size: 12px; }
  #view { display: block; image-rendering: pixelated; outline: none; }
</style></head><body>
<div id="bar">zrenderer-tpu viewer — drag: look / drag UI windows,
 wheel: dolly, WASD+QE: fly, click frame first for keys</div>
<img id="view" draggable="false" tabindex="0">
<script>
const view = document.getElementById('view');
const bar = document.getElementById('bar');
let queue = [];
function post(ev) { queue.push(ev); }
function pos(e) {
  const r = view.getBoundingClientRect();
  return {x: e.clientX - r.left, y: e.clientY - r.top};
}
// JS buttons: 0=left, 1=middle, 2=right; InputState: 0=left, 1=right,
// 2=middle (the Win32/ImGui order) — swap 1 and 2.
function btn(e) { return e.button === 2 ? 1 : (e.button === 1 ? 2 : 0); }
// move/up listen on window so drags that overshoot the frame still track
// and the release is never lost (mouse capture)
window.addEventListener('mousemove', e => {
  const p = pos(e); post({t: 'move', x: p.x, y: p.y});
});
view.addEventListener('mousedown', e => {
  view.focus(); post({t: 'down', b: btn(e)});
  e.preventDefault();
});
window.addEventListener('mouseup', e => {
  post({t: 'up', b: btn(e)});
});
view.addEventListener('wheel', e => {
  post({t: 'wheel', dy: -e.deltaY / 100}); e.preventDefault();
}, {passive: false});
view.addEventListener('contextmenu', e => e.preventDefault());
view.addEventListener('keydown', e => {
  if (!e.repeat) post({t: 'key', k: e.key.toLowerCase(), down: true});
  e.preventDefault();
});
view.addEventListener('keyup', e => {
  post({t: 'key', k: e.key.toLowerCase(), down: false});
});
async function flush() {
  if (queue.length) {
    const batch = queue; queue = [];
    await fetch('/events', {method: 'POST', body: JSON.stringify(batch)});
  }
}
async function loop() {
  for (;;) {
    try {
      await flush();
      const resp = await fetch('/frame.png?i=' + Date.now());
      const blob = await resp.blob();
      const url = URL.createObjectURL(blob);
      await new Promise(res => { view.onload = res; view.src = url; });
      URL.revokeObjectURL(url);
      const st = await (await fetch('/state')).json();
      bar.textContent = st.stats;
    } catch (e) { await new Promise(r => setTimeout(r, 500)); }
  }
}
loop();
</script></body></html>"""


class _SharedState:
    """Data shared between the HTTP server threads and the render loop."""

    def __init__(self):
        self.lock = threading.Lock()
        self.frame_png = b""
        self.frame_index = 0
        self.stats_line = ""
        self.events: list[dict] = []
        self.stop = False


def _make_handler(shared: _SharedState):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?", 1)[0]
            if path == "/":
                self._send(200, _PAGE.encode(), "text/html")
            elif path == "/frame.png":
                with shared.lock:
                    png = shared.frame_png
                if png:
                    self._send(200, png, "image/png")
                else:
                    self._send(503, b"no frame yet", "text/plain")
            elif path == "/state":
                with shared.lock:
                    body = json.dumps({
                        "frame": shared.frame_index,
                        "stats": shared.stats_line,
                    }).encode()
                self._send(200, body, "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n) if n else b""
            if self.path == "/events":
                try:
                    events = json.loads(body or b"[]")
                except json.JSONDecodeError:
                    self._send(400, b"bad json", "text/plain")
                    return
                with shared.lock:
                    shared.events.extend(
                        e for e in events if isinstance(e, dict))
                self._send(200, b"ok", "text/plain")
            elif self.path == "/quit":
                shared.stop = True
                self._send(200, b"bye", "text/plain")
            else:
                self._send(404, b"not found", "text/plain")

        def log_message(self, *args):  # quiet; the app logs frames itself
            pass

    return Handler


class Viewer:
    """Owns the renderer, the UI context, the camera, and the HTTP window."""

    def __init__(self, scene, mesh_data, config: RenderConfig,
                 port: int = 0, host: str = "127.0.0.1", device="cuda"):
        self.scene = scene
        self.renderer = Renderer(config, device=device)
        self.renderer.load_scene(scene, mesh_data)
        self.ui = ImguiOverlay(config.width, config.height,
                               device=self.renderer.device)
        self.ctx: Context = self.ui.ctx
        self.camera = CameraController(scene.active_camera)
        self.shared = _SharedState()
        self.server = ThreadingHTTPServer(
            (host, port), _make_handler(self.shared))
        self._server_thread = threading.Thread(
            target=self.server.serve_forever, daemon=True)
        self._server_thread.start()
        self._last_t = time.perf_counter()
        log.info("viewer window at http://%s:%d/", host, self.port)

    @property
    def port(self) -> int:
        return self.server.server_address[1]

    # -- message pump -------------------------------------------------------

    def pump_events(self) -> int:
        """Drain queued HTTP events into the imgui io (pos/button/wheel/
        key -> AddEvent), the message-pump loop."""
        with self.shared.lock:
            events, self.shared.events = self.shared.events, []
        io = self.ctx.io
        for e in events:
            try:
                t = e.get("t")
                if t == "move":
                    io.add_mouse_pos_event(float(e["x"]), float(e["y"]))
                elif t == "down":
                    io.add_mouse_button_event(int(e["b"]), True)
                elif t == "up":
                    io.add_mouse_button_event(int(e["b"]), False)
                elif t == "wheel":
                    io.add_mouse_wheel_event(0.0, float(e["dy"]))
                elif t == "key":
                    io.add_key_event(str(e["k"]), bool(e["down"]))
                elif t == "leave":
                    io.mouse_leave()
            except (KeyError, TypeError, ValueError):
                log.warning("dropping malformed input event: %r", e)
        return len(events)

    def _update_camera(self, dt: float) -> None:
        """Route non-UI input to the fly camera (mouse-look + WASD/QE)."""
        f = self.ctx.frame
        keys = self.ctx.io.keys_down
        if not self.ctx.want_capture_mouse:
            if f.mouse_down[0]:
                self.camera.look(-f.mouse_delta[1] * LOOK_SPEED,
                                 -f.mouse_delta[0] * LOOK_SPEED)
            if f.wheel:
                self.camera.move(forward=f.wheel * WHEEL_SPEED)
        step = MOVE_SPEED * dt
        self.camera.move(
            forward=step * ((("w" in keys) - ("s" in keys))),
            right=step * ((("d" in keys) - ("a" in keys))),
            up=step * ((("e" in keys) - ("q" in keys))),
        )

    # -- frame --------------------------------------------------------------

    def step(self) -> np.ndarray:
        """One frame: pump → UI → camera → render → compose → publish."""
        now = time.perf_counter()
        dt = min(now - self._last_t, 0.1)
        self._last_t = now
        self.pump_events()
        ctx = self.ctx
        ctx.new_frame()
        self.ui.build(self.renderer.stats.format_line(), self.scene)
        self._update_camera(dt)
        color, _depth = self.renderer.render()
        self.renderer.present()  # fence pacing + staging-ring rotation
        img = self.ui.compose_dl(color, ctx.render())
        png = encode_png(img)
        with self.shared.lock:
            self.shared.frame_png = png
            self.shared.frame_index += 1
            self.shared.stats_line = self.renderer.stats.format_line()
        return img

    def run(self, max_frames: int | None = None,
            target_fps: float = 30.0) -> None:
        frame_budget = 1.0 / target_fps if target_fps > 0 else 0.0
        n = 0
        while not self.shared.stop:
            t0 = time.perf_counter()
            self.step()
            n += 1
            if max_frames is not None and n >= max_frames:
                break
            sleep = frame_budget - (time.perf_counter() - t0)
            if sleep > 0:
                time.sleep(sleep)

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.renderer.finish_gpu_commands()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="zrenderer-tpu-torch-viewer")
    parser.add_argument("--scene", default="content/scenes/test_scene",
                        help="folder containing scene.bin + meshes.bin, "
                             "or a .gltf/.glb file")
    parser.add_argument("--width", type=int, default=960)
    parser.add_argument("--height", type=int, default=540)
    parser.add_argument("--port", type=int, default=8765)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--pipeline", default="flat", choices=PIPELINES)
    parser.add_argument("--fps", type=float, default=30.0)
    parser.add_argument("--frames", type=int, default=None,
                        help="stop after N frames (default: run until /quit)")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda, cuda:N or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")

    scene, mesh_data, texture_dir = load_scene_path(args.scene)
    config = RenderConfig(width=args.width, height=args.height,
                          pipeline=args.pipeline)
    viewer = Viewer(scene, mesh_data, config, port=args.port, host=args.host,
                    device=args.device)
    if config.pipeline != "flat":
        bind_scene_textures(viewer.renderer, mesh_data, texture_dir)
    try:
        viewer.run(max_frames=args.frames, target_fps=args.fps)
    except KeyboardInterrupt:
        pass
    finally:
        viewer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
