"""Minimal live viewer: a browser window driving the interactive loop.

The counterpart of ``pathtrace_tpu.viewer``. The reference's display is a
GLFW/OpenGL window with WASD movement, mouse look, TAB denoising toggle,
SPACE pose dump and ESC quit (``include/Window.h:16-193``). Here it is a
standard-library HTTP server and one HTML page: the browser captures the
same keys and mouse, POSTs them to ``/step``, and the server advances one
``interactive.FrameStepper`` (on the card unless it was built for the CPU)
by one frame and replies with a BMP the page draws. One render is in flight
at a time (the page awaits each response), so control latency is one frame.

While the camera is still the frame converges (the stepper's progressive
mode) and the HUD shows the live spp count; any movement restarts the
accumulation at ``cfg.spp``.

Start with ``python -m pathtrace_tpu_torch.cli --viewer [-d]`` and open the
printed URL. Key map (Window.h:133-169): WASD move, drag = mouse look, TAB
toggles denoising, SPACE prints the camera pose on the server console, ESC
shuts the viewer down (Window.h:152-153).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from pathtrace_tpu_torch.camera import Camera
from pathtrace_tpu_torch.config import RenderConfig
from pathtrace_tpu_torch.interactive import FrameStepper
from pathtrace_tpu_torch.io.bmp import encode_bmp

_PAGE = """<!doctype html>
<html><head><title>pathtrace-torch</title><style>
body { margin:0; background:#111; color:#ccc; font:13px monospace;
       display:flex; flex-direction:column; align-items:center }
#view { image-rendering:pixelated; margin-top:8px; cursor:crosshair }
#hud  { padding:6px }
</style></head><body>
<div id="hud">WASD move &middot; drag to look &middot; TAB denoise &middot; SPACE pose &middot; ESC quit &middot; connecting&hellip;</div>
<img id="view" width="WIDTH" height="HEIGHT">
<script>
const keys = new Set();
let dx = 0, dy = 0, tab = 0, space = 0, esc = 0;
window.addEventListener('keydown', e => {
  if (e.code === 'Tab') { tab++; e.preventDefault(); }
  else if (e.code === 'Space') { space++; e.preventDefault(); }
  else if (e.code === 'Escape') { esc++; e.preventDefault(); }
  else keys.add(e.code);
});
window.addEventListener('keyup', e => keys.delete(e.code));
let dragging = false, lx = 0, ly = 0;
const img = document.getElementById('view');
img.addEventListener('mousedown', e => { dragging = true; lx = e.clientX; ly = e.clientY; });
window.addEventListener('mouseup', () => dragging = false);
window.addEventListener('mousemove', e => {
  if (!dragging) return;
  dx += e.clientX - lx; dy += ly - e.clientY; lx = e.clientX; ly = e.clientY;
});
const hud = document.getElementById('hud');
let url = null;
async function loop() {
  while (true) {
    const payload = { keys: Array.from(keys), dx, dy, tab, space, esc };
    dx = 0; dy = 0; tab = 0; space = 0; esc = 0;
    try {
      const r = await fetch('/step', { method: 'POST', body: JSON.stringify(payload) });
      if (r.headers.get('X-Quit') === '1') { hud.textContent = 'viewer shut down (ESC)'; return; }
      const ms = r.headers.get('X-Frame-Ms'), den = r.headers.get('X-Denoising');
      const spp = r.headers.get('X-Spp');
      const blob = await r.blob();
      if (url) URL.revokeObjectURL(url);
      url = URL.createObjectURL(blob);
      img.src = url;
      hud.textContent = `frame ${r.headers.get('X-Frame')} | ${spp} spp | ` +
        `${Number(ms).toFixed(1)} ms | ${(1000 / Number(ms)).toFixed(1)} fps | denoising ${den}` ;
    } catch (e) { hud.textContent = 'disconnected: ' + e; await new Promise(s => setTimeout(s, 500)); }
  }
}
loop();
</script></body></html>
"""

_KEYMAP = {  # browser KeyboardEvent.code -> Camera.move direction
    "KeyW": "forward",
    "KeyS": "backward",
    "KeyA": "left",
    "KeyD": "right",
}
MOUSE_SCALE = 0.08  # pixels of drag -> Camera.look offset units


def _bmp_bytes(rgb: np.ndarray) -> bytes:
    return encode_bmp(rgb)


class ViewerServer:
    """HTTP wrapper around one FrameStepper; one render at a time."""

    def __init__(self, stepper: FrameStepper, host: str = "127.0.0.1", port: int = 8764,
                 logger=print):
        self.stepper = stepper
        self.lock = threading.Lock()
        self.logger = logger
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path not in ("/", "/index.html"):
                    self.send_error(404)
                    return
                page = (
                    _PAGE.replace("WIDTH", str(viewer.stepper.cfg.width))
                    .replace("HEIGHT", str(viewer.stepper.cfg.height))
                ).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(page)))
                self.end_headers()
                self.wfile.write(page)

            def do_POST(self):
                if self.path != "/step":
                    self.send_error(404)
                    return
                length = int(self.headers.get("Content-Length", "0"))
                try:
                    payload = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError:
                    payload = {}
                if payload.get("esc"):
                    # ESC quit (Window.h:152-153): acknowledge, then shut
                    # the server down from another thread (shutdown() from
                    # inside a handler would deadlock serve_forever).
                    self.send_response(200)
                    self.send_header("Content-Length", "0")
                    self.send_header("X-Quit", "1")
                    self.end_headers()
                    viewer.logger("viewer: ESC — shutting down")
                    threading.Thread(
                        target=viewer.httpd.shutdown, daemon=True
                    ).start()
                    return
                body, frame, ms, den, spp = viewer.step(payload)
                self.send_response(200)
                self.send_header("Content-Type", "image/bmp")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("X-Frame", str(frame))
                self.send_header("X-Frame-Ms", f"{ms:.3f}")
                self.send_header("X-Denoising", "on" if den else "off")
                self.send_header("X-Spp", str(spp))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self.httpd.server_address[:2]

    # -- input application (Window.h:133-169 semantics) ----------------------
    def step(self, payload: dict):
        with self.lock:
            s = self.stepper
            dt = 1.0 / 60.0 if not np.isfinite(s.last_ms) else s.last_ms / 1000.0
            for code in payload.get("keys", ()):
                direction = _KEYMAP.get(code)
                if direction:
                    s.move(direction, dt)
            dx = float(payload.get("dx", 0.0)) * MOUSE_SCALE
            dy = float(payload.get("dy", 0.0)) * MOUSE_SCALE
            if dx or dy:
                s.look(dx, dy)
            for _ in range(int(payload.get("tab", 0))):
                s.toggle_denoising()
            if payload.get("space"):
                self.logger(s.camera.pose_string())
            rgb = s.step()
            return (
                _bmp_bytes(rgb), s.frame - 1, s.last_ms, s.denoising,
                s.spp_accumulated,
            )


def serve(
    scene,
    camera: Camera,
    cfg: RenderConfig,
    denoising: bool = False,
    checkpoint: Optional[str] = None,
    host: str = "127.0.0.1",
    port: int = 8764,
    logger=print,
    device=None,
):
    """Blocking viewer entry point (``--viewer``): the stepper runs on
    ``device`` (default: the current CUDA device)."""
    stepper = FrameStepper(
        scene, camera, cfg, denoising, checkpoint, progressive=True, device=device
    )
    server = ViewerServer(stepper, host, port, logger)
    logger(f"viewer: http://{server.host}:{server.port}/  (Ctrl-C to quit)")
    try:
        server.httpd.serve_forever()
    except KeyboardInterrupt:
        logger("viewer: shutting down")
    finally:
        server.httpd.server_close()
    return stepper
