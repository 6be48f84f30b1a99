"""Live viewer server — the interactive loop the reference runs in-browser.

The reference wires pointer-lock mouse + WASD straight into its rAF render
loop (src/main.js:54-76, src/libs/controls/input-handler.js:58-97). This
renderer is headless, so the equivalent is a tiny stdlib HTTP server:

* ``GET  /``                → the live shell (public/live.html): a canvas-less
  <img> that polls the latest frame, plus pointer-lock mouse/keyboard capture
  forwarded as JSON input events.
* ``GET  /api/frame.png``   → the most recent rendered frame (in-memory PNG).
* ``POST /api/input``       → {keys:[...], released:[...], dx, dy, fly} —
  applied to the FPSCamera exactly like the reference's DOM handlers.
* ``GET  /api/stats``       → {frame, fps, width, height} for the FPS badge
  (the reference's 1 Hz DOM counter, src/main.js:64-68).

The render loop runs in a background thread: apply queued input → camera
update(dt) → PathTracer.render() → PNG. A human can fly the scene from a
browser against the renderer; tests drive the same endpoints headlessly.
"""

from __future__ import annotations

import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import urlparse

import numpy as np

from ..models.camera import FPSCamera
from ..utils.image import encode_png

__all__ = ["ViewerState", "make_viewer_server", "run_viewer"]

_PUBLIC = Path(__file__).resolve().parents[2] / "public"
VIEWER_PORT = 3000


class ViewerState:
    """Shared state between the HTTP handlers and the render thread.

    Streaming is bandwidth-adaptive: while the user is ACTIVE (keys held /
    mouse moving / within ``idle_after`` of the last input) frames are
    pulled ``stream_scale``×-downscaled (scale²·4/3 fewer bytes — on-device
    box filter, PathTracer.render_stream) and the browser upscales the
    <img>. Once input goes idle, ONE full-resolution frame is rendered and
    published, then the loop parks (no device work, no pulls) until the
    next input event."""

    def __init__(self, tracer, camera: FPSCamera | None = None,
                 stream_scale: int = 2, idle_after: float = 0.7):
        self.tracer = tracer
        self.camera = camera or FPSCamera(position=tracer.camera_position)
        self.stream_scale = max(1, int(stream_scale))
        self.idle_after = float(idle_after)
        self.lock = threading.Lock()
        self.frame_png: bytes = encode_png(
            np.zeros((tracer.height, tracer.width, 3), np.uint8)
        )
        self.frame_count = 0
        self.fps = 0.0
        self.scale_now = self.stream_scale
        self._pending_mouse = [0.0, 0.0]
        self._last_input = time.monotonic()
        self._idle_published = False
        # 2-deep streaming pipeline: the device→host pull of frame i runs on
        # a worker thread (the transfer releases the GIL) while the main
        # loop PNG-encodes frame i−1 (CPU-bound), and frame i+1's render is
        # already dispatched on device. Throughput ≈ max(pull, encode)
        # instead of render + pull + encode. 2 workers: consecutive frames'
        # pulls overlap in flight instead of serializing
        self._pull_pool = ThreadPoolExecutor(max_workers=2)
        self._pull_future = None   # in-flight (future -> np img), + scale
        self._stop = threading.Event()

    # -- input ------------------------------------------------------------

    def apply_input(self, msg: dict) -> None:
        with self.lock:
            for code in msg.get("keys", []):
                self.camera.press(str(code))
            for code in msg.get("released", []):
                self.camera.release(str(code))
            self._pending_mouse[0] += float(msg.get("dx", 0.0))
            self._pending_mouse[1] += float(msg.get("dy", 0.0))
            if "fly" in msg:
                self.camera.set_fly(bool(msg["fly"]))
            self._last_input = time.monotonic()
            self._idle_published = False

    # -- render loop --------------------------------------------------------

    def step(self, dt: float) -> bool:
        """One frame: drain input, move the camera, render, encode.

        Returns True if a frame was rendered (False = parked idle)."""
        with self.lock:
            dx, dy = self._pending_mouse
            self._pending_mouse[0] = self._pending_mouse[1] = 0.0
            keys_held = bool(self.camera._keys)
            active = (dx or dy or keys_held
                      or time.monotonic() - self._last_input < self.idle_after)
            if not active and self._idle_published:
                return False
        if dx or dy:
            self.camera.move_mouse(dx, dy)
        self.camera.update(dt)
        p = self.camera.position
        q = self.camera.rotation
        self.tracer.set_camera_position(float(p[0]), float(p[1]), float(p[2]))
        self.tracer.set_camera_quaternion(
            float(q[0]), float(q[1]), float(q[2]), float(q[3])
        )
        scale = self.stream_scale if active else 1
        if scale > 1:
            dev = self.tracer.render_stream(scale)
        else:
            dev = self.tracer.render()
        if active:
            prev = self._pull_future
            # submit frame i's pull BEFORE waiting frame i−1's: with two
            # pool workers both transfers are in flight concurrently, so
            # the wait below is max(0, pull − step) instead of a full pull
            self._pull_future = (
                self._pull_pool.submit(np.asarray, dev), scale)
            if prev is None:
                prev = self._pull_future   # first streamed frame: no overlap
        else:
            # idle: publish THIS full-res frame synchronously, then park —
            # a stale in-flight streaming frame must not overwrite it
            prev = (self._pull_pool.submit(np.asarray, dev), scale)
            self._pull_future = None
        fut, pscale = prev
        img = fut.result()     # frame i−1: its pull overlapped our encode
        if pscale == 1:
            img = img[..., :3]
        png = encode_png(img, level=1)   # speed > size for streaming
        with self.lock:
            self.frame_png = png
            self.frame_count += 1
            self.scale_now = pscale
            if not active:
                self._idle_published = True
        return True

    def render_loop(self) -> None:
        last = time.perf_counter()
        ema = None
        while not self._stop.is_set():
            now = time.perf_counter()
            dt = min(now - last, 0.1)
            last = now
            if not self.step(dt):
                time.sleep(0.02)   # parked: poll input at 50 Hz, no device work
                continue
            took = time.perf_counter() - now
            ema = took if ema is None else 0.9 * ema + 0.1 * took
            self.fps = 1.0 / max(ema, 1e-6)

    def stop(self) -> None:
        self._stop.set()
        self._pull_pool.shutdown(wait=False)


def make_viewer_server(state: ViewerState, port: int = VIEWER_PORT,
                       quiet: bool = True) -> ThreadingHTTPServer:
    class _Handler(BaseHTTPRequestHandler):
        def _send(self, code, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:  # noqa: N802
            path = urlparse(self.path).path
            if path in ("/", "/index.html"):
                shell = _PUBLIC / "live.html"
                self._send(200, shell.read_bytes(), "text/html")
            elif path == "/api/frame.png":
                with state.lock:
                    png = state.frame_png
                self._send(200, png, "image/png")
            elif path == "/api/stats":
                body = json.dumps({
                    "frame": state.frame_count,
                    "fps": round(state.fps, 2),
                    "width": state.tracer.width,
                    "height": state.tracer.height,
                    "scale": state.scale_now,
                }).encode()
                self._send(200, body, "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self) -> None:  # noqa: N802
            path = urlparse(self.path).path
            if path != "/api/input":
                self._send(404, b"not found", "text/plain")
                return
            n = int(self.headers.get("Content-Length", 0))
            try:
                msg = json.loads(self.rfile.read(n) or b"{}")
                state.apply_input(msg)
                self._send(200, b'{"ok":true}', "application/json")
            except (ValueError, KeyError) as e:
                self._send(400, json.dumps({"error": str(e)}).encode(),
                           "application/json")

        def log_message(self, fmt, *args):  # noqa: A003
            if not quiet:
                super().log_message(fmt, *args)

    return ThreadingHTTPServer(("0.0.0.0", port), _Handler)


def run_viewer(tracer, camera: FPSCamera | None = None,
               port: int = VIEWER_PORT, stream_scale: int = 2) -> None:
    """Blocking: start the render thread + HTTP server (apps/viewer.py)."""
    state = ViewerState(tracer, camera, stream_scale=stream_scale)
    thread = threading.Thread(target=state.render_loop, daemon=True)
    thread.start()
    srv = make_viewer_server(state, port, quiet=False)
    print(f"[viewer] http://localhost:{port}/  ({tracer.width}x{tracer.height})")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        state.stop()
        srv.shutdown()
