"""App smoke tests + headless drive of the live viewer (verdict r1 #7, #8).

COVERAGE.md rows 11–12 said "driven manually" in round 1; these run the two
app entry points at tiny sizes under pytest and exercise the live viewer's
full loop (input event → FPSCamera → render → PNG endpoint) without a
browser.
"""

import json
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "apps"))


def test_app_main_smoke(tmp_path):
    import importlib

    main_app = importlib.import_module("main")
    out = tmp_path / "frame.png"
    rc = main_app.main([
        "--scene", "icosphere", "--frames", "2",
        "--width", "64", "--height", "64",
        "--out", str(out), "--api", "http://127.0.0.1:1",  # unreachable: graceful
    ])
    assert rc == 0
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    # non-black: decode via the PPM-free path — just check the PNG has bulk
    assert len(data) > 500


def test_app_debug_smoke(tmp_path):
    import importlib

    debug_app = importlib.import_module("debug")
    out = tmp_path / "debug.png"
    js = tmp_path / "bvh.json"
    rc = debug_app.main([
        "--width", "64", "--height", "64",
        "--out", str(out), "--json", str(js),
    ])
    assert rc == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    dump = json.loads(js.read_text())
    assert len(dump["nodes"]) > 0


@pytest.fixture()
def viewer():
    from raytracer.models.camera import FPSCamera
    from raytracer.pathtracer import PathTracer
    from raytracer.server.viewer import ViewerState, make_viewer_server
    from raytracer.utils import procgen

    tracer = PathTracer(width=64, height=64)
    tracer.build_bvh(procgen.make_icosphere(2))
    state = ViewerState(tracer, FPSCamera(position=[0.0, 0.0, 2.5]))
    srv = make_viewer_server(state, port=0)   # ephemeral port
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield state, srv
    srv.shutdown()


def _get(srv, path):
    port = srv.server_address[1]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as r:
        return r.read()


def _post(srv, path, payload):
    port = srv.server_address[1]
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode()
    )
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())


def test_viewer_endpoints(viewer):
    state, srv = viewer

    # a frame renders and streams as PNG
    state.step(1 / 60)
    png = _get(srv, "/api/frame.png")
    assert png[:8] == b"\x89PNG\r\n\x1a\n"

    stats = json.loads(_get(srv, "/api/stats"))
    assert stats["frame"] == 1 and stats["width"] == 64

    shell = _get(srv, "/")
    assert b"pointerLockElement" in shell

    # input events drive the camera exactly like the reference's handlers
    p0 = state.camera.position.copy()
    assert _post(srv, "/api/input", {"keys": ["KeyW"], "dx": 10, "dy": 0})["ok"]
    state.step(0.1)
    p1 = state.camera.position.copy()
    assert np.linalg.norm(p1 - p0) > 1e-3          # moved forward
    assert state.camera.rotation[1] != 0.0          # yawed from the mouse dx

    # frame changed after moving — the streaming loop is PIPELINED (frame
    # i+1's render is dispatched before frame i is pulled/encoded, viewer.py
    # step()), so the moved frame publishes on the step after the move
    state.step(0.1)
    png2 = _get(srv, "/api/frame.png")
    assert png2 != png

    # key release stops motion
    assert _post(srv, "/api/input", {"released": ["KeyW"]})["ok"]
    state.step(0.1)
    p2 = state.camera.position.copy()
    state.step(0.1)
    assert np.allclose(state.camera.position, p2)


def test_viewer_adaptive_streaming(viewer):
    """Active input streams downscaled frames; idle publishes ONE full-res
    frame then parks the loop (no renders until the next input event)."""
    import struct

    state, srv = viewer

    def png_size(data):
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
        w, h = struct.unpack(">II", data[16:24])
        return w, h

    # active: frames come out stream_scale x downscaled
    _post(srv, "/api/input", {"dx": 5.0})
    assert state.step(1 / 30) is True
    w, h = png_size(_get(srv, "/api/frame.png"))
    assert (w, h) == (64 // state.stream_scale, 64 // state.stream_scale)
    assert state.scale_now == state.stream_scale

    # idle: one full-res publish, then the loop parks
    state._last_input = 0.0
    assert state.step(1 / 30) is True
    assert png_size(_get(srv, "/api/frame.png")) == (64, 64)
    assert state.scale_now == 1
    n = state.frame_count
    assert state.step(1 / 30) is False          # parked
    assert state.frame_count == n

    # new input un-parks the loop
    _post(srv, "/api/input", {"dx": 1.0})
    assert state.step(1 / 30) is True
