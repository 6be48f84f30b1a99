"""Sidecar server tests: artifact dump API round-trip + static routes."""

import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from raytracer.server import api as api_server
from raytracer.server import static as static_server


@pytest.fixture()
def api(tmp_path):
    srv = api_server.make_server(port=0, data_dir=tmp_path, quiet=True)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv, tmp_path
    srv.shutdown()


def _post(port, path, data):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=data,
        headers={"Content-Type": "application/octet-stream"},
    )
    return urllib.request.urlopen(req)


def test_write_artifact_roundtrip(api):
    srv, data_dir = api
    port = srv.server_address[1]
    payload = np.arange(100, dtype=np.uint32).tobytes()

    resp = _post(port, "/api/write", payload)
    assert resp.status == 200
    # default artifact name matches the reference (data/BVH2.bin, api.js:30)
    assert (data_dir / "BVH2.bin").read_bytes() == payload

    back = urllib.request.urlopen(f"http://127.0.0.1:{port}/api/read?name=BVH2.bin")
    assert back.read() == payload


def test_write_named_and_traversal_rejected(api):
    srv, data_dir = api
    port = srv.server_address[1]
    _post(port, "/api/write?name=BVH4_wide.bin", b"\x01\x02\x03\x04")
    assert (data_dir / "BVH4_wide.bin").exists()

    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, "/api/write?name=..%2Fevil", b"x")
    assert e.value.code == 400


def test_unknown_route_404(api):
    srv, _ = api
    port = srv.server_address[1]
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/api/nope")
    assert e.value.code == 404


def test_empty_body_rejected(api):
    srv, _ = api
    port = srv.server_address[1]
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, "/api/write", b"")
    assert e.value.code == 400


def test_cors_headers(api):
    srv, _ = api
    port = srv.server_address[1]
    resp = urllib.request.urlopen(f"http://127.0.0.1:{port}/health")
    assert resp.headers["Access-Control-Allow-Origin"] == api_server.ALLOWED_ORIGIN


def test_static_routes(tmp_path):
    (tmp_path / "index.html").write_text("<html>viewer</html>")
    (tmp_path / "debug.html").write_text("<html>debug</html>")
    srv = static_server.make_server(port=0, root=tmp_path)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        port = srv.server_address[1]
        assert b"viewer" in urllib.request.urlopen(f"http://127.0.0.1:{port}/").read()
        assert b"debug" in urllib.request.urlopen(f"http://127.0.0.1:{port}/debug").read()
    finally:
        srv.shutdown()
