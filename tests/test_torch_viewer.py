"""The port's live viewer: an HTTP round trip drives the FrameStepper with
the reference's WASD/TAB/mouse/ESC semantics (Window.h:133-169), as
tests/test_viewer.py does for the JAX package. Servers bind port 0 (a free
port); every request and join has a timeout."""

import json
import threading
import urllib.request

import numpy as np
import pytest

from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box
from pathtrace_tpu_torch.interactive import FrameStepper
from pathtrace_tpu_torch.io.bmp import encode_bmp, read_bmp
from pathtrace_tpu_torch.viewer import ViewerServer, _bmp_bytes

TIMEOUT = 60


def _start(stepper):
    srv = ViewerServer(stepper, host="127.0.0.1", port=0, logger=lambda *a: None)
    thread = threading.Thread(target=srv.httpd.serve_forever, daemon=True)
    thread.start()
    return srv, thread


@pytest.fixture(scope="module")
def server():
    cfg = RenderConfig(width=64, height=48, spp=1, max_bounces=2)
    srv, thread = _start(FrameStepper(cornell_box(), Camera.create(), cfg, device="cpu"))
    yield srv
    srv.httpd.shutdown()
    thread.join(timeout=TIMEOUT)
    srv.httpd.server_close()


def _post(srv, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/step",
                                 data=json.dumps(payload).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        return resp.read(), dict(resp.headers)


def _bmp_from_bytes(tmp_path, body):
    path = tmp_path / "frame.bmp"
    path.write_bytes(body)
    return read_bmp(str(path))


def test_index_page(server):
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/", timeout=TIMEOUT) as resp:
        page = resp.read().decode()
    assert "pathtrace-torch" in page and "/step" in page
    assert 'width="64"' in page and 'height="48"' in page


def test_unknown_path_is_404(server):
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(f"http://127.0.0.1:{server.port}/nope", timeout=TIMEOUT)
    assert exc.value.code == 404


def test_step_returns_frame_and_applies_input(server, tmp_path):
    before = server.stepper.camera.position.clone()
    body, headers = _post(server, {"keys": ["KeyW"], "dx": 0, "dy": 0})
    assert headers["Content-Type"] == "image/bmp"
    assert _bmp_from_bytes(tmp_path, body).shape == (48, 64, 3)
    assert not np.allclose(before.numpy(), server.stepper.camera.position.numpy()), \
        "W must move the camera"
    assert headers["X-Denoising"] == "off"
    _, headers2 = _post(server, {"tab": 1})
    assert headers2["X-Denoising"] == "on"
    _post(server, {"tab": 1})  # back off for the other tests


def test_mouse_look_changes_yaw(server):
    yaw0 = float(server.stepper.camera.yaw)
    _post(server, {"dx": 50, "dy": 0})
    assert float(server.stepper.camera.yaw) != yaw0


def test_bmp_bytes_roundtrip(tmp_path):
    rgb = (np.random.default_rng(0).uniform(size=(13, 17, 3)) * 255).astype(np.uint8)
    assert _bmp_bytes(rgb) == encode_bmp(rgb)
    np.testing.assert_array_equal(_bmp_from_bytes(tmp_path, encode_bmp(rgb)), rgb)


def test_spp_header_and_progressive_refinement():
    """A still camera converges: X-Spp grows across idle steps and resets on
    motion (progressive mode is what ``serve`` runs)."""
    cfg = RenderConfig(width=32, height=32, spp=2, max_bounces=2)
    srv, thread = _start(FrameStepper(cornell_box(), Camera.create(), cfg, progressive=True,
                                      device="cpu"))
    try:
        _, h1 = _post(srv, {})
        _, h2 = _post(srv, {})
        assert int(h2["X-Spp"]) > int(h1["X-Spp"]) == 2
        _, h3 = _post(srv, {"keys": ["KeyW"]})
        assert int(h3["X-Spp"]) == 2  # motion resets the accumulation
        assert h3["X-Frame"] == "2"
    finally:
        srv.httpd.shutdown()
        thread.join(timeout=TIMEOUT)
        srv.httpd.server_close()


def test_esc_shuts_down_server():
    """ESC (Window.h:152-153): the step answers X-Quit and the server stops."""
    cfg = RenderConfig(width=16, height=16, spp=1, max_bounces=2)
    srv, thread = _start(FrameStepper(cornell_box(), Camera.create(), cfg, device="cpu"))
    _, headers = _post(srv, {"esc": 1})
    assert headers["X-Quit"] == "1"
    thread.join(timeout=TIMEOUT)
    assert not thread.is_alive(), "serve_forever must return after ESC"
    srv.httpd.server_close()
