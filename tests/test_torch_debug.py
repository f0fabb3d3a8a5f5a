"""The port's debug mode and checked render (tests/test_debug.py's cases)
and the JSONL event logger."""

import pytest
import torch

from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box
from pathtrace_tpu_torch.scene import Scene
from pathtrace_tpu_torch.utils.debug import checked_render, debug_mode

CFG = RenderConfig(width=16, height=16, spp=2)


def test_checked_render_passes_on_valid_scene():
    err, aovs = checked_render(cornell_box(), Camera.create(), CFG, device="cpu")
    err.throw()  # no violation
    assert err.get() is None
    assert aovs["color"].shape == (16, 16, 3)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_checked_render_catches_nan_scene(backend):
    # A NaN emission reaches the colour. (A NaN position is benign: every
    # comparison with NaN is false, so that sphere is never hit.)
    scene = cornell_box()
    emission = scene.emission.clone()
    emission[8, 0] = float("nan")
    bad = Scene(scene.radius, scene.position, emission, scene.color)
    err, _ = checked_render(bad, Camera.create(), RenderConfig(
        width=16, height=16, spp=2, backend=backend), device="cpu")
    assert err.get() == "non-finite values in color"
    with pytest.raises(RuntimeError, match="non-finite"):
        err.throw()


def test_debug_mode_restores_flag():
    before = torch.is_anomaly_enabled()
    with debug_mode():
        assert torch.is_anomaly_enabled()
    assert torch.is_anomaly_enabled() == before
    with debug_mode(nans=False):
        assert not torch.is_anomaly_enabled()
    assert torch.is_anomaly_enabled() == before


def test_debug_mode_stops_at_a_nan_gradient():
    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    with debug_mode(), pytest.raises(RuntimeError, match="nan"):
        torch.sqrt(x).sum().backward()
    x.grad = None
    torch.sqrt(x).sum().backward()  # outside: the NaN passes silently
    assert torch.isnan(x.grad[0])


def test_jsonl_logger(tmp_path):
    import json

    from pathtrace_tpu_torch.utils.metrics import JsonlLogger

    with JsonlLogger(str(tmp_path / "sub" / "e.jsonl")) as events:
        events.log("frame", frame=0)
    rec = json.loads((tmp_path / "sub" / "e.jsonl").read_text())
    assert rec["event"] == "frame" and rec["frame"] == 0
    JsonlLogger(None).log("ignored")  # no path: a no-op
