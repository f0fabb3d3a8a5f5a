"""The port's interactive loop, held to the JAX package's.

The cases of tests/test_interactive.py on the port. Beside them: the
stepper's float colour (what ``to_display`` receives) against the JAX
stepper's on the same lattice, under the forward rules of
tests/test_torch_trace_kernel.py (colour off by more than 1e-3 on at most
1% of pixels); the spp and frame state machine held exactly; the fade's
blend held exactly against its formula; and a denoiser trained by the JAX
package (an orbax checkpoint of ``DenoiseCNN(widths=(8, 16))`` from
``create_state``) carried across by scripts/torch_convert_checkpoint.py,
whose ``denoise_channels`` must agree across the packages within 1e-4.
"""

import dataclasses
import importlib.util
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtrace_tpu import Camera as JaxCamera
from pathtrace_tpu import RenderConfig as JaxConfig
from pathtrace_tpu import cornell_box as jax_cornell_box
from pathtrace_tpu import interactive as jax_interactive
from pathtrace_tpu.models.denoise_cnn import DenoiseCNN as FlaxDenoiseCNN
from pathtrace_tpu.models.infer import denoise_channels as jax_denoise_channels
from pathtrace_tpu.render import pack_channels as jax_pack_channels
from pathtrace_tpu.render import render_aovs as jax_render_aovs
from pathtrace_tpu.train import create_state
from pathtrace_tpu.train import save_checkpoint as jax_save_checkpoint

from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box
from pathtrace_tpu_torch import interactive
from pathtrace_tpu_torch.interactive import FrameStepper, run_interactive, to_display
from pathtrace_tpu_torch.models import init_model
from pathtrace_tpu_torch.models.infer import denoise_channels
from pathtrace_tpu_torch.render import pack_channels, render_aovs
from pathtrace_tpu_torch.train import save_checkpoint
from test_torch_trace_kernel import MAX_FLIP_SHARE, flip_share

REPO = Path(__file__).resolve().parents[1]
CFG = RenderConfig(width=32, height=32, spp=1)
JCFG = JaxConfig(width=32, height=32, spp=1, backend="jnp")


def _capture(monkeypatch, module):
    """The float colours ``module``'s stepper hands to ``to_display``."""
    frames, orig = [], module.to_display

    def spy(color):
        frames.append(np.asarray(color))
        return orig(color)

    monkeypatch.setattr(module, "to_display", spy)
    return frames


def _port_checkpoint(path, seed=0):
    save_checkpoint(str(path), init_model(torch.Generator().manual_seed(seed), widths=(8, 16)))
    return str(path)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """An orbax checkpoint of the JAX package and its conversion."""
    root = tmp_path_factory.mktemp("ckpt")
    model = FlaxDenoiseCNN(widths=(8, 16))
    state = create_state(jax.random.key(0), model, (32, 32, 14))
    # Batch statistics off their init, so that the conversion of each matters.
    rng = np.random.default_rng(0)
    stats = jax.tree.map(lambda v: jnp.asarray(rng.uniform(0.5, 1.5, v.shape), jnp.float32),
                         state.batch_stats)
    state = state._replace(batch_stats=stats)
    jax_dir, port_dir = str(root / "jax"), str(root / "port")
    jax_save_checkpoint(jax_dir, state, model)
    spec = importlib.util.spec_from_file_location(
        "torch_convert_checkpoint", REPO / "scripts" / "torch_convert_checkpoint.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    written = script.convert(jax_dir, port_dir)
    assert written == os.path.join(port_dir, "model_epoch.pt")
    return jax_dir, port_dir


def test_converted_checkpoint_denoises_as_jax(converted):
    jax_dir, port_dir = converted
    assert json.loads(Path(port_dir, "model.json").read_text()) == json.loads(
        Path(jax_dir, "model.json").read_text())
    buf = np.asarray(jax_pack_channels(jax_render_aovs(
        jax_cornell_box(), JaxCamera.create(), dataclasses.replace(JCFG, spp=2))))
    want = np.asarray(jax_denoise_channels(jnp.asarray(buf), jax_dir))
    got = denoise_channels(torch.from_numpy(buf.copy()), port_dir).numpy()
    assert got.shape == want.shape == (32, 32, 3)
    assert np.abs(got - want).max() <= 1e-4
    assert ((want > 0.0) & (want < 1.0)).mean() > 0.2


def test_to_display_clamps():
    x = torch.tensor([[[-0.5, 0.5, 2.0]]])
    np.testing.assert_array_equal(to_display(x).numpy()[0, 0], [0, 127, 255])
    v = np.concatenate([np.random.default_rng(0).uniform(-0.2, 1.2, 300),
                        np.arange(256) / 255.0]).astype(np.float32).reshape(-1, 1, 1)
    np.testing.assert_array_equal(to_display(torch.from_numpy(v)).numpy(),
                                  np.asarray(jax_interactive.to_display(jnp.asarray(v))))


def test_stepper_renders_and_moves_as_jax(monkeypatch):
    got, want = _capture(monkeypatch, interactive), _capture(monkeypatch, jax_interactive)
    stepper = FrameStepper(cornell_box(), Camera.create(), CFG, device="cpu")
    jstepper = jax_interactive.FrameStepper(jax_cornell_box(), JaxCamera.create(), JCFG)
    a = stepper.step()
    jstepper.step()
    assert a.shape == (32, 32, 3) and a.dtype == np.uint8
    for s in (stepper, jstepper):
        s.move("forward", 0.1)
        s.look(5.0, 0.0)
    b = stepper.step()
    jstepper.step()
    assert stepper.frame == jstepper.frame == 2
    assert not np.array_equal(a, b)  # the camera moved
    assert np.isfinite(stepper.last_ms)
    np.testing.assert_allclose(stepper.camera.position.numpy(),
                               np.asarray(jstepper.camera.position), rtol=1e-6)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert flip_share(g, w) <= MAX_FLIP_SHARE


def test_toggle_denoising_with_checkpoint(tmp_path):
    """TAB: toggling switches the display path through the CNN."""
    stepper = FrameStepper(cornell_box(), Camera.create(), CFG, denoising=False,
                           checkpoint=_port_checkpoint(tmp_path), device="cpu")
    raw = stepper.step()
    stepper.toggle_denoising()
    assert stepper.denoising
    denoised = stepper.step()
    assert denoised.shape == raw.shape
    assert not np.array_equal(raw, denoised)


def test_run_interactive_writes_frames(tmp_path, capsys):
    out_dir, metrics = str(tmp_path / "frames"), str(tmp_path / "m" / "frames.jsonl")
    stepper = run_interactive(cornell_box(), Camera.create(), CFG, max_frames=3,
                              out_dir=out_dir, metrics_path=metrics, device="cpu")
    assert stepper.frame == 3
    assert sorted(os.listdir(out_dir)) == ["frame_00000.bmp", "frame_00001.bmp",
                                           "frame_00002.bmp"]
    assert "fps" in capsys.readouterr().out
    records = [json.loads(line) for line in Path(metrics).read_text().splitlines()]
    assert [r["frame"] for r in records] == [0, 1, 2]
    assert all(r["event"] == "frame" and not r["denoised"] for r in records)


def test_progressive_state_machine_matches_jax(monkeypatch):
    """Idle steps accumulate on the same lattice (a monolithic render at the
    reset frame), motion restarts on a new frame index, TAB does not; the
    JAX stepper goes through the same states."""
    got, want = _capture(monkeypatch, interactive), _capture(monkeypatch, jax_interactive)
    cfg, jcfg = dataclasses.replace(CFG, spp=2), dataclasses.replace(JCFG, spp=2)
    stepper = FrameStepper(cornell_box(), Camera.create(), cfg, progressive=True, device="cpu")
    jstepper = jax_interactive.FrameStepper(jax_cornell_box(), JaxCamera.create(), jcfg,
                                            progressive=True)
    states = []
    for action in ("step", "step", "step", "check", "tab", "step", "move", "step", "look",
                   "step"):
        for s in (stepper, jstepper):
            if action == "step":
                s.step()
            elif action == "tab":
                s.toggle_denoising()
            elif action == "move":
                s.move("forward", 0.1)
            elif action == "look":
                s.look(3.0, 0.0)
        if action == "check":
            # Accumulated partials == one monolithic 8-spp render of frame 0.
            want_color = render_aovs(cornell_box(), Camera.create(),
                                     dataclasses.replace(cfg, spp=8), 0, device="cpu")["color"]
            np.testing.assert_allclose(stepper._prog.aovs()["color"].numpy(),
                                       want_color.numpy(), rtol=1e-5, atol=1e-6)
        states.append((stepper.spp_accumulated, stepper.frame, stepper._prog.frame))
        assert states[-1] == (jstepper.spp_accumulated, jstepper.frame, jstepper._prog.frame)
    assert [s[0] for s in states] == [2, 4, 8, 8, 8, 16, 16, 2, 2, 2]
    assert states[-1] == (2, 6, 5)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert flip_share(g, w) <= MAX_FLIP_SHARE


def test_progressive_max_spp_cap():
    cfg = RenderConfig(width=16, height=16, spp=2)
    stepper = FrameStepper(cornell_box(), Camera.create(), cfg, progressive=True, max_spp=6,
                           device="cpu")
    for _ in range(5):
        stepper.step()
    assert stepper.spp_accumulated == 6  # capped: 2 + 2 + 2, then idle


def test_progressive_denoise_fades_to_accumulation(tmp_path):
    """Denoise while converging: at low spp the display differs from the raw
    accumulation (the CNN active); far past the fade scale it converges to
    it; and the displayed frame is the documented blend, exactly. At 16x16
    (the JAX test's 32x32 costs ~4x more on the CPU, for ~4,096 spp)."""
    ckpt = _port_checkpoint(tmp_path)
    cfg = RenderConfig(width=16, height=16, spp=2)
    stepper = FrameStepper(cornell_box(), Camera.create(), cfg, denoising=True,
                           checkpoint=ckpt, progressive=True, device="cpu")
    early = stepper.step()  # 2 spp: the CNN fully active
    raw_early = to_display(stepper._prog.aovs()["color"]).numpy()
    assert not np.array_equal(early, raw_early)

    for _ in range(15):
        out = stepper.step()
    raw = to_display(stepper._prog.aovs()["color"]).numpy()
    late_diff = np.abs(out.astype(int) - raw.astype(int))
    early_diff = np.abs(early.astype(int) - raw_early.astype(int)).mean()
    assert late_diff.mean() < 0.35 * early_diff

    # w = clip(max(sqrt(max(var, 0) / n) / fade_std, fade_spp / n), 0, 1).
    aovs = stepper._prog.aovs()
    den = denoise_channels(pack_channels(aovs), ckpt).numpy()
    n = float(stepper._prog.samples_done)
    var = aovs["color_var"].numpy()
    w = np.clip(np.maximum(np.sqrt(np.maximum(var, np.float32(0.0)) / np.float32(n))
                           / np.float32(stepper.denoise_fade_std),
                           np.float32(stepper.denoise_fade_spp / n)), 0.0, 1.0)[..., None]
    want = w * den + (np.float32(1.0) - w) * aovs["color"].numpy()
    assert want.dtype == np.float32
    np.testing.assert_array_equal(out, to_display(torch.from_numpy(want)).numpy())
