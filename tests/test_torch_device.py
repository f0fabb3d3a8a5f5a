"""Entry points run on the card unless the caller asks for the CPU.

With no CUDA device, every public entry point given ``device=None`` raises
and says to pass ``device="cpu"``; given ``device="cpu"`` it runs. Scenes
and cameras are built on the host in both cases (``cornell_box()``,
``Camera.create()``). The card's side (``device=None`` launches the forward
kernel) is in tests/test_torch_kernel_cuda.py.
"""

import pytest
import torch

from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box
from pathtrace_tpu_torch import grad, inverse, parallel, progressive, render
from pathtrace_tpu_torch.interactive import FrameStepper, run_interactive
from pathtrace_tpu_torch.models import init_model
from pathtrace_tpu_torch.models.infer import load_pretrained
from pathtrace_tpu_torch.ops import ad_grad_kernel as ak
from pathtrace_tpu_torch.ops import grad_kernel as gk
from pathtrace_tpu_torch.ops import nee_grad_kernel as nk
from pathtrace_tpu_torch.ops import trace_kernel as tk
from pathtrace_tpu_torch.train import save_checkpoint
from pathtrace_tpu_torch.utils.debug import checked_render

CFG = RenderConfig(width=8, height=4, spp=1, max_bounces=2)
KERNEL = RenderConfig(width=8, height=4, spp=1, max_bounces=2, backend="cuda")
TARGET = torch.zeros(4, 8, 3)


def _sc():
    return cornell_box(), Camera.create()


def _step(cfg, **kw):
    state, step_fn, _ = inverse.make_inverse_step(*_sc(), cfg, TARGET, **kw)
    return step_fn(state)[1]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt"))
    save_checkpoint(path, init_model(torch.Generator().manual_seed(0), widths=(8, 16)))
    return path


# name -> f(device, ckpt, tmp_path): one call of a public entry point.
ENTRY_POINTS = {
    "render_aovs": lambda d, c, t: render.render_aovs(*_sc(), CFG, device=d),
    "render_channels": lambda d, c, t: render.render_channels(*_sc(), KERNEL, device=d),
    "render_color": lambda d, c, t: grad.render_color(*_sc(), CFG, device=d),
    "render_loss_grads": lambda d, c, t: grad.render_loss_grads(*_sc(), KERNEL, device=d),
    "render_scalar_grads": lambda d, c, t: grad.render_scalar_grads(*_sc(), CFG, device=d),
    "render_geometry_grads": lambda d, c, t: grad.render_geometry_grads(*_sc(), CFG, device=d),
    "make_inverse_step": lambda d, c, t: _step(KERNEL, device=d),
    "recover_scene": lambda d, c, t: inverse.recover_scene(cornell_box(), *_sc(), CFG, steps=1,
                                                           device=d),
    "ProgressiveRenderer.accumulate": lambda d, c, t: progressive.ProgressiveRenderer(
        *_sc(), KERNEL, device=d).accumulate(1),
    "render_high_spp": lambda d, c, t: progressive.render_high_spp(*_sc(), CFG, 2, 1, device=d),
    "FrameStepper.step": lambda d, c, t: FrameStepper(*_sc(), CFG, denoising=True, checkpoint=c,
                                                      progressive=True, device=d).step(),
    "run_interactive": lambda d, c, t: run_interactive(*_sc(), CFG, max_frames=1,
                                                       out_dir=str(t / "f"),
                                                       logger=lambda *a: None, device=d),
    "load_pretrained": lambda d, c, t: load_pretrained(c, d),
    "checked_render": lambda d, c, t: checked_render(*_sc(), CFG, device=d),
    "trace_kernel.render_partials": lambda d, c, t: tk.render_partials(*_sc(), KERNEL, device=d),
    "grad_kernel.cross_grads": lambda d, c, t: gk.cross_grads(*_sc(), KERNEL, 0, TARGET,
                                                              device=d),
    "nee_grad_kernel.nee_loss_and_grads": lambda d, c, t: nk.nee_loss_and_grads(
        *_sc(), RenderConfig(width=8, height=4, spp=1, max_bounces=2, nee=True), 0, TARGET,
        device=d),
    "ad_grad_kernel.ad_loss_and_grads": lambda d, c, t: ak.ad_loss_and_grads(
        *_sc(), RenderConfig(width=8, height=4, spp=1, max_bounces=2, brdf="glossy"), 0, TARGET,
        device=d),
    # The grid: the mesh holds the rank's device, so it is asked there.
    "parallel.make_mesh": lambda d, c, t: parallel.make_mesh(device=d),
    "parallel.render_channels_sharded": lambda d, c, t: parallel.render_channels_sharded(
        *_sc(), KERNEL, parallel.make_mesh(device=d)),
    "parallel.sharded_loss_grads": lambda d, c, t: parallel.sharded_loss_grads(
        *_sc(), KERNEL, parallel.make_mesh(device=d), TARGET),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_no_cuda_and_no_device_raises(name, ckpt, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        ENTRY_POINTS[name](None, ckpt, tmp_path)
    assert not (tmp_path / "f").exists()


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_device_cpu_runs(name, ckpt, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ENTRY_POINTS[name]("cpu", ckpt, tmp_path)


def test_resolve_device():
    assert render.resolve_device("cpu") == torch.device("cpu")
    assert render.resolve_device(torch.device("cuda", 1)) == torch.device("cuda", 1)


def test_device_cpu_renders_the_cpu_frame():
    """The explicit CPU frame is the plain wavefront's, on the CPU."""
    scene, cam = _sc()
    aovs = render.render_aovs(scene, cam, CFG, device="cpu")
    want = render.finalize_aovs(*render.accumulate_frame(scene, cam, CFG, 0), CFG.spp)
    for k, v in aovs.items():
        assert v.device == torch.device("cpu") and torch.equal(v, want[k]), k
