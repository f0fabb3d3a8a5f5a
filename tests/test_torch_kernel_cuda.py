"""The CUDA trace kernel against its plain PyTorch version on the card.

Every test here needs a CUDA device: they are marked ``cuda`` and skip where
there is none. The file imports only the port, so it also runs on a machine
without JAX; from the root of a checkout:

    python -m pytest tests/test_torch_kernel_cuda.py -m cuda --noconftest -o addopts="" -q

Every channel of every mode is held to the rules of ``trace_kernel.
agreement``, as in chip_smoke.py: albedo equal on >= 99.9% of pixels, and
colour (1e-3), normal (2e-6), depth (rtol 5e-4) and each statistics channel
(1e-3 of its range) out of tolerance on <= 1% of pixels (a borderline hit
decision may round the other way).
"""

import dataclasses

import pytest
import torch

from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box
from pathtrace_tpu_torch.ops import trace_kernel as tk
from pathtrace_tpu_torch.render import render_channels
from pathtrace_tpu_torch.utils import timing

CONFIGS = {"diffuse": {}, "nee": {"nee": True}, "glossy": {"brdf": "glossy"}}

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _assert_close(got, ref, mode, spp):
    checks, _ = tk.agreement(got, ref, mode, spp)
    failed = [(name, share, ceiling) for name, share, ceiling, ok in checks if not ok]
    assert not failed, f"share of pixels off above its ceiling: {failed}"


def _host_blocks(cfg):
    return cornell_box().packed(), tk.camera_block(Camera.create(), cfg)


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("mode", list(tk.MODES))
def test_kernel_matches_plain(dev, config, mode):
    cfg = RenderConfig(width=128, height=96, spp=4, **CONFIGS[config])
    sb, cb = _host_blocks(cfg)
    seed = tk.make_seed_block(cfg, 0, 5, 16)
    before = timing.launch_counts()["k1"]
    got = tk.trace(sb, cb, seed, cfg, local_h=64, spp=4, mode=mode, device=dev)
    torch.cuda.synchronize()
    assert timing.launch_counts()["k1"] == before + 1
    assert got.device == dev and got.shape == (64, 128, tk.MODES[mode])
    ref = tk.trace_plain(sb, cb, seed, cfg, local_h=64, spp=4, mode=mode, device=dev)
    _assert_close(got, ref, mode, 4)


def test_device_blocks_give_the_same_bits(dev):
    """Blocks on the card are read back into the same parameter struct."""
    cfg = RenderConfig(width=64, height=32, spp=2, nee=True)
    sb, cb = _host_blocks(cfg)
    seed = tk.make_seed_block(cfg, 1, 3, 8)
    kw = dict(local_h=24, spp=2, mode="partials")
    assert torch.equal(tk.trace(sb.to(dev), cb.to(dev), seed, cfg, **kw),
                       tk.trace(sb, cb, seed, cfg, device=dev, **kw))


@pytest.mark.parametrize("block", [1, 7, 16])
def test_ragged_edges_and_block_sizes(dev, block):
    """Odd frame sizes are bounds-checked, and the block edge changes only
    the launch shape: every block size gives the same bits."""
    cfg = RenderConfig(width=45, height=37, spp=3, max_bounces=3, nee=True)
    sb, cb = _host_blocks(cfg)
    seed = tk.make_seed_block(cfg, 2)
    kw = dict(local_h=37, spp=3, mode="channels", device=dev)
    ref = tk.trace(sb, cb, seed, cfg, **kw)
    got = tk.trace(sb, cb, seed, dataclasses.replace(cfg, block=block), **kw)
    assert torch.equal(got, ref)
    _assert_close(got, tk.trace_plain(sb, cb, seed, cfg, **kw), "channels", 3)


def test_render_dispatches_to_the_kernel_on_cuda(dev):
    cfg = RenderConfig(width=64, height=32, spp=2)
    before = timing.launch_counts()["k1"]
    buf = render_channels(cornell_box(), Camera.create(), cfg, device=dev)
    assert timing.launch_counts()["k1"] == before + 1
    assert buf.device == dev and buf.shape == (32, 64, 14)
    sb, cb = _host_blocks(cfg)
    _assert_close(buf, tk.trace_plain(sb, cb, tk.make_seed_block(cfg), cfg, local_h=32, spp=2,
                                      mode="channels", device=dev), "channels", 2)
    torch_buf = render_channels(cornell_box(), Camera.create(),
                                dataclasses.replace(cfg, backend="torch"), device=dev)
    assert timing.launch_counts()["k1"] == before + 1
    assert (buf[..., 6:9] == torch_buf[..., 6:9]).all(dim=-1).float().mean() >= 0.999


def test_wrapper_raises_on_bad_input_on_cuda(dev):
    cfg = RenderConfig(width=8, height=8, spp=1)
    sb = cornell_box(dev).packed()
    cb = tk.camera_block(Camera.create(device=dev), cfg)
    with pytest.raises(ValueError):
        tk.trace(sb, cb.cpu(), tk.make_seed_block(cfg), cfg, local_h=8, spp=1, mode="channels")
    with pytest.raises(ValueError):
        tk.trace(sb.double(), cb, tk.make_seed_block(cfg), cfg, local_h=8, spp=1,
                 mode="channels")


@pytest.mark.parametrize("config", ["diffuse", "nee", "glossy", "nee_glossy"])
@pytest.mark.parametrize("mode", list(tk.MODES))
def test_kernel_equals_plain_to_the_bit(dev, config, mode):
    """Built without contraction, the kernel draws the plain version's bits
    in every mode and configuration: max |kernel - plain| is 0. The sample
    lanes add each pixel's samples in sample order, so this holds for any
    lane count."""
    extra = {"nee_glossy": {"nee": True, "brdf": "glossy"}}.get(config, CONFIGS.get(config))
    cfg = RenderConfig(width=128, height=96, spp=4, **extra)
    sb, cb = _host_blocks(cfg)
    seed = tk.make_seed_block(cfg, 0, 5, 16)
    kw = dict(local_h=64, spp=4, mode=mode, device=dev)
    ref = tk.trace_plain(sb, cb, seed, cfg, **kw)
    assert torch.equal(tk.trace(sb, cb, seed, cfg, **kw), ref)
    for lanes in (1, 2, 4):
        got = tk.CUDA_KERNEL.launch(sb, cb, seed, cfg, lanes=lanes, **kw)
        assert torch.equal(got, ref), f"{lanes} lanes"


def test_outputs_keep_the_recorded_digests(dev):
    """The bit gate of chip_smoke.py phase 17: K1, K2 and K5 write the bytes
    recorded from the thread-a-pixel kernels."""
    import importlib.util
    from pathlib import Path

    from pathtrace_tpu_torch.ops import grad_kernel as gk

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    got = smoke.kernel_digests(dev, tk, gk)
    differ = sorted(k for k in set(got) | set(smoke.KERNEL_DIGESTS)
                    if got.get(k) != smoke.KERNEL_DIGESTS.get(k))
    assert not differ, f"digests differ (recorded with {smoke.DIGEST_NVCC}): {differ}"


def _one_step(made):
    state, step_fn, _ = made
    return step_fn(state)[0]


def _kernel_launches():
    n = timing.launch_counts()
    return n["k1"] + sum(v for k, v in n.items() if k.startswith("k2."))


@pytest.mark.parametrize("name", ["render_aovs", "render_channels", "render_color",
                                  "render_loss_grads", "render_scalar_grads",
                                  "render_geometry_grads", "make_inverse_step",
                                  "recover_scene", "ProgressiveRenderer.accumulate",
                                  "FrameStepper.step"])
def test_entry_points_default_to_the_card(dev, name):
    """With a CUDA device, device=None is the current CUDA device: the host-
    built scene and camera render there through the kernels (K1, or the
    product-chain kernel for the diffuse gradient paths). The geometry
    gradients take autograd through the wavefront on any backend, so that
    call launches none and is held to its output's device."""
    from pathtrace_tpu_torch import grad, inverse, progressive, render
    from pathtrace_tpu_torch.interactive import FrameStepper

    cfg = RenderConfig(width=32, height=16, spp=2)
    scene, cam = cornell_box(), Camera.create()
    calls = {
        "render_aovs": lambda: render.render_aovs(scene, cam, cfg)["color"],
        "render_channels": lambda: render.render_channels(scene, cam, cfg),
        "render_color": lambda: grad.render_color(scene, cam, cfg),
        "render_loss_grads": lambda: grad.render_loss_grads(scene, cam, cfg)[0],
        "render_scalar_grads": lambda: grad.render_scalar_grads(scene, cam, cfg)[1][0].color,
        "render_geometry_grads": lambda: grad.render_geometry_grads(scene, cam, cfg)[1][0].radius,
        "make_inverse_step": lambda: _one_step(inverse.make_inverse_step(
            scene, cam, cfg, torch.zeros(16, 32, 3))).params["color"],
        "recover_scene": lambda: inverse.recover_scene(scene, scene, cam, cfg, steps=1)[0].color,
        "ProgressiveRenderer.accumulate": lambda: progressive.ProgressiveRenderer(
            scene, cam, cfg).accumulate(2).aovs()["color"],
        "FrameStepper.step": lambda: torch.from_numpy(
            FrameStepper(scene, cam, cfg, progressive=True).step()).to(dev),
    }
    before = _kernel_launches()
    out = calls[name]()
    torch.cuda.synchronize()
    assert out.device == dev
    if name != "render_geometry_grads":
        assert _kernel_launches() > before


def test_denoiser_on_the_card_equals_the_host_forward(dev, tmp_path):
    """The CNN on cuDNN in f32 (TF32 off) against the same weights on the CPU,
    on a buffer the kernel rendered: within 1e-4."""
    from pathtrace_tpu_torch.models import init_model
    from pathtrace_tpu_torch.models.infer import denoise_channels, load_pretrained
    from pathtrace_tpu_torch.train import save_checkpoint

    save_checkpoint(str(tmp_path), init_model(torch.Generator().manual_seed(0)))
    buf = render_channels(cornell_box(), Camera.create(), RenderConfig(width=96, height=64),
                          device=dev)
    model = load_pretrained(str(tmp_path))
    assert next(model.parameters()).device == dev
    got = denoise_channels(buf, str(tmp_path))
    assert got.device == dev and got.shape == (64, 96, 3)
    want = denoise_channels(buf.cpu(), str(tmp_path))
    assert float((got.cpu() - want).abs().max()) <= 1e-4
