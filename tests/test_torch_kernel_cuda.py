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
    before = tk.CUDA_KERNEL.launches
    got = tk.trace(sb, cb, seed, cfg, local_h=64, spp=4, mode=mode, device=dev)
    torch.cuda.synchronize()
    assert tk.CUDA_KERNEL.launches == before + 1
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
    before = tk.CUDA_KERNEL.launches
    buf = render_channels(cornell_box(), Camera.create(), cfg, device=dev)
    assert tk.CUDA_KERNEL.launches == before + 1
    assert buf.device == dev and buf.shape == (32, 64, 14)
    sb, cb = _host_blocks(cfg)
    _assert_close(buf, tk.trace_plain(sb, cb, tk.make_seed_block(cfg), cfg, local_h=32, spp=2,
                                      mode="channels", device=dev), "channels", 2)
    torch_buf = render_channels(cornell_box(), Camera.create(),
                                dataclasses.replace(cfg, backend="torch"), device=dev)
    assert tk.CUDA_KERNEL.launches == before + 1
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
