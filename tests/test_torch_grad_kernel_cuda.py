"""The CUDA gradient kernel against its plain PyTorch version on the card.

Every test here needs a CUDA device: they are marked ``cuda`` and skip where
there is none. The file imports only the port, so it also runs on a machine
without JAX; from the root of a checkout:

    python -m pytest tests/test_torch_grad_kernel_cuda.py -m cuda --noconftest -o addopts="" -q

Tolerances are those of ``grad_kernel.agreement``, as in chip_smoke.py:
gradient sums and loss within rtol 1e-4 plus 1e-8 of the largest (the
kernel sums pixels in another order); mean colour off by more than 1e-3 on
<= 1% of pixels; accumulators off by more than 1e-3 of their channel's
range on <= 1% of pixels (a borderline hit decision may round the other
way).
"""

import dataclasses

import pytest
import torch

from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box
from pathtrace_tpu_torch import grad as grad_lib
from pathtrace_tpu_torch import inverse
from pathtrace_tpu_torch.ops import grad_kernel as gk
from pathtrace_tpu_torch.ops import trace_kernel as tk
from pathtrace_tpu_torch.utils import timing

pytestmark = pytest.mark.cuda

CFG = RenderConfig(width=128, height=64, spp=4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _assert_agree(got, ref, kind):
    checks, _ = gk.agreement(got, ref, kind)
    failed = [(name, share, ceiling) for name, share, ceiling, ok in checks if not ok]
    assert not failed, f"share out of tolerance above its ceiling: {failed}"


def _inputs(dev, cfg=CFG, local_h=64):
    g = torch.Generator().manual_seed(0)
    target = torch.rand(local_h, cfg.width, 3, generator=g).to(dev)
    return cornell_box().packed(), tk.camera_block(Camera.create(), cfg), target


@pytest.mark.parametrize("mode", list(gk.MODES))
def test_mode_matches_plain(dev, mode):
    sb, cb, target = _inputs(dev)
    seed = tk.make_seed_block(CFG, 2)
    kw = dict(local_h=64, spp=4, device=dev)
    before = timing.launch_counts()[f"k2.{mode}"]
    if mode == "fused":
        sums, color = gk.fused(sb, cb, seed, CFG, target, **kw)
        ref_sums, ref_color = gk.fused_plain(sb, cb, seed, CFG, target, **kw)
        _assert_agree(sums, ref_sums, "sums")
        _assert_agree(color, ref_color, "color")
    elif mode == "dump":
        cfg = dataclasses.replace(CFG, height=96)
        cb = tk.camera_block(Camera.create(), cfg)
        seed = tk.make_seed_block(cfg, 0, 5, 16)
        color, acc = gk.dump(sb, cb, seed, cfg, **kw)
        ref_color, ref_acc = gk.dump_plain(sb, cb, seed, cfg, **kw)
        assert acc.shape == (64, 128, 54) and acc.device == dev
        _assert_agree(color, ref_color, "color")
        _assert_agree(acc, ref_acc, "acc")
    else:
        ct = (target - 0.5).contiguous()
        _assert_agree(gk.replay(sb, cb, seed, CFG, ct, **kw),
                      gk.replay_plain(sb, cb, seed, CFG, ct, **kw), "sums")
    torch.cuda.synchronize()
    assert timing.launch_counts()[f"k2.{mode}"] == before + 1


def test_fused_is_deterministic_and_modes_agree(dev):
    """Two fused launches give the same bits (no atomics), and fused = dump +
    contraction = replay on one frame."""
    sb, cb, target = _inputs(dev)
    seed = tk.make_seed_block(CFG, 1)
    kw = dict(local_h=64, spp=4, device=dev)
    sums, color = gk.fused(sb, cb, seed, CFG, target, **kw)
    again, _ = gk.fused(sb, cb, seed, CFG, target, **kw)
    assert torch.equal(sums, again)
    color_d, acc = gk.dump(sb, cb, seed, CFG, **kw)
    assert torch.equal(color, color_d)
    d_e, d_c = gk.contract(2.0 * (color_d - target), acc)
    _assert_agree(torch.cat([d_e, d_c], dim=1).reshape(-1), sums[:-1], "sums")
    ct = (2.0 * (color - target) / CFG.spp).contiguous()
    _assert_agree(gk.replay(sb, cb, seed, CFG, ct, **kw)[:-1], sums[:-1], "sums")


@pytest.mark.parametrize("block", [1, 7, 16])
def test_ragged_edges_and_block_sizes(dev, block):
    """Odd frame sizes are bounds-checked: the dump gives the same bits for
    every block edge, and the block sums stay within tolerance."""
    cfg = RenderConfig(width=45, height=37, spp=3, max_bounces=3)
    sb, cb, target = _inputs(dev, cfg, 37)
    seed = tk.make_seed_block(cfg, 4)
    kw = dict(local_h=37, spp=3, device=dev)
    ref_color, ref_acc = gk.dump(sb, cb, seed, cfg, **kw)
    other = dataclasses.replace(cfg, block=block)
    color, acc = gk.dump(sb, cb, seed, other, **kw)
    assert torch.equal(color, ref_color) and torch.equal(acc, ref_acc)
    _assert_agree(gk.fused(sb, cb, seed, other, target, **kw)[0],
                  gk.fused_plain(sb, cb, seed, cfg, target, **kw)[0], "sums")


@pytest.mark.parametrize("mode", ["fused", "replay"])
def test_many_blocks_match_plain(dev, mode):
    """At the main paths' 512x512 frame the second pass sums 4096 block
    partials, 16 to a thread before its tree (8x8 blocks, 256 threads)."""
    cfg = RenderConfig(width=512, height=512, spp=1)
    sb, cb, target = _inputs(dev, cfg, 512)
    seed = tk.make_seed_block(cfg, 6)
    kw = dict(local_h=512, spp=1, device=dev)
    if mode == "fused":
        got = gk.fused(sb, cb, seed, cfg, target, **kw)[0]
        ref = gk.fused_plain(sb, cb, seed, cfg, target, **kw)[0]
    else:
        ct = (target - 0.5).contiguous()
        got = gk.replay(sb, cb, seed, cfg, ct, **kw)
        ref = gk.replay_plain(sb, cb, seed, cfg, ct, **kw)
    _assert_agree(got, ref, "sums")


def test_inverse_step_runs_the_cross_grads(dev):
    """On "cuda" an inverse step is two dump launches and ``cross_grads``;
    its gradients equal autograd of the cross-estimator through
    ``render_color`` (the dump forward, the contraction backward)."""
    scene, cam = cornell_box(), Camera.create()
    cfg = RenderConfig(width=64, height=32, spp=2)
    target = torch.rand(32, 64, 3, generator=torch.Generator().manual_seed(3)).to(dev)
    state, step_fn, _ = inverse.make_inverse_step(scene, cam, cfg, target,
                                                  ("emission", "color"), 1e-3, device=dev)
    before = timing.launch_counts()["k2.dump"]
    _, loss = step_fn(state)
    assert timing.launch_counts()["k2.dump"] == before + 2
    leaves = {k: getattr(scene, k).to(dev).requires_grad_(True) for k in ("emission", "color")}
    s = inverse.apply_params(scene.to(dev), leaves)
    a = grad_lib.render_color(s, cam.to(dev), cfg, 0)
    b = grad_lib.render_color(s, cam.to(dev), cfg, 1)
    loss_ad = torch.mean((a - target) * (b - target))
    loss_ad.backward()
    _assert_agree(loss[None], loss_ad.detach()[None], "sums")
    _assert_agree(torch.cat([state.params["emission"].grad, state.params["color"].grad], 1),
                  torch.cat([leaves["emission"].grad, leaves["color"].grad], 1), "sums")


def test_render_color_backward_is_the_contraction(dev):
    scene, cam = cornell_box(dev), Camera.create(device=dev)
    cfg = RenderConfig(width=64, height=32, spp=2)
    emission = scene.emission.clone().requires_grad_(True)
    color = scene.color.clone().requires_grad_(True)
    position = scene.position.clone().requires_grad_(True)
    s = type(scene)(scene.radius, position, emission, color)
    before = timing.launch_counts()["k2.dump"]
    img = gk.render_color(s, cam, cfg, 3)
    assert timing.launch_counts()["k2.dump"] == before + 1
    ct = torch.rand(img.shape, generator=torch.Generator().manual_seed(1)).to(dev)
    (img * ct).sum().backward()
    _, acc = gk.render_grad_acc(scene, cam, cfg, 3)
    d_e, d_c = gk.contract(ct, acc)
    assert torch.equal(emission.grad, d_e) and torch.equal(color.grad, d_c)
    assert torch.equal(position.grad, torch.zeros_like(position))


def test_loss_grads_entry_points_agree(dev):
    """``render_loss_grads`` (one fused launch) against autograd of the same
    loss through ``render_color`` (one dump launch and the contraction):
    the same trajectories, so the sums rule holds; geometry and camera get
    exact zeros."""
    scene, cam = cornell_box(), Camera.create()
    cfg = RenderConfig(width=32, height=32, spp=4, seed=5)
    target = torch.rand(32, 32, 3, generator=torch.Generator().manual_seed(2)).to(dev)
    before = timing.launch_counts()
    loss, (ds, dc) = grad_lib.render_loss_grads(scene, cam, cfg, 0, target, device=dev)
    assert timing.launch_counts()["k2.fused"] == before["k2.fused"] + 1
    emission = scene.emission.to(dev).requires_grad_(True)
    color = scene.color.to(dev).requires_grad_(True)
    s = type(scene)(scene.radius.to(dev), scene.position.to(dev), emission, color)
    loss_d = grad_lib.l2_image_loss(grad_lib.render_color(s, cam.to(dev), cfg, 0), target)
    loss_d.backward()
    assert timing.launch_counts()["k2.dump"] == before["k2.dump"] + 1
    _assert_agree(loss[None], loss_d.detach()[None], "sums")
    _assert_agree(torch.cat([ds.emission, ds.color], 1).reshape(-1),
                  torch.cat([emission.grad, color.grad], 1).reshape(-1), "sums")
    for z in (ds.position, ds.radius, dc.position, dc.yaw, dc.pitch):
        assert z.device == dev and not z.any()


@pytest.mark.parametrize("extra", [{"nee": True, "brdf": "glossy"}, {"brdf": "glossy"}])
def test_unported_configs_raise_on_cuda(dev, extra):
    """Glossy raised here while K4 was not ported; now it launches the
    forward kernel once and K4 once, and the gradients are finite and reach
    the albedo."""
    cfg = RenderConfig(width=16, height=16, spp=1, **extra)
    before = timing.launch_counts()
    loss, (ds, dc) = grad_lib.render_loss_grads(cornell_box(), Camera.create(), cfg, device=dev)
    assert timing.launch_counts() == {**before, "k1": before["k1"] + 1,
                                      "k4.replay": before["k4.replay"] + 1}
    assert torch.isfinite(loss) and loss > 0
    assert torch.isfinite(ds.color).all() and (ds.color != 0).sum() >= 3
    assert ds.color.device == dev and dc.position.device == dev


@pytest.mark.parametrize("mode", list(gk.MODES))
@pytest.mark.parametrize("block", [5, 8])
def test_sample_lanes_keep_every_bit(dev, mode, block):
    """1, 2 or 4 sample lanes a pixel add their sweeps into its accumulators
    in sample order: every output is the one-lane launch's, bit for bit,
    also in a ragged frame whose blocks hold partial warps."""
    cfg = RenderConfig(width=45, height=37, spp=5, block=block)
    sb, cb, target = _inputs(dev, cfg, 37)
    seed = tk.make_seed_block(cfg, 1, 3)
    kw = dict(local_h=37, spp=5, device=dev)
    px = None if mode == "dump" else (target if mode == "fused" else target / 5)
    ref = gk.CUDA_KERNEL.launch(mode, sb, cb, seed, cfg, px, lanes=1, **kw)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for lanes in (2, 4):
        got = gk.CUDA_KERNEL.launch(mode, sb, cb, seed, cfg, px, lanes=lanes, **kw)
        got = got if isinstance(got, tuple) else (got,)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), f"{lanes} lanes"
