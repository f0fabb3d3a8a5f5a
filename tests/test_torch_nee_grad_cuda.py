"""The NEE gradient kernel and the f32 probes against their plain versions on the card.

Every test here needs a CUDA device: they are marked ``cuda`` and skip where
there is none. The file imports only the port, so it also runs on a machine
without JAX; from the root of a checkout:

    python -m pytest tests/test_torch_nee_grad_cuda.py -m cuda --noconftest -o addopts="" -q

Tolerances are those of ``nee_grad_kernel.agreement``, as in chip_smoke.py:
every gradient sum within rtol 1e-4 plus 1e-6 of the largest of its kind
(kernel and plain version add each pixel's terms in the same order and sum
over pixels in double); where two orders of operations meet (replay against
fused) 1e-4 of the largest of the kind;
mean colour off by more than 1e-3 on <= 1% of pixels. The probes: within
1e-6 of the largest value (the plain version's fused steps round through
double).
"""

import dataclasses

import pytest
import torch

from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box
from pathtrace_tpu_torch import grad as grad_lib
from pathtrace_tpu_torch import inverse
from pathtrace_tpu_torch.ops import grad_kernel as gk
from pathtrace_tpu_torch.ops import nee_grad_kernel as nk
from pathtrace_tpu_torch.ops import trace_kernel as tk
from pathtrace_tpu_torch.utils import roofline as rf

pytestmark = pytest.mark.cuda

CFG = RenderConfig(width=128, height=64, spp=4, nee=True)
CROSS_ATOL = nk.CROSS_ATOL


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _assert_agree(got, ref, kind="sums", atol=None):
    checks, _ = nk.agreement(got, ref, kind, nk.SUMS_ATOL if atol is None else atol)
    failed = [(name, share, ceiling) for name, share, ceiling, ok in checks if not ok]
    assert not failed, f"share out of tolerance above its ceiling: {failed}"


def _inputs(dev, cfg=CFG, local_h=64):
    g = torch.Generator().manual_seed(0)
    target = torch.rand(local_h, cfg.width, 3, generator=g).to(dev)
    return cornell_box().packed(), tk.camera_block(Camera.create(), cfg), target


@pytest.mark.parametrize("offsets", [(2,), (0, 5, 16)])
@pytest.mark.parametrize("mode", ["fused", "replay"])
def test_mode_matches_plain(dev, mode, offsets):
    cfg = CFG if len(offsets) == 1 else dataclasses.replace(CFG, height=96)
    sb, cb, target = _inputs(dev, cfg)
    seed = tk.make_seed_block(cfg, *offsets)
    kw = dict(local_h=64, spp=4, device=dev)
    before = nk.CUDA_KERNEL.launches[mode]
    if mode == "fused":
        sums, color = nk.fused(sb, cb, seed, cfg, target, **kw)
        ref_sums, ref_color = nk.fused_plain(sb, cb, seed, cfg, target, **kw)
        _assert_agree(sums, ref_sums)
        _assert_agree(color, ref_color, "color")
    else:
        ct = ((target - 0.5) / 4).contiguous()
        _assert_agree(nk.replay(sb, cb, seed, cfg, ct, **kw),
                      nk.replay_plain(sb, cb, seed, cfg, ct, **kw))
    torch.cuda.synchronize()
    assert nk.CUDA_KERNEL.launches[mode] == before + 1


def test_fused_is_deterministic_and_modes_agree(dev):
    """Two fused launches give the same bits (no atomics); replay against the
    MSE cotangent = fused; the fused colour is the trace kernel's NEE colour
    bit for bit."""
    sb, cb, target = _inputs(dev)
    seed = tk.make_seed_block(CFG, 1)
    kw = dict(local_h=64, spp=4, device=dev)
    sums, color = nk.fused(sb, cb, seed, CFG, target, **kw)
    again, _ = nk.fused(sb, cb, seed, CFG, target, **kw)
    assert torch.equal(sums, again)
    k1 = tk.trace(sb, cb, seed, CFG, mode="color", **kw) * tk._f32(1.0 / 4)
    assert torch.equal(color, k1)
    ct = (2.0 * (color - target) / CFG.spp).contiguous()
    replayed = nk.replay(sb, cb, seed, CFG, ct, **kw)
    _assert_agree(torch.cat([replayed[:-1], sums[-1:]]), sums, atol=CROSS_ATOL)


def test_long_sample_loop_matches_plain_to_the_bit(dev):
    """At 32 spp each pixel's geometry sums run through 32 x 5 compensated
    adds. The kernel equals the plain version bit for bit, so the compiler
    kept the Kahan term (t - s) - y as written."""
    cfg = dataclasses.replace(CFG, spp=32)
    sb, cb, target = _inputs(dev, cfg)
    seed = tk.make_seed_block(cfg, 3)
    ct = ((target - 0.5) / 32).contiguous()
    kw = dict(local_h=64, spp=32, device=dev)
    assert torch.equal(nk.replay(sb, cb, seed, cfg, ct, **kw),
                       nk.replay_plain(sb, cb, seed, cfg, ct, **kw))


@pytest.mark.parametrize("block", [1, 7, 16])
def test_ragged_edges_and_block_sizes(dev, block):
    """Odd frame sizes are bounds-checked, and every block edge agrees with
    the plain version (the pixel sums are exact to the last rounding, so the
    block shape moves nothing beyond it)."""
    cfg = RenderConfig(width=45, height=37, spp=3, max_bounces=3, nee=True, block=block)
    sb, cb, target = _inputs(dev, cfg, 37)
    seed = tk.make_seed_block(cfg, 4)
    kw = dict(local_h=37, spp=3, device=dev)
    ct = ((target - 0.5) / 3).contiguous()
    _assert_agree(nk.replay(sb, cb, seed, cfg, ct, **kw),
                  nk.replay_plain(sb, cb, seed, cfg, ct, **kw))
    sums, color = nk.fused(sb, cb, seed, cfg, target, **kw)
    ref, ref_color = nk.fused_plain(sb, cb, seed, cfg, target, **kw)
    _assert_agree(sums, ref)
    assert torch.equal(color, ref_color)


def test_refuses_a_block_beyond_shared_memory(dev):
    """16 spheres need 254 accumulator floats a thread: 260 KB a 16x16 block."""
    cfg = dataclasses.replace(CFG, block=16)
    sb, cb, target = _inputs(dev, cfg)
    with pytest.raises(ValueError, match="shared memory"):
        nk.fused(torch.cat([sb, sb[:7]]), cb, tk.make_seed_block(cfg), cfg, target, local_h=64,
                 spp=4, device=dev)


def test_many_blocks_match_plain(dev):
    """At the main path's 512x512 frame the second pass sums 4096 block
    partials in double."""
    cfg = RenderConfig(width=512, height=512, spp=1, nee=True)
    sb, cb, target = _inputs(dev, cfg, 512)
    seed = tk.make_seed_block(cfg, 6)
    kw = dict(local_h=512, spp=1, device=dev)
    _assert_agree(nk.fused(sb, cb, seed, cfg, target, **kw)[0],
                  nk.fused_plain(sb, cb, seed, cfg, target, **kw)[0])


def test_loss_grads_is_one_fused_launch(dev):
    """``render_loss_grads`` under NEE: exactly one NEE fused launch, nothing
    else; every gradient block on the device, finite and non-zero; equal to
    autograd of the same loss through ``render_color`` (the trace kernel
    forward, one replay backward)."""
    scene, cam = cornell_box(), Camera.create()
    cfg = RenderConfig(width=64, height=32, spp=4, seed=5, nee=True)
    target = torch.rand(32, 64, 3, generator=torch.Generator().manual_seed(2)).to(dev)
    before = (dict(nk.CUDA_KERNEL.launches), dict(gk.CUDA_KERNEL.launches),
              tk.CUDA_KERNEL.launches)
    loss, (ds, dc) = grad_lib.render_loss_grads(scene, cam, cfg, 0, target, device=dev)
    assert nk.CUDA_KERNEL.launches["fused"] == before[0]["fused"] + 1
    assert nk.CUDA_KERNEL.launches["replay"] == before[0]["replay"]
    assert gk.CUDA_KERNEL.launches == before[1] and tk.CUDA_KERNEL.launches == before[2]
    blocks = [ds.radius, ds.position, ds.emission, ds.color, dc.position, dc.yaw, dc.pitch]
    for g in blocks:
        assert g.device == dev and torch.isfinite(g).all() and g.abs().max() > 0
    leaves = [getattr(scene, k).to(dev).requires_grad_(True)
              for k in ("radius", "position", "emission", "color")]
    cam_leaves = [x.to(dev).requires_grad_(True) for x in (cam.position, cam.yaw, cam.pitch)]
    img = grad_lib.render_color(type(scene)(*leaves), Camera(*cam_leaves), cfg, 0)
    loss_d = grad_lib.l2_image_loss(img, target)
    loss_d.backward()
    assert nk.CUDA_KERNEL.launches["replay"] == before[0]["replay"] + 1
    torch.testing.assert_close(loss, loss_d.detach(), rtol=1e-5, atol=0)
    for g, leaf in zip(blocks, leaves + cam_leaves):
        torch.testing.assert_close(g, leaf.grad, rtol=1e-3, atol=1e-4 * float(g.abs().max()))


def test_nee_inverse_step_launches_two_trace_and_two_replay(dev):
    """On "cuda" an NEE inverse step is two colour-sum launches of the trace
    kernel and two NEE replays, with scheduled rates; the masked sphere alone
    moves."""
    scene, cam = cornell_box(), Camera.create()
    cfg = RenderConfig(width=64, height=32, spp=2, nee=True)
    target = torch.rand(32, 64, 3, generator=torch.Generator().manual_seed(3)).to(dev)
    mask = torch.zeros(9, 1)
    mask[6] = 1.0
    state, step_fn, opt = inverse.make_inverse_step(
        scene, cam, cfg, target, ("position",),
        {"position": inverse.exponential_decay(0.5, 2, 0.25)},
        grad_mask={"position": mask}, device=dev)
    for want_lr in (0.5, 0.25):
        before = (tk.CUDA_KERNEL.launches, dict(nk.CUDA_KERNEL.launches),
                  dict(gk.CUDA_KERNEL.launches))
        state, loss = step_fn(state)
        assert tk.CUDA_KERNEL.launches == before[0] + 2
        assert nk.CUDA_KERNEL.launches["replay"] == before[1]["replay"] + 2
        assert nk.CUDA_KERNEL.launches["fused"] == before[1]["fused"]
        assert gk.CUDA_KERNEL.launches == before[2]
        assert opt.param_groups[0]["lr"] == pytest.approx(want_lr)
        assert torch.isfinite(loss)
    moved = (state.params["position"].detach().cpu() != scene.position).any(dim=1)
    assert moved.tolist() == [i == 6 for i in range(9)]


@pytest.mark.parametrize("extra", [{"nee": True, "brdf": "glossy"}, {"brdf": "glossy"}])
def test_glossy_still_raises_naming_its_kernel(dev, extra):
    """Glossy raised here, naming K4, while that kernel was not ported. Now a
    glossy inverse step launches the forward kernel twice and K4 twice, and
    neither the NEE kernel nor the product-chain kernel."""
    from pathtrace_tpu_torch.ops import ad_grad_kernel as ak

    cfg = RenderConfig(width=16, height=16, spp=1, **extra)
    scene, cam = cornell_box(), Camera.create()
    target = torch.rand(16, 16, 3, generator=torch.Generator().manual_seed(1)).to(dev)
    state, step_fn, _ = inverse.make_inverse_step(scene, cam, cfg, target,
                                                  ("color", "position"), device=dev)
    before = (tk.CUDA_KERNEL.launches, ak.CUDA_KERNEL.launches, dict(nk.CUDA_KERNEL.launches),
              dict(gk.CUDA_KERNEL.launches))
    state, loss = step_fn(state)
    assert tk.CUDA_KERNEL.launches == before[0] + 2
    assert ak.CUDA_KERNEL.launches == before[1] + 2
    assert nk.CUDA_KERNEL.launches == before[2] and gk.CUDA_KERNEL.launches == before[3]
    assert torch.isfinite(loss)
    assert (state.params["color"].detach().cpu() != scene.color).any()


@pytest.mark.parametrize("mode", rf.LATENCY_MODES)
def test_latency_chain_matches_plain(dev, mode):
    x, a = rf.probe_inputs(8, dev)
    x = x + 0.1 * torch.rand(x.shape, generator=torch.Generator().manual_seed(0)).to(dev)
    before = rf.CUDA_KERNEL.launches["latency"]
    got = rf.latency_chain(x, a, mode, 2)
    assert rf.CUDA_KERNEL.launches["latency"] == before + 1
    ref = rf.chain_plain(x, a, mode, 2, 1)
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


@pytest.mark.parametrize("fma", [True, False])
def test_peak_chain_matches_plain(dev, fma):
    x, a = rf.probe_inputs(8, dev)
    x = x + 0.1 * torch.rand(x.shape, generator=torch.Generator().manual_seed(1)).to(dev)
    before = rf.CUDA_KERNEL.launches["peak"]
    got = rf.peak_chain(x, a, fma, 2)
    assert rf.CUDA_KERNEL.launches["peak"] == before + 1
    ref = rf.chain_plain(x, a, "fma" if fma else "mul", 2, rf.PEAK_CHAINS)
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


def test_probe_readings_are_plausible(dev):
    """The readings at a reduced depth: a positive rate with FMA credited at
    least once and at most twice the multiply rate's steps, and a two-
    instruction step well above a one-instruction step (measured: 4.13 ns
    for a multiply then an add against 2.08 for a multiply, 2.56 for an FMA)."""
    peaks = rf.measure_f32_peak(iters=32, grid=256, reps=2, device=dev)
    assert 0 < peaks["peak_mul_flops"] < 1e14
    assert 0.9 * peaks["peak_mul_flops"] < peaks["peak_fma_flops"] < 2.2 * peaks["peak_mul_flops"]
    lat = rf.latency_probe(iters=8192, reps=3, device=dev)
    assert set(lat) == set(rf.LATENCY_MODES) and all(v > 0 for v in lat.values())
    assert lat["mul_then_add"] > 1.5 * lat["mul"] and lat["add_add"] > 1.5 * lat["add"]
    assert lat["mul_then_add"] > 1.2 * lat["fma"] and lat["fma_fma"] > 1.5 * lat["fma"]
