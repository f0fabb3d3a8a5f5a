"""The all-parameter backward kernel (K4) against its plain version on the card.

Every test here needs a CUDA device: they are marked ``cuda`` and skip where
there is none. The file imports only the port, so it also runs on a machine
without JAX; from the root of a checkout:

    python -m pytest tests/test_torch_ad_grad_cuda.py -m cuda --noconftest -o addopts="" -q

Tolerances are those of ``nee_grad_kernel.agreement``, which K4 shares with
the NEE kernel, as in chip_smoke.py: every gradient sum within rtol 1e-4
plus 1e-6 of the largest of its kind (kernel and plain version add each
pixel's terms in the same order and sum over pixels in double); slabs and
sample ranges against the frame 1e-4 of the largest of the kind.
"""

import dataclasses

import pytest
import torch

from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box
from pathtrace_tpu_torch import grad as grad_lib
from pathtrace_tpu_torch.ops import ad_grad_kernel as ak
from pathtrace_tpu_torch.ops import grad_kernel as gk
from pathtrace_tpu_torch.ops import nee_grad_kernel as nk
from pathtrace_tpu_torch.ops import trace_kernel as tk

pytestmark = pytest.mark.cuda

W, H, SPP = 128, 64, 4
CONFIGS = [("diffuse", False), ("diffuse", True), ("glossy", False), ("glossy", True)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _cfg(brdf, nee, **kw):
    return RenderConfig(**{**dict(width=W, height=H, spp=SPP, brdf=brdf, nee=nee), **kw})


def _assert_agree(got, ref, atol=nk.SUMS_ATOL):
    checks, _ = ak.agreement(got, ref, "sums", atol)
    failed = [(name, share, ceiling) for name, share, ceiling, ok in checks if not ok]
    assert not failed, f"share out of tolerance above its ceiling: {failed}"


def _cotangent(dev, channels, h=H, seed=0):
    """[10, h, W] with normal noise in ``channels`` (depth scaled to its
    units, ~1e4) and zeros elsewhere."""
    g = torch.Generator().manual_seed(seed)
    ct = torch.zeros(ak.NUM_CT, h, W)
    for k in channels:
        ct[k] = torch.randn(h, W, generator=g) * (1e-4 if k == 9 else 1.0)
    return ct.to(dev)


def _blocks(cfg):
    return cornell_box().packed(), tk.camera_block(Camera.create(), cfg)


@pytest.mark.parametrize("channels", [(0, 1, 2), (3, 4, 5), (6, 7, 8), (9,), tuple(range(10))],
                         ids=["colour", "normal", "albedo", "depth", "all"])
@pytest.mark.parametrize("brdf,nee", CONFIGS)
def test_kernel_matches_plain(dev, brdf, nee, channels):
    cfg = _cfg(brdf, nee)
    sb, cb = _blocks(cfg)
    ct = _cotangent(dev, channels)
    seed = tk.make_seed_block(cfg, 2)
    kw = dict(local_h=H, spp=SPP, device=dev)
    before = ak.CUDA_KERNEL.launches
    got = ak.replay(sb, cb, seed, cfg, ct, **kw)
    assert ak.CUDA_KERNEL.launches == before + 1
    ref = ak.replay_plain(sb, cb, seed, cfg, ct, **kw)
    _assert_agree(got, ref)
    assert got.abs().max() > 0 and got[-1] == 0
    if not nee and channels == (0, 1, 2):  # the colour does not depend on geometry
        block = ak.block_from_sums(got)
        assert not block[:9, :4].any() and not block[9:, :3].any()


@pytest.mark.parametrize("brdf,nee", CONFIGS)
def test_offsets_add_up_and_match_plain(dev, brdf, nee):
    """Two row slabs x two sample ranges, each equal to its plain version,
    sum to the frame's block."""
    cfg = _cfg(brdf, nee)
    scene, cam = cornell_box(), Camera.create()
    ct = _cotangent(dev, range(10), seed=1)
    whole = ak.ad_grads_block_slab(scene, cam, cfg, 4, ct, device=dev)
    parts = 0
    for row in (0, 32):
        for offset, spp in ((0, 3), (3, 1)):
            part_ct = ct[:, row:row + 32].contiguous()
            part = ak.ad_grads_block_slab(scene, cam, cfg, 4, part_ct, row_offset=row,
                                          local_h=32, spp=spp, sample_offset=offset, device=dev)
            sb, cb = _blocks(cfg)
            ref = ak.replay_plain(sb, cb, tk.make_seed_block(cfg, 4, offset, row), cfg, part_ct,
                                  local_h=32, spp=spp, device=dev)
            _assert_agree(_flat(part), ref)
            parts = parts + part
    _assert_agree(_flat(parts), _flat(whole), ak.CROSS_ATOL)


def _flat(block):
    return torch.cat([block[:9, :10].reshape(-1), block[9, :3], block[10:14, :3].reshape(-1),
                      block[9, 10:11]])


@pytest.mark.parametrize("brdf,nee", CONFIGS)
def test_two_launches_give_the_same_bits(dev, brdf, nee):
    cfg = _cfg(brdf, nee, spp=32)
    sb, cb = _blocks(cfg)
    ct = _cotangent(dev, range(10), seed=2)
    kw = dict(local_h=H, spp=32, device=dev)
    seed = tk.make_seed_block(cfg, 1)
    assert torch.equal(ak.replay(sb, cb, seed, cfg, ct, **kw),
                       ak.replay(sb, cb, seed, cfg, ct, **kw))


def test_equals_the_nee_kernel_on_nee_diffuse(dev):
    """With a colour-only cotangent on NEE diffuse K4 runs the NEE kernel's
    replay plus additions of zero: the same sums, bit for bit."""
    cfg = _cfg("diffuse", True)
    sb, cb = _blocks(cfg)
    ct = _cotangent(dev, (0, 1, 2), seed=3)
    kw = dict(local_h=H, spp=SPP, device=dev)
    seed = tk.make_seed_block(cfg, 5)
    k3 = nk.replay(sb, cb, seed, cfg, ct[:3].permute(1, 2, 0).contiguous(), **kw)
    assert torch.equal(ak.replay(sb, cb, seed, cfg, ct, **kw), k3)


@pytest.mark.parametrize("block", [1, 7, 16])
def test_ragged_edges_and_block_sizes(dev, block):
    cfg = dataclasses.replace(_cfg("glossy", True), width=37, height=21, block=block)
    sb, cb = _blocks(cfg)
    g = torch.Generator().manual_seed(4)
    ct = torch.randn(ak.NUM_CT, 21, 37, generator=g).to(dev)
    ct[9] *= 1e-4
    kw = dict(local_h=21, spp=SPP, device=dev)
    seed = tk.make_seed_block(cfg, 0)
    _assert_agree(ak.replay(sb, cb, seed, cfg, ct, **kw),
                  ak.replay_plain(sb, cb, seed, cfg, ct, **kw))


@pytest.mark.parametrize("nee", [False, True])
def test_entry_points_launch_the_kernels(dev, nee):
    """``render_loss_grads`` for glossy: one colour-sum launch of the forward
    kernel and one K4 launch; ``cross_grads``: two and two. Neither touches
    the product-chain or the NEE kernel."""
    cfg = RenderConfig(width=64, height=32, spp=2, brdf="glossy", nee=nee)
    scene, cam = cornell_box(), Camera.create()
    target = torch.rand(32, 64, 3, generator=torch.Generator().manual_seed(5)).to(dev)

    def counts():
        return (tk.CUDA_KERNEL.launches, ak.CUDA_KERNEL.launches,
                dict(nk.CUDA_KERNEL.launches), dict(gk.CUDA_KERNEL.launches))

    before = counts()
    loss, (ds, dc) = grad_lib.render_loss_grads(scene, cam, cfg, 0, target, device=dev)
    after = counts()
    assert after[0] == before[0] + 1 and after[1] == before[1] + 1
    assert after[2:] == before[2:]
    # The same by hand, the replay through the plain version on the card.
    diff = tk.render_color_sums(scene, cam, cfg, 0, device=dev) / cfg.spp - target
    denom = diff.numel()
    ct = ak.pack_cotangents(cfg, 2.0 * diff / denom, device=dev)
    sb, cb = _blocks(cfg)
    ref = ak.block_from_sums(ak.replay_plain(sb, cb, tk.make_seed_block(cfg, 0), cfg, ct,
                                             local_h=32, spp=2, device=dev))
    assert torch.equal(loss, torch.sum(diff * diff) / denom)
    for name, cols in (("radius", 0), ("position", slice(1, 4)), ("emission", slice(4, 7)),
                       ("color", slice(7, 10))):
        want = ref[:9, cols]
        torch.testing.assert_close(getattr(ds, name), want, rtol=1e-4,
                                   atol=1e-6 * float(want.abs().max()))
    assert dc.position.device == dev

    before = counts()
    loss, d = gk.cross_grads(scene, cam, cfg, 0, target, device=dev)
    after = counts()
    assert after[0] == before[0] + 2 and after[1] == before[1] + 2
    assert after[2:] == before[2:]
    assert set(d) == {"emission", "color", "position", "radius"}
    assert all(torch.isfinite(g).all() for g in d.values()) and torch.isfinite(loss)


@pytest.mark.parametrize("bad", ["spheres", "bounces", "shape", "device"])
def test_wrapper_rejects_bad_input(dev, bad):
    cfg = RenderConfig(width=8, height=8, spp=1, brdf="glossy")
    sb, cb = _blocks(cfg)
    ct = torch.zeros(ak.NUM_CT, 8, 8, device=dev)
    if bad == "spheres":
        sb = torch.cat([sb, sb[:3]])
    elif bad == "bounces":
        cfg = dataclasses.replace(cfg, max_bounces=ak.MAX_BOUNCES + 1)
    elif bad == "shape":
        ct = torch.zeros(8, 8, ak.NUM_CT, device=dev)
    elif bad == "device":
        ct = ct.cpu()
    with pytest.raises(ValueError):
        ak.replay(sb, cb, tk.make_seed_block(cfg), cfg, ct, local_h=8, spp=1, device=dev)
