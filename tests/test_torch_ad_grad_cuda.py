"""The all-parameter backward kernel (K4) against its plain version on the card.

Every test here needs a CUDA device: they are marked ``cuda`` and skip where
there is none. The file imports only the port, so it also runs on a machine
without JAX; from the root of a checkout:

    python -m pytest tests/test_torch_ad_grad_cuda.py -m cuda --noconftest -o addopts="" -q

Tolerances are those of ``sweep.agreement``, which K4 shares with
the NEE kernel, as in chip_smoke.py: every gradient sum within rtol 1e-4
plus 1e-6 of the largest of its kind (kernel and plain version add each
lane group's terms in the same order and sum over groups in double); slabs and
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
from pathtrace_tpu_torch.ops import sweep
from pathtrace_tpu_torch.ops import trace_kernel as tk
from pathtrace_tpu_torch.utils import timing

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


def _assert_agree(got, ref, atol=sweep.SUMS_ATOL):
    checks, _ = sweep.agreement(got, ref, "sums", atol)
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
    before = timing.launch_counts()
    got = ak.replay(sb, cb, seed, cfg, ct, **kw)
    assert timing.launch_counts() == {**before, "k4.replay": before["k4.replay"] + 1}
    ref = ak.replay_plain(sb, cb, seed, cfg, ct, **kw)
    _assert_agree(got, ref)
    assert got.abs().max() > 0 and got[-1] == 0
    if not nee and channels == (0, 1, 2):  # the colour does not depend on geometry
        block = sweep.block_from_sums(got)
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
    _assert_agree(_flat(parts), _flat(whole), sweep.CROSS_ATOL)


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
    kernel and one K4 launch; ``cross_grads``: two and two, its K4 replays
    taped under NEE (one slab at this size) and retracing without. Neither
    touches the product-chain or the NEE kernel."""
    cfg = RenderConfig(width=64, height=32, spp=2, brdf="glossy", nee=nee)
    scene, cam = cornell_box(), Camera.create()
    target = torch.rand(32, 64, 3, generator=torch.Generator().manual_seed(5)).to(dev)

    def counts():
        n = timing.launch_counts()
        return (n["k1"], n["k4.replay"],
                {k: v for k, v in n.items() if k.startswith(("k2.", "k3."))})

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
    ref = sweep.block_from_sums(ak.replay_plain(sb, cb, tk.make_seed_block(cfg, 0), cfg, ct,
                                             local_h=32, spp=2, device=dev))
    assert torch.equal(loss, torch.sum(diff * diff) / denom)
    for name, cols in (("radius", 0), ("position", slice(1, 4)), ("emission", slice(4, 7)),
                       ("color", slice(7, 10))):
        want = ref[:9, cols]
        torch.testing.assert_close(getattr(ds, name), want, rtol=1e-4,
                                   atol=1e-6 * float(want.abs().max()))
    assert dc.position.device == dev

    before = counts()
    taped = timing.launch_counts()["k4.replay_taped"]
    loss, d = gk.cross_grads(scene, cam, cfg, 0, target, device=dev)
    after = counts()
    assert after[0] == before[0] + 2 and after[1] == before[1] + 2
    assert timing.launch_counts()["k4.replay_taped"] == taped + (2 if nee else 0)
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
        cfg = dataclasses.replace(cfg, max_bounces=sweep.MAX_BOUNCES + 1)
    elif bad == "shape":
        ct = torch.zeros(8, 8, ak.NUM_CT, device=dev)
    elif bad == "device":
        ct = ct.cpu()
    with pytest.raises(ValueError):
        ak.replay(sb, cb, tk.make_seed_block(cfg), cfg, ct, local_h=8, spp=1, device=dev)


# -- the shading-only instance, the colour-only cotangent and the lane groups ---------

@pytest.mark.parametrize("brdf", ["diffuse", "glossy"])
def test_shading_only_instance_equals_the_full_one_and_plain(dev, brdf):
    """A colour-only cotangent [3, h, W] without NEE runs the shading-only
    instance: the full instance's sums bit for bit (seven planes of zeros),
    exact zeros in the geometry and camera entries, its plain version under
    ``agreement``, and the same bits when launched twice."""
    cfg = _cfg(brdf, False)
    sb, cb = _blocks(cfg)
    seed = tk.make_seed_block(cfg, 2)
    kw = dict(local_h=H, spp=SPP, device=dev)
    full = _cotangent(dev, (0, 1, 2))
    only = full[:3].contiguous()
    assert not ak.instance(cfg, 3)["geom"] and ak.instance(cfg, 10)["geom"]
    got = ak.replay(sb, cb, seed, cfg, only, **kw)
    assert torch.equal(got, ak.replay(sb, cb, seed, cfg, full, **kw))
    assert torch.equal(got, ak.replay(sb, cb, seed, cfg, only, **kw))
    _assert_agree(got, ak.replay_plain(sb, cb, seed, cfg, only, **kw))
    block = sweep.block_from_sums(got)
    assert got.abs().max() > 0
    assert not block[:9, :4].any() and not block[9:, :3].any()


@pytest.mark.parametrize("brdf", ["diffuse", "glossy"])
def test_colour_only_cotangent_under_nee(dev, brdf):
    """Under NEE three planes give what ten with zeros give, bit for bit; on
    NEE diffuse that is also the NEE kernel's replay."""
    cfg = _cfg(brdf, True)
    sb, cb = _blocks(cfg)
    seed = tk.make_seed_block(cfg, 2)
    kw = dict(local_h=H, spp=SPP, device=dev)
    full = _cotangent(dev, (0, 1, 2))
    only = full[:3].contiguous()
    got = ak.replay(sb, cb, seed, cfg, only, **kw)
    assert torch.equal(got, ak.replay(sb, cb, seed, cfg, full, **kw))
    _assert_agree(got, ak.replay_plain(sb, cb, seed, cfg, only, **kw))
    assert sweep.block_from_sums(got)[:9, :4].abs().max() > 0
    if brdf == "diffuse":
        k3 = nk.replay(sb, cb, seed, cfg, only.permute(1, 2, 0).contiguous(), **kw)
        assert torch.equal(got, k3)


@pytest.mark.parametrize("block", [3, 5, 7, 16])
@pytest.mark.parametrize("brdf,nee,channels", [("glossy", False, 3), ("glossy", True, 10)])
def test_lane_groups_at_other_blocks_and_ragged_frames(dev, brdf, nee, channels, block):
    """Lane pairs at block edges that leave the last thread without a
    partner (3 x 3, 5 x 5, 7 x 7), at the largest block, and on a frame whose last
    blocks hang over both edges: the plain version follows the kernel's
    groups."""
    cfg = RenderConfig(width=123, height=61, spp=SPP, brdf=brdf, nee=nee, block=block)
    sb, cb = _blocks(cfg)
    seed = tk.make_seed_block(cfg, 2)
    ct = _cotangent(dev, range(channels))[:channels, :61, :123].contiguous()
    kw = dict(local_h=61, spp=SPP, device=dev)
    got = ak.replay(sb, cb, seed, cfg, ct, **kw)
    _assert_agree(got, ak.replay_plain(sb, cb, seed, cfg, ct, **kw))
    assert torch.equal(got, ak.replay(sb, cb, seed, cfg, ct, **kw))


# -- the path tape: K1's taped NEE glossy colour pass writes it, K4's taped replay reads it

def _assert_taped_is_untaped(sb, cb, seed, cfg, ct, *, local_h, spp, device):
    """K1's taped NEE glossy colour sums and K4's taped replay give their
    untaped launches' bits, one launch each, the replay counted as a replay
    and as a taped one; a second taped replay of the same tape gives the
    same bits again."""
    kw = dict(local_h=local_h, spp=spp, device=device)
    retraced = ak.replay(sb, cb, seed, cfg, ct, **kw)
    tape = sweep.PathTape.empty(cfg, local_h, spp, device)
    before = timing.launch_counts()
    color = tk.trace(sb, cb, seed, cfg, mode="color", tape=tape, **kw)
    taped = ak.replay(sb, cb, seed, cfg, ct, tape=tape, **kw)
    torch.cuda.synchronize()
    assert tape.written and timing.launch_counts() == {
        **before, "k1": before["k1"] + 1, "k4.replay": before["k4.replay"] + 1,
        "k4.replay_taped": before["k4.replay_taped"] + 1}
    assert torch.equal(color, tk.trace(sb, cb, seed, cfg, mode="color", **kw))
    assert torch.equal(taped, retraced)
    assert torch.equal(ak.replay(sb, cb, seed, cfg, ct, tape=tape, **kw), taped)


@pytest.mark.parametrize("row_offset, local_h", [(0, 37), (11, 19)], ids=["frame", "slab"])
@pytest.mark.parametrize("block", [3, 5, 7, 8, 16])
def test_taped_glossy_replay_is_the_retracing_replay(dev, block, row_offset, local_h):
    """On a ragged frame (45 x 37: blocks hang over both edges at 3, 5 and
    16) and on a slab of 19 rows at row 11, the taped NEE glossy colour pass
    and K4's taped replay give the untaped launches' bits."""
    cfg = RenderConfig(width=45, height=37, spp=3, max_bounces=4, nee=True, brdf="glossy",
                       block=block)
    sb, cb = _blocks(cfg)
    g = torch.Generator().manual_seed(block)
    ct = torch.randn(ak.NUM_CT_COLOR, local_h, 45, generator=g).to(dev)
    _assert_taped_is_untaped(sb, cb, tk.make_seed_block(cfg, 4, 0, row_offset), cfg, ct,
                             local_h=local_h, spp=3, device=dev)


def test_taped_glossy_replay_at_the_cell_size(dev):
    """At the glossy cell's 512x512x32 and 5 bounces a step plans two slabs
    of 256 rows; the second (1.43 GB of tape) gives the untaped bits in K1
    and in K4."""
    cfg = RenderConfig(width=512, height=512, spp=32, nee=True, brdf="glossy")
    assert sweep.slab_rows(cfg) == 256 and sweep.tape_bytes(cfg, 256, 32) == 1_426_063_360
    sb, cb = _blocks(cfg)
    g = torch.Generator().manual_seed(9)
    ct = (torch.randn(ak.NUM_CT_COLOR, 256, 512, generator=g) / (512 * 512 * 3 * 32)).to(dev)
    _assert_taped_is_untaped(sb, cb, tk.make_seed_block(cfg, 7, 0, 256), cfg, ct, local_h=256,
                             spp=32, device=dev)


def test_glossy_step_at_the_cell_size_tapes_two_slabs(dev, monkeypatch):
    """``cross_grads`` at the glossy cell's 512x512x32 runs two slabs of 256
    rows, each two taped K1 colour passes and two taped K4 replays:
    ``k4.replay_taped`` reads four, and no K4 launch of the step retraces.
    With ``TAPE_BUDGET`` at 0 it retraces in one slab: the same loss to the
    bit, each gradient within 1e-6 of its field's largest (the slabs' sums
    add in another order)."""
    cfg = RenderConfig(width=512, height=512, spp=32, nee=True, brdf="glossy")
    scene, cam = cornell_box(), Camera.create()
    target = torch.full((512, 512, 3), 0.25, device=dev)

    def run():
        timing.start_recording()
        out = gk.cross_grads(scene, cam, cfg, 1, target, device=dev)
        torch.cuda.synchronize()
        return out, timing.stop_recording().launches

    (loss, d), n = run()
    assert (n["k1"], n["k4.replay"], n["k4.replay_taped"]) == (4, 4, 4)
    monkeypatch.setattr(sweep, "TAPE_BUDGET", 0)
    (re_loss, re_d), n = run()
    assert (n["k1"], n["k4.replay"], n["k4.replay_taped"]) == (2, 2, 0)
    assert torch.equal(loss, re_loss)
    for name, g in d.items():
        torch.testing.assert_close(g, re_d[name], rtol=1e-6,
                                   atol=1e-6 * float(re_d[name].abs().max()), msg=name)


# Views in which a pair's two lanes add to one slot at every first bounce
# (the winner's share of ``sweep.lane_pair_shares`` there): close to the back
# wall every primary ray hits it; under the light, facing up, half of them
# hit the light, whose slots both lanes' light terms reach.
VIEWS = {"wall": (dict(position=(50.0, 40.0, 3.0)), "same", 1.0),
         "light": (dict(position=(20.0, 40.0, 81.6), pitch=89.0), "light", 0.3)}


@pytest.mark.parametrize("block", [7, 8])
@pytest.mark.parametrize("view", list(VIEWS))
def test_owner_pass_where_the_lanes_meet_in_a_slot(dev, view, block):
    """Where both lanes of most pairs hit one sphere, or one of them the
    light, K4's NEE glossy pass adds both lanes' terms (and the light's) to
    one slot in turn order; at 7 x 7 each block's last thread owns its group
    alone. The retracing and the taped replay equal the plain version bit
    for bit."""
    pose, share, least = VIEWS[view]
    cfg = RenderConfig(width=56, height=56, spp=SPP, nee=True, brdf="glossy", block=block)
    sb, cb = cornell_box().packed(), tk.camera_block(Camera.create(**pose), cfg)
    seed = tk.make_seed_block(cfg, 6)
    g = torch.Generator().manual_seed(block)
    ct = torch.randn(ak.NUM_CT_COLOR, 56, 56, generator=g).to(dev)
    kw = dict(local_h=56, spp=SPP, device=dev)
    tape = sweep.PathTape.empty(cfg, 56, SPP, dev)
    tk.trace(sb, cb, seed, cfg, mode="color", tape=tape, **kw)
    assert float(sweep.lane_pair_shares(tape.words, cfg.light_index)[share][0]) >= least
    retraced = ak.replay(sb, cb, seed, cfg, ct, **kw)
    assert torch.equal(retraced, ak.replay_plain(sb, cb, seed, cfg, ct, **kw))
    assert sweep.block_from_sums(retraced)[8, :7].abs().min() > 0  # the light's slots took terms
    _assert_taped_is_untaped(sb, cb, seed, cfg, ct, local_h=56, spp=SPP, device=dev)


@pytest.mark.parametrize("block", [7, 8])
@pytest.mark.parametrize("brdf,nee,channels", [("glossy", False, 3), ("diffuse", False, 10),
                                               ("glossy", True, 10)],
                         ids=["shading-only", "aov", "nee-aov"])
def test_owner_pass_at_bounce_0(dev, brdf, nee, channels, block):
    """One bounce: the shading-only instance's pass (six shading slots a
    bounce, no geometry) and the AOV instances', where the albedo cotangent
    of the first hit follows the albedo term into its slot, lane 0's two
    before lane 1's; at 7 x 7 each block's last thread owns its group alone.
    The kernel equals the plain version bit for bit."""
    cfg = RenderConfig(width=61, height=37, spp=SPP, brdf=brdf, nee=nee, max_bounces=1,
                       block=block)
    sb, cb = _blocks(cfg)
    seed = tk.make_seed_block(cfg, 8)
    ct = _cotangent(dev, range(channels), seed=8)[:channels, :37, :61].contiguous()
    kw = dict(local_h=37, spp=SPP, device=dev)
    got = ak.replay(sb, cb, seed, cfg, ct, **kw)
    assert torch.equal(got, ak.replay_plain(sb, cb, seed, cfg, ct, **kw))
    assert sweep.block_from_sums(got)[:9, 4:10].abs().max() > 0


def test_taped_replay_resident_blocks(dev):
    """K4's taped NEE glossy instance keeps 8 blocks of 8 x 8 an SM: its ring
    holds the 14 words of two bounces a thread that K3's does (27,752 bytes a
    block at N = 9 with the sums), the glossy jitter waits in registers
    (bounded at 128), and no tape lies on the stack."""
    taped = ak.CUDA_KERNEL.occupancy(True, True, False, 8, 9, taped=True)
    assert taped["shared_bytes"] == sweep.shared_bytes(9, 8, taped=True) == 27_752
    assert taped["local_bytes"] == 0 and taped["registers"] <= 128
    assert taped["blocks_per_sm"] == 8


def test_resident_blocks_an_sm(dev):
    """Every instance keeps more than the 5 blocks of 8 x 8 threads resident
    that one set of sums a thread allowed; the kernel's shared bytes are the
    wrapper's."""
    rows = ak.CUDA_KERNEL.instances(8, 9)
    assert len(rows) == 8
    for name, occ in rows.items():
        assert occ["blocks_per_sm"] > 5, (name, occ)
        assert occ["shared_bytes"] == sweep.shared_bytes(9, 8, "shading only" not in name)
        assert occ["registers"] <= 128
    assert ak.CUDA_KERNEL.instances(16, 11)["K4 nee_glossy colour+aov"]["blocks_per_sm"] >= 1
