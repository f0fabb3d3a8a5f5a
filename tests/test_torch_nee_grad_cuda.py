"""The NEE gradient kernel and the f32 probes against their plain versions on the card.

Every test here needs a CUDA device: they are marked ``cuda`` and skip where
there is none. The file imports only the port, so it also runs on a machine
without JAX; from the root of a checkout:

    python -m pytest tests/test_torch_nee_grad_cuda.py -m cuda --noconftest -o addopts="" -q

Tolerances are those of ``sweep.agreement``, as in chip_smoke.py:
every gradient sum within rtol 1e-4 plus 1e-6 of the largest of its kind
(kernel and plain version add each lane group's terms in the same order and
sum over groups in double); where two orders of operations meet (replay against
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
from pathtrace_tpu_torch.ops import sweep
from pathtrace_tpu_torch.ops import trace_kernel as tk
from pathtrace_tpu_torch.utils import roofline as rf
from pathtrace_tpu_torch.utils import timing

pytestmark = pytest.mark.cuda

CFG = RenderConfig(width=128, height=64, spp=4, nee=True)
CROSS_ATOL = sweep.CROSS_ATOL


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _assert_agree(got, ref, kind="sums", atol=None):
    checks, _ = sweep.agreement(got, ref, kind, sweep.SUMS_ATOL if atol is None else atol)
    failed = [(name, share, ceiling) for name, share, ceiling, ok in checks if not ok]
    assert not failed, f"share out of tolerance above its ceiling: {failed}"


def _moved(before):
    """The launch counts that moved since ``before``, by key."""
    now = timing.launch_counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


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
    before = timing.launch_counts()
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
    assert _moved(before) == {f"k3.{mode}": 1}


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
    block shape moves nothing beyond it). The path tape pads the ragged
    blocks: the taped colour pass and the taped replay give the untaped
    bits."""
    cfg = RenderConfig(width=45, height=37, spp=3, max_bounces=3, nee=True, block=block)
    sb, cb, target = _inputs(dev, cfg, 37)
    seed = tk.make_seed_block(cfg, 4)
    kw = dict(local_h=37, spp=3, device=dev)
    ct = ((target - 0.5) / 3).contiguous()
    retraced = nk.replay(sb, cb, seed, cfg, ct, **kw)
    _assert_agree(retraced, nk.replay_plain(sb, cb, seed, cfg, ct, **kw))
    _assert_taped_is_untaped(sb, cb, seed, cfg, ct, retraced, **kw)
    sums, color = nk.fused(sb, cb, seed, cfg, target, **kw)
    ref, ref_color = nk.fused_plain(sb, cb, seed, cfg, target, **kw)
    _assert_agree(sums, ref)
    assert torch.equal(color, ref_color)


def _assert_taped_is_untaped(sb, cb, seed, cfg, ct, retraced, *, local_h, spp, device):
    """K1's taped colour sums and K3's taped replay equal their untaped
    launches to the bit, one launch each, the replay counted as a replay and
    as a taped one."""
    kw = dict(local_h=local_h, spp=spp, device=device)
    tape = sweep.PathTape.empty(cfg, local_h, spp, device)
    before = timing.launch_counts()
    color = tk.trace(sb, cb, seed, cfg, mode="color", tape=tape, **kw)
    taped = nk.replay(sb, cb, seed, cfg, ct, tape=tape, **kw)
    torch.cuda.synchronize()
    assert tape.written and _moved(before) == {"k1": 1, "k3.replay": 1, "k3.replay_taped": 1}
    assert torch.equal(color, tk.trace(sb, cb, seed, cfg, mode="color", **kw))
    assert torch.equal(taped, retraced)


def test_taped_replay_is_the_retracing_replay_at_the_inverse_size(dev):
    """At the inverse step's 256x256x16 and 5 bounces (4 sample lanes in K1,
    1,024 replay blocks): the taped colour sums and the taped replay's sums
    are the untaped launches' bits, and a second taped replay of the same
    tape gives them again."""
    cfg = RenderConfig(width=256, height=256, spp=16, nee=True)
    sb, cb, target = _inputs(dev, cfg, 256)
    seed = tk.make_seed_block(cfg, 9)
    kw = dict(local_h=256, spp=16, device=dev)
    ct = ((target - 0.5) / (256 * 256 * 3 * 16)).contiguous()
    retraced = nk.replay(sb, cb, seed, cfg, ct, **kw)
    _assert_taped_is_untaped(sb, cb, seed, cfg, ct, retraced, **kw)


def test_refuses_a_block_beyond_shared_memory(dev):
    """16 spheres at a 16x16 block, the largest launch: 254 words of sums a
    lane pair, 131,712 bytes a block, which fit 227 KB and launch; the
    kernel's own check refuses a launch whose shared memory, with a pad, is
    above the card's."""
    cfg = dataclasses.replace(CFG, block=16)
    sb, cb, target = _inputs(dev, cfg)
    sb16 = torch.cat([sb, sb[:7]])
    seed = tk.make_seed_block(cfg)
    kw = dict(local_h=64, spp=4, device=dev)
    sums, _ = nk.fused(sb16, cb, seed, cfg, target, **kw)
    _assert_agree(sums, nk.fused_plain(sb16, cb, seed, cfg, target, **kw)[0])
    assert sweep.shared_bytes(16, 16) <= sweep.MAX_SHARED_BYTES
    with pytest.raises(RuntimeError, match="launch failed"):
        nk.CUDA_KERNEL.launch("fused", sb16, cb, seed, cfg, target,
                              pad_shared=sweep.MAX_SHARED_BYTES, **kw)


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
    before = timing.launch_counts()
    loss, (ds, dc) = grad_lib.render_loss_grads(scene, cam, cfg, 0, target, device=dev)
    assert _moved(before) == {"k3.fused": 1}
    blocks = [ds.radius, ds.position, ds.emission, ds.color, dc.position, dc.yaw, dc.pitch]
    for g in blocks:
        assert g.device == dev and torch.isfinite(g).all() and g.abs().max() > 0
    leaves = [getattr(scene, k).to(dev).requires_grad_(True)
              for k in ("radius", "position", "emission", "color")]
    cam_leaves = [x.to(dev).requires_grad_(True) for x in (cam.position, cam.yaw, cam.pitch)]
    img = grad_lib.render_color(type(scene)(*leaves), Camera(*cam_leaves), cfg, 0)
    loss_d = grad_lib.l2_image_loss(img, target)
    loss_d.backward()
    assert timing.launch_counts()["k3.replay"] == before["k3.replay"] + 1
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
        before = timing.launch_counts()
        state, loss = step_fn(state)
        assert _moved(before) == {"k1": 2, "k3.replay": 2, "k3.replay_taped": 2}
        assert opt.param_groups[0]["lr"] == pytest.approx(want_lr)
        assert torch.isfinite(loss)
    moved = (state.params["position"].detach().cpu() != scene.position).any(dim=1)
    assert moved.tolist() == [i == 6 for i in range(9)]


def test_shard_slab_replays_without_a_tape(dev):
    """The sharding hook (``nee_grads_block_slab``, rows and samples at an
    offset) launches the retracing replay: a replay, no taped one, and no
    colour pass."""
    scene, cam = cornell_box(), Camera.create()
    ct = torch.rand(3, 16, 128, generator=torch.Generator().manual_seed(4)).to(dev)
    before = timing.launch_counts()
    block = nk.nee_grads_block_slab(scene, cam, CFG, 2, ct, row_offset=16, local_h=16, spp=2,
                                    sample_offset=1, device=dev)
    torch.cuda.synchronize()
    assert _moved(before) == {"k3.replay": 1}
    assert torch.isfinite(block).all() and block.abs().max() > 0


@pytest.mark.parametrize("size, spp, taped", [(256, 16, True), (512, 32, False)])
def test_cross_grads_tapes_within_the_budget(dev, monkeypatch, size, spp, taped):
    """``cross_grads`` tapes its two NEE colour passes in the fewest row slabs
    whose two tapes fit ``TAPE_BUDGET``: the whole frame at 256x256x16 (587
    MB; ``taped``), two slabs of 256 rows at 512x512x32 (2 x 1.17 GB where
    the frame's would take 4.70 GB). With the budget at 0 the step traces
    again in one slab, in a few MB: the same loss to the bit, and the same
    gradients, to the bit from one slab, within 1e-6 of each field's largest
    from two (the slabs' sums add in another order). With the budget at the
    whole frame's two tapes, 512x512x32 tapes in one slab: the retrace's
    bits."""
    cfg = RenderConfig(width=size, height=size, spp=spp, nee=True)
    scene, cam = cornell_box(), Camera.create()
    target = torch.full((size, size, 3), 0.25, device=dev)
    rows = sweep.slab_rows(cfg)
    slabs = size // rows
    assert (rows == size) == taped and slabs == (1 if taped else 2)

    def run():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = timing.launch_counts()
        out = gk.cross_grads(scene, cam, cfg, 3, target, device=dev)
        torch.cuda.synchronize()
        n = {k[3:]: v for k, v in _moved(before).items() if k.startswith("k3.")}
        return out, n, torch.cuda.max_memory_allocated(dev) - base

    (loss, d), n, peak = run()
    assert n == {"replay": 2 * slabs, "replay_taped": 2 * slabs}
    assert peak >= 2 * sweep.tape_bytes(cfg, rows, spp)
    monkeypatch.setattr(sweep, "TAPE_BUDGET", 0)
    (other_loss, other), n, peak = run()
    assert n == {"replay": 2} and peak < 64 << 20
    assert torch.equal(loss, other_loss)
    for name, g in d.items():
        if taped:
            assert torch.equal(g, other[name]), name
        else:
            torch.testing.assert_close(g, other[name], rtol=1e-6,
                                       atol=1e-6 * float(other[name].abs().max()), msg=name)
    if not taped:
        monkeypatch.setattr(sweep, "TAPE_BUDGET", 2 * sweep.tape_bytes(cfg, size, spp))
        (whole_loss, whole), n, _ = run()
        assert (n["replay"], n["replay_taped"]) == (2, 2)
        assert torch.equal(whole_loss, other_loss)
        for name, g in whole.items():
            assert torch.equal(g, other[name]), name


@pytest.mark.parametrize("brdf", ["diffuse", "glossy"])
def test_cross_grads_in_two_slabs_matches_one(dev, monkeypatch, brdf):
    """With ``TAPE_BUDGET`` moved so that a 64x64x4 NEE step takes two slabs
    of 32 rows, ``cross_grads`` gives the one slab's loss to the bit and
    each gradient field within 1e-6 of its largest (the slabs' sums add in
    another order). Each slab tapes both colour passes and sweeps both
    tapes: the taped replay's counter (``k3.replay_taped`` under diffuse,
    ``k4.replay_taped`` under glossy) reads two a slab, and none where a
    budget of 0 makes the step retrace, with the one taped slab's bits."""
    cfg = RenderConfig(width=64, height=64, spp=4, nee=True, brdf=brdf)
    scene, cam = cornell_box(), Camera.create()
    target = torch.rand(64, 64, 3, generator=torch.Generator().manual_seed(6)).to(dev)
    key = "k4" if brdf == "glossy" else "k3"
    whole = 2 * sweep.tape_bytes(cfg, 64, 4)

    def run(budget):
        monkeypatch.setattr(sweep, "TAPE_BUDGET", budget)
        timing.start_recording()
        out = gk.cross_grads(scene, cam, cfg, 2, target, device=dev)
        torch.cuda.synchronize()
        n = timing.stop_recording().launches
        return out, (n["k1"], n[f"{key}.replay"], n[f"{key}.replay_taped"])

    (loss, d), n = run(whole)
    assert n == (2, 2, 2)
    (slab_loss, slab_d), n = run(whole // 2)
    assert sweep.slab_rows(cfg) == 32 and n == (4, 4, 4)
    (re_loss, re_d), n = run(0)
    assert n == (2, 2, 0)
    assert torch.equal(slab_loss, loss) and torch.equal(re_loss, loss)
    for name, g in d.items():
        assert torch.equal(re_d[name], g), name
        torch.testing.assert_close(slab_d[name], g, rtol=1e-6,
                                   atol=1e-6 * float(g.abs().max()), msg=name)


@pytest.mark.parametrize("extra", [{"nee": True, "brdf": "glossy"}, {"brdf": "glossy"}])
def test_glossy_still_raises_naming_its_kernel(dev, extra):
    """Glossy raised here, naming K4, while that kernel was not ported. Now a
    glossy inverse step launches the forward kernel twice and K4 twice, and
    neither the NEE kernel nor the product-chain kernel; under NEE its K4
    replays read the colour passes' path tapes."""
    cfg = RenderConfig(width=16, height=16, spp=1, **extra)
    scene, cam = cornell_box(), Camera.create()
    target = torch.rand(16, 16, 3, generator=torch.Generator().manual_seed(1)).to(dev)
    state, step_fn, _ = inverse.make_inverse_step(scene, cam, cfg, target,
                                                  ("color", "position"), device=dev)
    before = timing.launch_counts()
    state, loss = step_fn(state)
    taped = {"k4.replay_taped": 2} if extra.get("nee") else {}
    assert _moved(before) == {"k1": 2, "k4.replay": 2, **taped}
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


# -- the lane groups and the resident blocks --------------------------------------

@pytest.mark.parametrize("block", [3, 5, 7, 16])
@pytest.mark.parametrize("mode", ["fused", "replay"])
def test_lane_groups_at_other_blocks_and_ragged_frames(dev, mode, block):
    """Lane pairs at block edges that leave the last thread without a
    partner (3 x 3, 5 x 5, 7 x 7), at the largest block, and on a frame whose last
    blocks hang over both edges: the plain version follows the kernel's
    groups, and two launches give the same bits."""
    cfg = RenderConfig(width=123, height=61, spp=4, nee=True, block=block)
    sb, cb, target = _inputs(dev, cfg, 61)
    seed = tk.make_seed_block(cfg, 2)
    kw = dict(local_h=61, spp=4, device=dev)
    if mode == "fused":
        sums, color = nk.fused(sb, cb, seed, cfg, target, **kw)
        ref_sums, ref_color = nk.fused_plain(sb, cb, seed, cfg, target, **kw)
        _assert_agree(color, ref_color, "color")
        again = nk.fused(sb, cb, seed, cfg, target, **kw)[0]
    else:
        ct = ((target - 0.5) / 4).contiguous()
        sums = nk.replay(sb, cb, seed, cfg, ct, **kw)
        ref_sums = nk.replay_plain(sb, cb, seed, cfg, ct, **kw)
        again = nk.replay(sb, cb, seed, cfg, ct, **kw)
    _assert_agree(sums, ref_sums)
    assert torch.equal(sums, again)


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
    light, the pair's pass adds both lanes' terms (and the light's) to one
    slot in turn order; at 7 x 7 each block's last thread owns its group
    alone. The retracing and the taped replay equal the plain version bit
    for bit."""
    pose, share, least = VIEWS[view]
    cfg = RenderConfig(width=56, height=56, spp=4, nee=True, block=block)
    sb, cb = cornell_box().packed(), tk.camera_block(Camera.create(**pose), cfg)
    seed = tk.make_seed_block(cfg, 6)
    g = torch.Generator().manual_seed(block)
    ct = ((torch.rand(56, 56, 3, generator=g) - 0.5) / 4).to(dev)
    kw = dict(local_h=56, spp=4, device=dev)
    tape = sweep.PathTape.empty(cfg, 56, 4, dev)
    tk.trace(sb, cb, seed, cfg, mode="color", tape=tape, **kw)
    assert float(sweep.lane_pair_shares(tape.words, cfg.light_index)[share][0]) >= least
    retraced = nk.replay(sb, cb, seed, cfg, ct, **kw)
    assert torch.equal(retraced, nk.replay_plain(sb, cb, seed, cfg, ct, **kw))
    assert sweep.block_from_sums(retraced)[8, :7].abs().min() > 0  # the light's slots took terms
    _assert_taped_is_untaped(sb, cb, seed, cfg, ct, retraced, **kw)


def test_resident_blocks_an_sm(dev):
    """Both modes keep more than the 5 blocks of 8 x 8 threads resident that
    one set of sums a thread allowed; the kernel's shared bytes are the
    wrapper's; a pad takes blocks away, which the occupancy curve uses."""
    for mode in nk.MODES:
        occ = nk.CUDA_KERNEL.occupancy(mode, 8, 9)
        assert occ["blocks_per_sm"] > 5, (mode, occ)
        assert occ["shared_bytes"] == sweep.shared_bytes(9, 8)
        assert occ["registers"] <= 128
        assert nk.CUDA_KERNEL.occupancy(mode, 16, 16)["shared_bytes"] == \
            sweep.shared_bytes(16, 16)
    assert nk.CUDA_KERNEL.occupancy("replay", 8, 9, pad_shared=100000)["blocks_per_sm"] == 1
    # The taped replay's ring of two bounces a thread keeps the blocks, and
    # with no forward it keeps no tape on the stack.
    taped = nk.CUDA_KERNEL.occupancy("replay", 8, 9, taped=True)
    assert taped["shared_bytes"] == sweep.shared_bytes(9, 8, taped=True)
    assert taped["registers"] <= 128 and taped["local_bytes"] == 0
    assert taped["blocks_per_sm"] >= nk.CUDA_KERNEL.occupancy("replay", 8, 9)["blocks_per_sm"]
    sb, cb, target = _inputs(dev)
    seed = tk.make_seed_block(CFG, 2)
    kw = dict(local_h=64, spp=4, device=dev)
    ct = ((target - 0.5) / 4).contiguous()
    padded = nk.CUDA_KERNEL.launch("replay", sb, cb, seed, CFG, ct, pad_shared=100000, **kw)
    assert torch.equal(padded, nk.replay(sb, cb, seed, CFG, ct, **kw))
    assert nk.CUDA_KERNEL.occupancy("replay", 8, 9)["blocks_per_sm"] > 5
