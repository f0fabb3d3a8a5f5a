"""The NEE gradient kernel's plain PyTorch versions against the JAX package.

The reference is ``jax.value_and_grad`` of the jnp backend with ``nee=True``,
the estimator tests/test_pallas_nee_grad.py holds the TPU kernel to (its own
Pallas calls in interpret mode are marked ``slow`` there: one did not finish
in minutes here). Both packages draw the same lattice. Tolerances against
JAX, from that test: loss rtol 1e-4; position and radius rtol 2e-3 plus 2e-3
of the largest; camera position 5e-3 of the largest; yaw and pitch 5e-2 of
the largest camera-position entry. Emission and albedo: rtol 2e-3 plus 5e-4
of the largest, where that test has 1e-5: at this size (128x16, 2 spp, 3
bounces, seed 3) 2 of the 2,048 pixels (0.1%) differ in colour by more than
1e-3 between the two packages, with or without ``jit`` (64 by more than
1e-4: a borderline hit decision rounds the other way in one of them), and
the emission gradient then differs by 3.2e-4 of its largest entry, the
albedo's by 1.1e-4 (measured; every other block is inside that test's own
tolerance).

The port's modes against each other (fused = replay against the MSE
cotangent; slabs and sample ranges add up): rtol
1e-4 plus 1e-4 of the largest of the entry's kind, the JAX package's
tolerance for its replay against its fused mode: the same terms are summed
in another order, and the geometry sums cancel.

The kernel against the plain versions on the card is in
tests/test_torch_nee_grad_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtrace_tpu import Camera as JaxCamera
from pathtrace_tpu import RenderConfig as JaxConfig
from pathtrace_tpu import cornell_box as jax_cornell_box
from pathtrace_tpu.grad import l2_image_loss, render_color

from pathtrace_tpu_torch import Camera, RenderConfig
from pathtrace_tpu_torch import grad as port_grad
from pathtrace_tpu_torch.convert import camera_from_numpy, grads_to_numpy, scene_from_numpy
from pathtrace_tpu_torch.ops import ad_grad_kernel as ak
from pathtrace_tpu_torch.ops import grad_kernel as gk
from pathtrace_tpu_torch.ops import nee_grad_kernel as nk
from pathtrace_tpu_torch.ops import sweep
from pathtrace_tpu_torch.ops import trace_kernel as tk
from pathtrace_tpu_torch.scene import Scene

WIDTH, HEIGHT, SPP, BOUNCES, SEED = 128, 16, 2, 3, 3
CFG = RenderConfig(width=WIDTH, height=HEIGHT, spp=SPP, max_bounces=BOUNCES, seed=SEED,
                   backend="cuda", nee=True)
JCFG = JaxConfig(width=WIDTH, height=HEIGHT, spp=SPP, max_bounces=BOUNCES, seed=SEED,
                 backend="jnp", nee=True)
DENOM = WIDTH * HEIGHT * 3
CROSS_ATOL = sweep.CROSS_ATOL
SCENE_FIELDS = ("radius", "position", "emission", "color")


def jax_grads_to_numpy(d_scene, d_cam) -> dict:
    out = {k: np.asarray(getattr(d_scene, k)) for k in SCENE_FIELDS}
    out.update(cam_position=np.asarray(d_cam.position), yaw=np.asarray(d_cam.yaw),
               pitch=np.asarray(d_cam.pitch))
    return out


def assert_seven_blocks_close(got: dict, want: dict):
    """The JAX package's tolerances for its hand kernel against jnp AD."""
    def close(name, rtol, atol_scale, scale=None):
        w = want[name]
        scale = max(float(np.abs(w).max()), 1e-12) if scale is None else scale
        np.testing.assert_allclose(got[name], w, rtol=rtol, atol=atol_scale * scale,
                                   err_msg=name)

    close("emission", 2e-3, 5e-4)
    close("color", 2e-3, 5e-4)
    close("position", 2e-3, 2e-3)
    close("radius", 2e-3, 2e-3)
    close("cam_position", 2e-3, 5e-3)
    cam_scale = float(np.abs(want["cam_position"]).max())
    close("yaw", 0.0, 5e-2, cam_scale)
    close("pitch", 0.0, 5e-2, cam_scale)


def replay_block(scene, cam, frame, ct):
    """The frame's gradient block against ``ct``, the cotangent of the mean
    colour [H, W, 3], through ``grad_kernel``'s one replay entry."""
    sums = gk._replay_sums(scene.packed(), tk.camera_block(cam, CFG),
                           tk.make_seed_block(CFG, frame), CFG, ct, local_h=HEIGHT, spp=SPP,
                           device=torch.device("cpu"))
    return sweep.block_from_sums(sums)


def assert_agree(got, ref, atol=None):
    checks, _ = sweep.agreement(got, ref, "sums", sweep.SUMS_ATOL if atol is None else atol)
    failed = [(name, share) for name, share, _, ok in checks if not ok]
    assert not failed, failed


@pytest.fixture(scope="module")
def state():
    jscene, jcam = jax_cornell_box(), JaxCamera.create()
    scene = scene_from_numpy(*(np.asarray(getattr(jscene, f)) for f in SCENE_FIELDS))
    cam = camera_from_numpy(np.asarray(jcam.position), np.asarray(jcam.yaw),
                            np.asarray(jcam.pitch))
    target = np.random.default_rng(0).uniform(size=(HEIGHT, WIDTH, 3)).astype(np.float32)
    return jscene, jcam, scene, cam, target


@pytest.fixture(scope="module")
def jax_ref(state):
    """(loss, seven gradient blocks) of the MSE loss by jnp reverse-mode AD."""
    jscene, jcam, _, _, target = state

    def loss_fn(scene_, cam_):
        return l2_image_loss(render_color(scene_, cam_, JCFG, 0), jnp.asarray(target))

    loss, (ds, dc) = jax.value_and_grad(loss_fn, argnums=(0, 1))(jscene, jcam)
    return float(loss), jax_grads_to_numpy(ds, dc)


@pytest.fixture(scope="module")
def fused_sums(state):
    """The fused mode's flat sums and colour on one frame."""
    _, _, scene, cam, target = state
    sb, cb = scene.packed(), tk.camera_block(cam, CFG)
    out = nk.fused(sb, cb, tk.make_seed_block(CFG, 0), CFG, torch.from_numpy(target),
                   local_h=HEIGHT, spp=SPP)
    return sb, cb, out


def test_fused_plain_matches_jnp_ad(state, jax_ref, fused_sums):
    _, _, scene, cam, _ = state
    sums, _ = fused_sums[2]
    block = sweep.block_from_sums(sums) / DENOM
    loss = block[scene.num_objects, sweep.LOSS_COL]
    got = grads_to_numpy(*sweep.grads_from_block(scene, cam, CFG, block))
    np.testing.assert_allclose(float(loss), jax_ref[0], rtol=1e-4)
    assert_seven_blocks_close(got, jax_ref[1])
    assert np.abs(got["position"]).max() > 0 and np.abs(got["radius"]).max() > 0
    assert np.abs(got["cam_position"]).max() > 0 and got["yaw"] != 0 and got["pitch"] != 0


def test_loss_grads_entry_points_dispatch_to_the_nee_kernel(state, jax_ref, fused_sums):
    """``render_loss_grads`` -> ``grad_kernel.loss_and_grads`` ->
    ``nee_loss_and_grads`` on "cuda": the fused mode, bit for bit."""
    _, _, scene, cam, target = state
    loss, (ds, dc) = port_grad.render_loss_grads(scene, cam, CFG, 0, torch.from_numpy(target),
                                                 device="cpu")
    loss_k, (ds_k, dc_k) = nk.nee_loss_and_grads(scene, cam, CFG, 0, torch.from_numpy(target),
                                                 device="cpu")
    block = sweep.block_from_sums(fused_sums[2][0]) / DENOM
    assert torch.equal(loss, loss_k) and torch.equal(loss, block[9, sweep.LOSS_COL])
    got, want = grads_to_numpy(ds, dc), grads_to_numpy(ds_k, dc_k)
    assert all(np.array_equal(got[k], want[k]) for k in got)
    assert torch.equal(ds.position, block[:9, 1:4])
    assert_seven_blocks_close(got, jax_ref[1])


def test_fused_colour_and_loss_are_the_forward_kernels(state, fused_sums):
    """The fused colour is the forward kernel's NEE colour bit for bit, and
    the loss slot its squared error against the target, summed in double."""
    _, _, _, _, target = state
    sb, cb, (sums, color) = fused_sums
    k1 = tk.trace(sb, cb, tk.make_seed_block(CFG, 0), CFG, local_h=HEIGHT, spp=SPP, mode="color")
    assert torch.equal(color, k1 * tk._f32(1.0 / SPP))
    res = color - torch.from_numpy(target)
    per_pixel = res[..., 0] * res[..., 0] + res[..., 1] * res[..., 1] + res[..., 2] * res[..., 2]
    assert sums[-1] == per_pixel.sum(dtype=torch.float64).float()


def test_replay_against_the_mse_cotangent_equals_fused(state, fused_sums):
    _, _, _, _, target = state
    sb, cb, out = fused_sums
    sums, color = out
    ct = (2.0 * (color - torch.from_numpy(target)) / SPP).contiguous()
    got = nk.replay(sb, cb, tk.make_seed_block(CFG, 0), CFG, ct, local_h=HEIGHT, spp=SPP)
    assert got[-1] == 0
    assert_agree(torch.cat([got[:-1], sums[-1:]]), sums, CROSS_ATOL)


def test_slabs_and_sample_ranges_add_up(state):
    """``nee_grads_block_slab`` at row and sample offsets addresses the global
    lattice: two slabs x two sample ranges sum to the whole frame's block."""
    _, _, scene, cam, _ = state
    ct = np.random.default_rng(2).normal(size=(3, HEIGHT, WIDTH)).astype(np.float32) / SPP
    whole = nk.nee_grads_block_slab(scene, cam, CFG, 4, torch.from_numpy(ct), device="cpu")
    assert whole.shape == (14, sweep.BLOCK_COLS)
    parts = 0
    for row in (0, 8):
        for offset, spp in ((0, 1), (1, 1)):
            parts = parts + nk.nee_grads_block_slab(
                scene, cam, CFG, 4, torch.from_numpy(ct[:, row:row + 8]), row_offset=row,
                local_h=8, spp=spp, sample_offset=offset, device="cpu")
    flat = lambda b: torch.cat([b[:9, :10].reshape(-1), b[9, :3], b[10:14, :3].reshape(-1),  # noqa: E731
                                b[9, 10:11]])
    assert_agree(flat(parts), flat(whole), CROSS_ATOL)
    # The whole frame through the one replay entry: the same launch, 1/spp folded there.
    again = replay_block(scene, cam, 4, torch.from_numpy(ct * SPP).permute(1, 2, 0))
    assert torch.equal(again, whole)


def test_grads_from_block_matches_jax_vjp(state):
    """The corner rays' cotangents through ``eye_ray_basis``, the eye's added
    to the position: against ``jax.vjp`` of the JAX camera (rtol 1e-5 plus
    1e-6 of the largest: the same chain in another framework)."""
    jscene, jcam, scene, cam, _ = state
    block = np.random.default_rng(5).normal(size=(14, sweep.BLOCK_COLS)).astype(np.float32)
    d_scene, d_cam = sweep.grads_from_block(scene, cam, CFG, torch.from_numpy(block))
    _, vjp = jax.vjp(lambda c: c.eye_ray_basis(WIDTH, HEIGHT), jcam)
    (want,) = vjp(jnp.asarray(block[10:14, 0:3]))
    got = grads_to_numpy(d_scene, d_cam)
    scale = float(np.abs(block).max())
    np.testing.assert_allclose(got["cam_position"], np.asarray(want.position) + block[9, 0:3],
                               rtol=1e-5, atol=1e-6 * scale)
    for name in ("yaw", "pitch"):
        w = float(getattr(want, name))
        np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=1e-5 * abs(w) + 1e-6)
    assert np.array_equal(got["radius"], block[:9, 0])
    assert np.array_equal(got["position"], block[:9, 1:4])
    assert np.array_equal(got["emission"], block[:9, 4:7])
    assert np.array_equal(got["color"], block[:9, 7:10])
    with pytest.raises(ValueError, match="block must be"):
        sweep.grads_from_block(scene, cam, CFG, torch.zeros(16, 128))


def test_render_color_backward_is_the_replay(state):
    """The autograd.Function under NEE: the forward kernel's colour forward,
    one replay backward, gradients for all seven leaves."""
    _, _, scene, cam, _ = state
    leaves = {k: getattr(scene, k).clone().requires_grad_(True) for k in SCENE_FIELDS}
    cam_leaves = [x.clone().requires_grad_(True) for x in (cam.position, cam.yaw, cam.pitch)]
    img = port_grad.render_color(Scene(**leaves), Camera(*cam_leaves), CFG, 2, device="cpu")
    assert torch.equal(img.detach(), tk.render_color_sums(scene, cam, CFG, 2, device="cpu") / SPP)
    ct = torch.from_numpy(np.random.default_rng(1).normal(size=img.shape).astype(np.float32))
    (img * ct).sum().backward()
    block = replay_block(scene, cam, 2, ct)
    want = grads_to_numpy(*sweep.grads_from_block(scene, cam, CFG, block))
    got = {k: v.grad.numpy() for k, v in leaves.items()}
    got.update(cam_position=cam_leaves[0].grad.numpy(), yaw=cam_leaves[1].grad.numpy(),
               pitch=cam_leaves[2].grad.numpy())
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert np.abs(got["position"]).max() > 0 and got["yaw"] != 0


def test_cross_grads_match_jnp_ad(state):
    """``cross_grads`` under NEE (two colour passes, two replays, each against
    the other render's residual) against the arithmetic of the JAX package's
    ``pallas_cross_grads`` evaluated with jnp AD: the gradient of
    mean((A - T)(B - T)) over frames 2 step and 2 step + 1. The JAX package's
    tolerance for this estimator (tests/test_pallas_grad.py): loss rtol
    2e-3, gradients rtol 2e-2 plus 2e-2 of the largest, for emission and
    albedo. Position and radius: 1e-1 of the largest. Measured at steps 0,
    1, 2: 1.3e-2, 5.2e-2, 5.8e-4 of the largest, while emission and albedo
    differ by 2e-5 at step 1, so no path flipped there: a grazing hit's
    1 / sqrt(det) in the t chain amplifies the two packages' rounding."""
    jscene, jcam, scene, cam, target = state
    step = 1

    def loss_fn(scene_):
        a = render_color(scene_, jcam, JCFG, 2 * step)
        b = render_color(scene_, jcam, JCFG, 2 * step + 1)
        return jnp.mean((a - target) * (b - target))

    loss_j, d_j = jax.value_and_grad(loss_fn)(jscene)
    loss, d = gk.cross_grads(scene, cam, CFG, step, torch.from_numpy(target), device="cpu")
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=2e-3)
    assert set(d) == {"emission", "color", "position", "radius"}
    for name, g in d.items():
        want = np.asarray(getattr(d_j, name))
        atol = 1e-1 if name in ("position", "radius") else 2e-2
        np.testing.assert_allclose(g.numpy(), want, rtol=2e-2, atol=atol * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("entry", ["fused", "replay", "fused_plain", "replay_plain"])
def test_nee_kernel_refuses_other_estimators(state, entry):
    _, _, scene, cam, _ = state
    cfg = dataclasses.replace(CFG, width=8, height=8, nee=False)
    args = (scene.packed(), tk.camera_block(cam, cfg), tk.make_seed_block(cfg), cfg,
            torch.zeros(8, 8, 3))
    with pytest.raises(ValueError, match="nee=True"):
        getattr(nk, entry)(*args, local_h=8, spp=1)


def test_product_chain_kernel_refuses_nee(state):
    """The diffuse kernels' wrappers take no NEE config (the dispatching entry
    points do): a ValueError, not a silent wrong estimator."""
    _, _, scene, cam, _ = state
    cfg = dataclasses.replace(CFG, width=8, height=8)
    with pytest.raises(ValueError, match="nee_grad_kernel"):
        gk.dump(scene.packed(), tk.camera_block(cam, cfg), tk.make_seed_block(cfg), cfg,
                local_h=8, spp=1)


def test_replay_is_linear_in_the_cotangent(state):
    """Doubling the cotangent doubles every sum to the bit (a power of two
    scales each term, each Kahan compensation and each pixel sum exactly),
    and a zero cotangent gives zeros."""
    _, _, scene, cam, _ = state
    cfg = dataclasses.replace(CFG, width=32, height=8, spp=4)
    ct = torch.from_numpy(np.random.default_rng(3).normal(size=(8, 32, 3)).astype(np.float32))
    args = (scene.packed(), tk.camera_block(cam, cfg), tk.make_seed_block(cfg, 1), cfg)
    once = nk.replay(*args, ct, local_h=8, spp=4)
    assert torch.equal(nk.replay(*args, 2.0 * ct, local_h=8, spp=4), 2.0 * once)
    assert once.abs().max() > 0
    assert not nk.replay(*args, torch.zeros_like(ct), local_h=8, spp=4).any()


def test_agreement_sees_an_error(fused_sums):
    """The comparison the card runs flags one wrong entry of any kind, and a NaN."""
    ref = fused_sums[2][0]
    checks, err = sweep.agreement(ref.clone(), ref, "sums")
    assert err == 0.0 and all(ok for *_, ok in checks)
    kinds = sweep.entry_kinds(9)
    assert len(kinds) == ref.numel() == 106
    for k, name in enumerate(sweep.KINDS):
        bad = ref.clone()
        bad[int(np.flatnonzero(kinds == k)[0])] += 1e-3 * float(ref[kinds == k].abs().max())
        failed = {n for n, *_, ok in sweep.agreement(bad, ref, "sums")[0] if not ok}
        assert failed == {name}
    bad = ref.clone()
    bad[0] = float("nan")
    assert "finite" in {n for n, *_, ok in sweep.agreement(bad, ref, "sums")[0] if not ok}
    with pytest.raises(ValueError):
        sweep.agreement(ref[:-1], ref[:-1], "sums")


@pytest.mark.parametrize("bad", ["bounces", "shape", "dtype", "device", "contiguous", "nee",
                                 "shared"])
def test_wrapper_rejects_bad_input(state, bad):
    _, _, scene, cam, _ = state
    cfg = dataclasses.replace(CFG, width=8, height=8, spp=1)
    target = torch.zeros(8, 8, 3)
    kw = dict(local_h=8, spp=1)
    if bad == "bounces":
        cfg = dataclasses.replace(cfg, max_bounces=sweep.MAX_BOUNCES + 1)
    elif bad == "shape":
        target = torch.zeros(8, 7, 3)
    elif bad == "dtype":
        target = target.double()
    elif bad == "device":
        kw["device"] = "meta"
    elif bad == "contiguous":
        target = torch.zeros(8, 8, 6)[..., ::2]
    elif bad == "nee":
        cfg = dataclasses.replace(cfg, nee=False)
    sb = scene.packed()
    if bad == "shared":
        # 16 spheres at a 16 x 16 block, the largest launch: 254 words a lane
        # pair x 128 pairs, a loss float a thread and the sphere table are
        # 131,712 bytes, which fit a block's 227 KB, so no launch is refused
        # for its shared memory; a sphere or a block edge more is refused.
        assert sweep.shared_bytes(16, 16) == 131712 <= sweep.MAX_SHARED_BYTES
        cfg16 = dataclasses.replace(cfg, block=16)
        sb16 = torch.cat([sb, sb[:7]])
        sums, _ = nk.fused(sb16, tk.camera_block(cam, cfg16), tk.make_seed_block(cfg16), cfg16,
                           target, **kw)
        assert sums.shape == (176,)
        with pytest.raises(ValueError, match="spheres"):
            nk.fused(torch.cat([sb16, sb[:1]]), tk.camera_block(cam, cfg16),
                     tk.make_seed_block(cfg16), cfg16, target, **kw)
        cfg = dataclasses.replace(cfg, block=17)
    with pytest.raises(ValueError, match="block edge" if bad == "shared" else None):
        nk.fused(sb, tk.camera_block(cam, cfg), tk.make_seed_block(cfg), cfg, target, **kw)


def test_block_layout():
    """Flat sums -> the JAX package's block rows and columns."""
    n = 3
    sums = torch.arange(10 * n + 16, dtype=torch.float32)
    block = sweep.block_from_sums(sums)
    assert block.shape == (n + 5, sweep.BLOCK_COLS)
    assert torch.equal(block[1, :10], sums[10:20])
    assert torch.equal(block[n, 0:3], sums[30:33]) and block[n, sweep.LOSS_COL] == sums[-1]
    assert torch.equal(block[n + 1:, 0:3].reshape(-1), sums[33:45])
    assert sweep.n_slots(9) == 156 and sweep.n_slots(16) == 254


# -- the path tape: K1's taped colour pass writes it, K3's taped replay reads it ----

def test_tape_size_and_the_taped_replay_shared_memory():
    """At the inverse cell's 256x256x16 and 5 bounces a path tape is 14 words
    a bounce of 1,048,576 paths: 293,601,280 bytes. A ragged slab pads to
    whole replay blocks. The taped replay's ring of two bounces a thread
    keeps 8 blocks of 8 x 8 an SM within 228 KB, at 1 KB reserved a block."""
    cfg = RenderConfig(width=256, height=256, spp=16, nee=True)
    assert sweep.tape_shape(cfg, 256, 16) == (16, 1024, 5, sweep.TAPE_WORDS["diffuse"], 64)
    assert sweep.tape_bytes(cfg, 256, 16) == 293_601_280
    ragged = RenderConfig(width=45, height=37, spp=3, max_bounces=3, nee=True, block=7)
    assert sweep.tape_shape(ragged, 37, 3) == (3, 42, 3, 14, 49)
    taped = sweep.shared_bytes(9, 8, taped=True)
    assert taped == sweep.shared_bytes(9, 8) + 2 * 14 * 64 * 4 == 27_752
    assert 8 * (taped + 1024) <= 228 * 1024


_BAD_TAPES = ["device", "dtype", "shape", "contiguous", "unwritten", "height", "spp", "bounces",
              "block", "plain", "glossy", "no_nee"]


@pytest.mark.parametrize("entry, bad", [("replay", b) for b in _BAD_TAPES]
                         + [("trace", b) for b in _BAD_TAPES if b != "unwritten"]
                         + [("trace", "mode")])
def test_tape_wrappers_refuse_bad_tapes(state, entry, bad):
    """Both wrappers refuse a tape of the wrong device, dtype, shape or
    contiguity, or one made for another frame size, spp, bounce count or
    block; the replay one no colour pass wrote; a diffuse tape (14 words a
    bounce) for a glossy launch (17), which K3's replay refuses for its
    BRDF; a launch without NEE; and a tape on the CPU, where the plain
    versions trace every path."""
    _, _, scene, cam, _ = state
    cfg = dataclasses.replace(CFG, width=8, height=8, spp=1)
    made = dict(cfg=cfg, local_h=8, spp=1)
    if bad in ("height", "spp", "bounces", "block"):
        made = dict(cfg=dataclasses.replace(cfg, max_bounces=4) if bad == "bounces" else
                    dataclasses.replace(cfg, block=4) if bad == "block" else cfg,
                    local_h=7 if bad == "height" else 8, spp=2 if bad == "spp" else 1)
    tape = sweep.PathTape.empty(made["cfg"], made["local_h"], made["spp"], "cpu")
    tape.written = bad != "unwritten"
    words = tape.words
    if bad == "device":
        tape.words = torch.empty(words.shape, device="meta")
    elif bad == "dtype":
        tape.words = words.double()
    elif bad == "shape":
        tape.words = words[:, :, :, :-1]
    elif bad == "contiguous":
        tape.words = torch.empty(words.shape[::-1]).permute(4, 3, 2, 1, 0)
    if bad in ("glossy", "no_nee"):
        cfg = dataclasses.replace(cfg, **({"brdf": "glossy"} if bad == "glossy" else
                                          {"nee": False}))
    match = {"device": "is on meta", "dtype": "must be float32", "shape": "must be float32",
             "contiguous": "contiguous", "unwritten": "no colour pass", "plain": "CUDA kernels'",
             "glossy": "brdf='diffuse'" if entry == "replay" else "made for",
             "no_nee": "nee=True", "mode": "'color' mode"}.get(bad, "made for")
    args = (scene.packed(), tk.camera_block(cam, cfg), tk.make_seed_block(cfg), cfg)
    with pytest.raises(ValueError, match=match):
        if entry == "replay":
            nk.replay(*args, torch.zeros(8, 8, 3), local_h=8, spp=1, tape=tape)
        else:
            tk.trace(*args, local_h=8, spp=1, mode="channels" if bad == "mode" else "color",
                     tape=tape)
    assert tape.written == (bad != "unwritten")  # a refused colour pass writes nothing


@pytest.mark.parametrize("size, spp, bounces, taped", [
    (256, 16, 5, True), (512, 16, 5, True), (512, 32, 5, False), (1024, 64, 5, False),
    (256, 16, 16, True), (512, 16, 16, False)])
def test_step_tapes_keep_within_the_budget(monkeypatch, size, spp, bounces, taped):
    """An inverse step on the card takes its two path tapes in the fewest
    equal row slabs whose two tapes fit ``TAPE_BUDGET``: the whole frame
    (``taped``) where it fits, else slabs of fewer rows; on the CPU none at
    any size."""
    cfg = RenderConfig(width=size, height=size, spp=spp, max_bounces=bounces, nee=True)
    made = _record_tapes(monkeypatch)
    cuda = torch.device("cuda", 0)
    rows = sweep.slab_rows(cfg)
    assert (2 * sweep.tape_bytes(cfg, size, spp) <= sweep.TAPE_BUDGET) == taped == (rows == size)
    assert 2 * sweep.tape_bytes(cfg, rows, spp) <= sweep.TAPE_BUDGET
    slabs = -(-size // rows)
    assert all(2 * sweep.tape_bytes(cfg, -(-size // n), spp) > sweep.TAPE_BUDGET
               for n in range(1, slabs))
    assert sweep.step_tapes(cfg, cuda) == (rows, (1, 2))
    assert made == [(cfg, rows, spp, cuda)] * 2
    assert sweep.step_tapes(cfg, torch.device("cpu")) == (size, (None, None))


def _record_tapes(monkeypatch) -> list:
    """Make ``PathTape.empty`` record its arguments and return a count."""
    made = []

    def empty(cfg_, local_h, spp_, device):
        made.append((cfg_, local_h, spp_, device))
        return len(made)

    monkeypatch.setattr(sweep.PathTape, "empty", empty)
    return made


@pytest.mark.parametrize("brdf, size, spp, rows, words, tape", [
    ("diffuse", 256, 16, 256, 14, 293_601_280), ("glossy", 256, 16, 256, 17, 356_515_840),
    ("diffuse", 512, 32, 256, 14, 1_174_405_120), ("glossy", 512, 32, 256, 17, 1_426_063_360)])
def test_step_plans_the_slabs_of_each_tape(monkeypatch, brdf, size, spp, rows, words, tape):
    """The plan depends on the tape's bytes alone: at the NEE cell's
    256x256x16 one slab, at the glossy cell's 512x512x32 two of 256 rows
    (2 x 1.43 GB glossy, 17 words a bounce; 2 x 1.17 GB diffuse, 14), each
    tape made for a slab of ``rows`` rows."""
    cfg = RenderConfig(width=size, height=size, spp=spp, nee=True, brdf=brdf)
    made = _record_tapes(monkeypatch)
    assert sweep.step_tapes(cfg, torch.device("cuda", 0)) == (rows, (1, 2))
    assert [m[1] for m in made] == [rows, rows]
    assert sweep.tape_shape(cfg, rows, spp) == (spp, size // 8 * rows // 8, 5, words, 64)
    assert sweep.tape_bytes(cfg, rows, spp) == tape
    assert 2 * sweep.tape_bytes(cfg, size, spp) > sweep.TAPE_BUDGET or rows == size


@pytest.mark.parametrize("extra", [dict(nee=True, brdf="glossy", width=4096, height=8, spp=512,
                                        max_bounces=16),
                                   dict(nee=True, width=4096, height=8, spp=512, max_bounces=16),
                                   dict(brdf="glossy", width=512, height=512, spp=32)])
def test_step_retraces_where_no_slab_fits_and_without_nee(monkeypatch, extra):
    """Where even one row's two tapes pass the budget (a 4096-wide row at
    512 spp and 16 bounces: 15.0 GB diffuse, 18.3 GB glossy a tape), and
    without NEE (K4's glossy albedo steps), the plan is one slab of the whole
    frame and no tape: the replays trace again."""
    cfg = RenderConfig(**extra)
    made = _record_tapes(monkeypatch)
    if cfg.nee:
        assert sweep.slab_rows(cfg) is None
        assert sweep.tape_bytes(cfg, 1, cfg.spp) > sweep.TAPE_BUDGET
    assert sweep.step_tapes(cfg, torch.device("cuda", 0)) == (cfg.height, (None, None))
    assert made == []


def test_a_slab_tape_views_the_step_tape():
    """A shorter slab's tape lies in the first words of the step's tape,
    unwritten and sized for its rows; one of more rows than the tape holds
    is refused."""
    cfg = RenderConfig(width=16, height=13, spp=2, max_bounces=2, nee=True, brdf="glossy",
                       block=4)
    tape = sweep.PathTape.empty(cfg, 7, 2, "cpu")
    tape.written = True
    short = tape.slab(cfg, 6, 2)
    assert not short.written and short.sizes == (6, 16, 2, 2, 4, 17)
    assert tuple(short.words.shape) == sweep.tape_shape(cfg, 6, 2) == (2, 8, 2, 17, 16)
    assert short.words.data_ptr() == tape.words.data_ptr() and short.words.is_contiguous()
    assert tape.slab(cfg, 7, 2).sizes == tape.sizes
    with pytest.raises(ValueError, match="cannot hold"):
        tape.slab(cfg, 9, 2)


@pytest.mark.parametrize("bad", ["plain", "words", "aov", "diffuse"])
def test_k4_wrapper_refuses_bad_tapes(state, bad):
    """K4's wrapper reads a path tape under NEE glossy with a colour
    cotangent alone: it refuses a tape on the CPU (the plain version traces
    every path), one of NEE diffuse's 14 words a bounce, and any tape with
    the AOV cotangents or under a configuration that has no taped K4."""
    _, _, scene, cam, _ = state
    cfg = dataclasses.replace(CFG, width=8, height=8, spp=1, brdf="glossy")
    tape = sweep.PathTape.empty(dataclasses.replace(cfg, brdf="diffuse") if bad == "words" else cfg,
                             8, 1, "cpu")
    tape.written = True
    if bad == "diffuse":
        cfg = dataclasses.replace(cfg, brdf="diffuse")
    ct = torch.zeros(ak.NUM_CT if bad == "aov" else ak.NUM_CT_COLOR, 8, 8)
    match = {"plain": "CUDA kernels'", "words": "made for"}.get(bad, "K4 reads a path tape")
    with pytest.raises(ValueError, match=match):
        ak.replay(scene.packed(), tk.camera_block(cam, cfg), tk.make_seed_block(cfg), cfg, ct,
                  local_h=8, spp=1, tape=tape)


def test_cross_grads_on_the_cpu_takes_no_tape(state, monkeypatch):
    """On the CPU ``cross_grads`` under NEE makes no path tape and returns
    the untaped route's bits: two colour passes, two retracing replays."""
    _, _, scene, cam, target = state

    def no_tape(*args, **kwargs):
        raise AssertionError("a path tape on the CPU")

    monkeypatch.setattr(sweep.PathTape, "empty", no_tape)
    step, t = 2, torch.from_numpy(target)
    loss, d = gk.cross_grads(scene, cam, CFG, step, t, device="cpu")
    a = tk.render_color_sums(scene, cam, CFG, 2 * step, device="cpu") / SPP
    b = tk.render_color_sums(scene, cam, CFG, 2 * step + 1, device="cpu") / SPP
    ra, rb = a - t, b - t
    block = (replay_block(scene, cam, 2 * step, rb / ra.numel())
             + replay_block(scene, cam, 2 * step + 1, ra / ra.numel()))
    want = sweep.scene_grads_from_block(block)
    assert torch.equal(loss, torch.sum(ra * rb) / ra.numel())
    assert set(d) == {"emission", "color", "position", "radius"}
    for name, g in d.items():
        assert torch.equal(g, getattr(want, name)), name


@pytest.mark.parametrize("brdf", ["diffuse", "glossy"])
def test_cross_grads_in_row_slabs_is_the_whole_frame(state, monkeypatch, brdf):
    """``cross_grads`` planned in slabs of 6 rows (6, 6 and 4 of the 16) gives
    the whole frame's loss to the bit, the residual being per pixel, and its
    gradients up to the order in which the slabs' sums add."""
    _, _, scene, cam, target = state
    cfg = dataclasses.replace(CFG, brdf=brdf)
    t = torch.from_numpy(target)
    loss, d = gk.cross_grads(scene, cam, cfg, 1, t, device="cpu")
    monkeypatch.setattr(sweep, "step_tapes", lambda cfg_, device: (6, (None, None)))
    slab_loss, slab_d = gk.cross_grads(scene, cam, cfg, 1, t, device="cpu")
    assert torch.equal(slab_loss, loss)
    for name, g in d.items():
        torch.testing.assert_close(slab_d[name], g, rtol=1e-6, atol=1e-6 * float(g.abs().max()),
                                   msg=name)
