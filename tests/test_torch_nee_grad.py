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
from pathtrace_tpu_torch.ops import grad_kernel as gk
from pathtrace_tpu_torch.ops import nee_grad_kernel as nk
from pathtrace_tpu_torch.ops import trace_kernel as tk
from pathtrace_tpu_torch.scene import Scene

WIDTH, HEIGHT, SPP, BOUNCES, SEED = 128, 16, 2, 3, 3
CFG = RenderConfig(width=WIDTH, height=HEIGHT, spp=SPP, max_bounces=BOUNCES, seed=SEED,
                   backend="cuda", nee=True)
JCFG = JaxConfig(width=WIDTH, height=HEIGHT, spp=SPP, max_bounces=BOUNCES, seed=SEED,
                 backend="jnp", nee=True)
DENOM = WIDTH * HEIGHT * 3
CROSS_ATOL = nk.CROSS_ATOL
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


def assert_agree(got, ref, atol=None):
    checks, _ = nk.agreement(got, ref, "sums", nk.SUMS_ATOL if atol is None else atol)
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
    block = nk.block_from_sums(sums) / DENOM
    loss = block[scene.num_objects, nk.LOSS_COL]
    got = grads_to_numpy(*nk.grads_from_block(scene, cam, CFG, block))
    np.testing.assert_allclose(float(loss), jax_ref[0], rtol=1e-4)
    assert_seven_blocks_close(got, jax_ref[1])
    assert np.abs(got["position"]).max() > 0 and np.abs(got["radius"]).max() > 0
    assert np.abs(got["cam_position"]).max() > 0 and got["yaw"] != 0 and got["pitch"] != 0


def test_loss_grads_entry_points_dispatch_to_the_nee_kernel(state, jax_ref, fused_sums):
    """``render_loss_grads`` -> ``grad_kernel.loss_and_grads`` ->
    ``nee_loss_and_grads`` on "cuda": the fused mode, bit for bit."""
    _, _, scene, cam, target = state
    loss, (ds, dc) = port_grad.render_loss_grads(scene, cam, CFG, 0, torch.from_numpy(target))
    loss_k, (ds_k, dc_k) = nk.nee_loss_and_grads(scene, cam, CFG, 0, torch.from_numpy(target))
    block = nk.block_from_sums(fused_sums[2][0]) / DENOM
    assert torch.equal(loss, loss_k) and torch.equal(loss, block[9, nk.LOSS_COL])
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
    whole = nk.nee_grads_block_slab(scene, cam, CFG, 4, torch.from_numpy(ct))
    assert whole.shape == (14, nk.BLOCK_COLS)
    parts = 0
    for row in (0, 8):
        for offset, spp in ((0, 1), (1, 1)):
            parts = parts + nk.nee_grads_block_slab(
                scene, cam, CFG, 4, torch.from_numpy(ct[:, row:row + 8]), row_offset=row,
                local_h=8, spp=spp, sample_offset=offset)
    flat = lambda b: torch.cat([b[:9, :10].reshape(-1), b[9, :3], b[10:14, :3].reshape(-1),  # noqa: E731
                                b[9, 10:11]])
    assert_agree(flat(parts), flat(whole), CROSS_ATOL)
    # The whole frame through nee_color_grads: the same launch, 1/spp folded there.
    again = nk.nee_color_grads(scene, cam, CFG, 4, torch.from_numpy(ct * SPP).permute(1, 2, 0))
    assert torch.equal(again, whole)


def test_grads_from_block_matches_jax_vjp(state):
    """The corner rays' cotangents through ``eye_ray_basis``, the eye's added
    to the position: against ``jax.vjp`` of the JAX camera (rtol 1e-5 plus
    1e-6 of the largest: the same chain in another framework)."""
    jscene, jcam, scene, cam, _ = state
    block = np.random.default_rng(5).normal(size=(14, nk.BLOCK_COLS)).astype(np.float32)
    d_scene, d_cam = nk.grads_from_block(scene, cam, CFG, torch.from_numpy(block))
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
        nk.grads_from_block(scene, cam, CFG, torch.zeros(16, 128))


def test_render_color_backward_is_the_replay(state):
    """The autograd.Function under NEE: the forward kernel's colour forward,
    one replay backward, gradients for all seven leaves."""
    _, _, scene, cam, _ = state
    leaves = {k: getattr(scene, k).clone().requires_grad_(True) for k in SCENE_FIELDS}
    cam_leaves = [x.clone().requires_grad_(True) for x in (cam.position, cam.yaw, cam.pitch)]
    img = port_grad.render_color(Scene(**leaves), Camera(*cam_leaves), CFG, 2)
    assert torch.equal(img.detach(), tk.render_color_sums(scene, cam, CFG, 2) / SPP)
    ct = torch.from_numpy(np.random.default_rng(1).normal(size=img.shape).astype(np.float32))
    (img * ct).sum().backward()
    block = nk.nee_color_grads(scene, cam, CFG, 2, ct)
    want = grads_to_numpy(*nk.grads_from_block(scene, cam, CFG, block))
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
    loss, d = gk.cross_grads(scene, cam, CFG, step, torch.from_numpy(target))
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
    checks, err = nk.agreement(ref.clone(), ref, "sums")
    assert err == 0.0 and all(ok for *_, ok in checks)
    kinds = nk.entry_kinds(9)
    assert len(kinds) == ref.numel() == 106
    for k, name in enumerate(nk.KINDS):
        bad = ref.clone()
        bad[int(np.flatnonzero(kinds == k)[0])] += 1e-3 * float(ref[kinds == k].abs().max())
        failed = {n for n, *_, ok in nk.agreement(bad, ref, "sums")[0] if not ok}
        assert failed == {name}
    bad = ref.clone()
    bad[0] = float("nan")
    assert "finite" in {n for n, *_, ok in nk.agreement(bad, ref, "sums")[0] if not ok}
    with pytest.raises(ValueError):
        nk.agreement(ref[:-1], ref[:-1], "sums")


@pytest.mark.parametrize("bad", ["bounces", "shape", "dtype", "device", "contiguous", "nee",
                                 "shared"])
def test_wrapper_rejects_bad_input(state, bad):
    _, _, scene, cam, _ = state
    cfg = dataclasses.replace(CFG, width=8, height=8, spp=1)
    target = torch.zeros(8, 8, 3)
    kw = dict(local_h=8, spp=1)
    if bad == "bounces":
        cfg = dataclasses.replace(cfg, max_bounces=nk.MAX_BOUNCES + 1)
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
    if bad == "shared":  # 16 spheres: 254 floats a thread x 256 threads > 227 KB
        cfg = dataclasses.replace(cfg, block=16)
        sb = torch.cat([sb, sb[:7]])
    with pytest.raises(ValueError, match="shared memory" if bad == "shared" else None):
        nk.fused(sb, tk.camera_block(cam, cfg), tk.make_seed_block(cfg), cfg, target, **kw)


def test_block_layout():
    """Flat sums -> the JAX package's block rows and columns."""
    n = 3
    sums = torch.arange(10 * n + 16, dtype=torch.float32)
    block = nk.block_from_sums(sums)
    assert block.shape == (n + 5, nk.BLOCK_COLS)
    assert torch.equal(block[1, :10], sums[10:20])
    assert torch.equal(block[n, 0:3], sums[30:33]) and block[n, nk.LOSS_COL] == sums[-1]
    assert torch.equal(block[n + 1:, 0:3].reshape(-1), sums[33:45])
    assert nk.n_slots(9) == 156 and nk.n_slots(16) == 254
