"""The gradient kernels' plain PyTorch versions against the Pallas kernels.

Both draw the same lattice, so values are compared directly. The JAX side
runs ``pallas_grad`` in interpret mode on the CPU, as its own tests do; one
module fixture makes the three calls (fused, the dump slab at a row and a
sample offset, and the replay) at 128x16 and 4 spp with 3 bounces: at 5
bounces each call took 25-30 s here, at 3 about 13 s. Tolerances:

- loss: rtol 1e-4;
- gradients across the two packages: rtol 2e-2, atol 2e-3 of the largest
  |Pallas| entry (tests/test_pallas_grad.py's), since a borderline hit
  decision may round the other way in one of them;
- mean colour and accumulators: at most 1% of pixels off by more than 1e-3
  (of the channel's range, for the accumulators);
- the port's modes against each other (fused = dump + contraction =
  replay, same lattice): ``grad_kernel.agreement``'s sums rule, rtol 1e-4
  plus 1e-8 of the largest.

The kernel against the plain version on the card is in
tests/test_torch_grad_kernel_cuda.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtrace_tpu import Camera as JaxCamera
from pathtrace_tpu import RenderConfig as JaxConfig
from pathtrace_tpu import cornell_box as jax_cornell_box
from pathtrace_tpu.ops import pallas_grad

from pathtrace_tpu_torch import RenderConfig
from pathtrace_tpu_torch import grad as port_grad
from pathtrace_tpu_torch import inverse as port_inverse
from pathtrace_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from pathtrace_tpu_torch.ops import grad_kernel as gk
from pathtrace_tpu_torch.ops import trace_kernel as tk
from pathtrace_tpu_torch.scene import Scene

WIDTH, HEIGHT, SPP, BOUNCES, SEED = 128, 16, 4, 3, 7
ROW_OFFSET, LOCAL_H, SAMPLE_OFFSET = 8, 8, 3
CFG = RenderConfig(width=WIDTH, height=HEIGHT, spp=SPP, max_bounces=BOUNCES, seed=SEED,
                   backend="cuda")
DENOM = WIDTH * HEIGHT * 3


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x, np.float64)


def assert_grads_close(got, want):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=2e-2, atol=2e-3 * np.abs(want).max())


def assert_agree(got, ref, kind):
    checks, _ = gk.agreement(got, ref, kind)
    failed = [(name, share) for name, share, _, ok in checks if not ok]
    assert not failed, failed


def flat(d_e, d_c):
    return torch.cat([d_e, d_c], dim=1).reshape(-1)


@pytest.fixture(scope="module")
def state():
    jscene, jcam = jax_cornell_box(), JaxCamera.create()
    scene = scene_from_numpy(*(np.asarray(getattr(jscene, f))
                               for f in ("radius", "position", "emission", "color")))
    cam = camera_from_numpy(np.asarray(jcam.position), np.asarray(jcam.yaw),
                            np.asarray(jcam.pitch))
    target = np.random.default_rng(0).uniform(size=(HEIGHT, WIDTH, 3)).astype(np.float32)
    return jscene, jcam, scene, cam, target


@pytest.fixture(scope="module")
def pallas_refs(state):
    """The three interpret-mode Pallas calls, numpy results by name."""
    jscene, jcam, _, _, target = state
    cfg = JaxConfig(width=WIDTH, height=HEIGHT, spp=SPP, max_bounces=BOUNCES, seed=SEED)
    loss, d_e, d_c, color = pallas_grad.fused_loss_grads_pallas(
        jscene, jcam, cfg, 0, jnp.asarray(target), interpret=True)
    slab_color, slab_acc = pallas_grad.grad_acc_slab(
        jscene, jcam, cfg, 0, row_offset=ROW_OFFSET, local_h=LOCAL_H, spp=SPP,
        sample_offset=SAMPLE_OFFSET, interpret=True)
    ct = 2.0 * (np.asarray(color) - target) / DENOM
    r_e, r_c = pallas_grad.render_color_grads_pallas(jscene, jcam, cfg, 0, jnp.asarray(ct),
                                                      interpret=True)
    out = dict(loss=loss, d_e=d_e, d_c=d_c, color=color, slab_color=slab_color,
               slab_acc=slab_acc, ct=ct, r_e=r_e, r_c=r_c)
    return {k: np.array(v) for k, v in out.items()}


def test_fused_plain_matches_pallas(state, pallas_refs):
    _, _, scene, cam, target = state
    loss, d_e, d_c, color = gk.fused_loss_grads(scene, cam, CFG, 0, torch.from_numpy(target),
                                                device="cpu")
    np.testing.assert_allclose(float(loss), float(pallas_refs["loss"]), rtol=1e-4)
    assert_grads_close(d_e, pallas_refs["d_e"])
    assert_grads_close(d_c, pallas_refs["d_c"])
    assert_agree(color, torch.from_numpy(pallas_refs["color"]), "color")


def test_dump_slab_plain_matches_pallas(state, pallas_refs):
    """Row and sample offsets address the global lattice."""
    _, _, scene, cam, _ = state
    color, acc = gk.grad_acc_slab(scene, cam, CFG, 0, row_offset=ROW_OFFSET, local_h=LOCAL_H,
                                  spp=SPP, sample_offset=SAMPLE_OFFSET, device="cpu")
    assert acc.shape == (LOCAL_H, WIDTH, 54) and color.shape == (LOCAL_H, WIDTH, 3)
    assert_agree(color, torch.from_numpy(pallas_refs["slab_color"]), "color")
    assert_agree(acc, torch.from_numpy(pallas_refs["slab_acc"]), "acc")


def test_replay_plain_matches_pallas(state, pallas_refs):
    _, _, scene, cam, _ = state
    d_e, d_c = gk.render_color_grads(scene, cam, CFG, 0, torch.from_numpy(pallas_refs["ct"]),
                                     device="cpu")
    assert_grads_close(d_e, pallas_refs["r_e"])
    assert_grads_close(d_c, pallas_refs["r_c"])


def test_plain_modes_agree(state):
    """fused = dump + contraction = replay on one lattice."""
    _, _, scene, cam, target = state
    target = torch.from_numpy(target)
    loss, d_e, d_c, color = gk.fused_loss_grads(scene, cam, CFG, 0, target, device="cpu")
    color_d, acc = gk.render_grad_acc(scene, cam, CFG, 0, device="cpu")
    assert torch.equal(color, color_d)
    ct = 2.0 * (color - target) / DENOM
    fused = flat(d_e, d_c)
    assert_agree(flat(*gk.contract(ct, acc)), fused, "sums")
    assert_agree(flat(*gk.render_color_grads(scene, cam, CFG, 0, ct, device="cpu")), fused, "sums")
    assert_agree(loss[None], torch.mean((color - target) ** 2)[None], "sums")


def test_render_color_backward_is_the_contraction(state):
    """The autograd.Function: the dump forward, the contraction backward,
    exact zeros for geometry and camera."""
    _, _, scene, cam, _ = state
    leaves = {k: getattr(scene, k).clone().requires_grad_(True)
              for k in ("radius", "position", "emission", "color")}
    yaw = cam.yaw.clone().requires_grad_(True)
    img = port_grad.render_color(Scene(**leaves), type(cam)(cam.position, yaw, cam.pitch),
                                 CFG, 2, device="cpu")
    ct = torch.from_numpy(np.random.default_rng(1).normal(size=img.shape).astype(np.float32))
    (img * ct).sum().backward()
    color, acc = gk.render_grad_acc(scene, cam, CFG, 2, device="cpu")
    assert torch.equal(img.detach(), color)
    d_e, d_c = gk.contract(ct, acc)
    assert torch.equal(leaves["emission"].grad, d_e) and torch.equal(leaves["color"].grad, d_c)
    assert not leaves["position"].grad.any() and not leaves["radius"].grad.any()
    assert yaw.grad is not None and not yaw.grad.any()


def test_cross_grads_is_the_inverse_step_gradient(state):
    """cross_grads (two dumps, each contracted against the other's residual)
    gives the loss and gradients that autograd takes through render_color
    for the inverse step's cross-estimator, on the same lattice."""
    _, _, scene, cam, target = state
    target = torch.from_numpy(target)
    loss, grads = gk.cross_grads(scene, cam, CFG, 1, target, device="cpu")
    emission = scene.emission.clone().requires_grad_(True)
    color = scene.color.clone().requires_grad_(True)
    s = Scene(scene.radius, scene.position, emission, color)
    a = port_grad.render_color(s, cam, CFG, 2, device="cpu")
    b = port_grad.render_color(s, cam, CFG, 3, device="cpu")
    loss_ad = torch.mean((a - target) * (b - target))
    loss_ad.backward()
    assert_agree(loss[None], loss_ad.detach()[None], "sums")
    assert_agree(flat(grads["emission"], grads["color"]), flat(emission.grad, color.grad), "sums")


def test_kernel_inverse_step_matches_autograd(state):
    """The inverse step's kernel route (cross_grads, the clip's subgradient
    by hand, the mask) gives the loss and gradients of autograd through
    render_color and clip01, with albedos on the clip's edges (0, 1) and
    outside it."""
    _, _, scene, cam, target = state
    target = torch.from_numpy(target)
    color = scene.color.clone()
    color[0, 0], color[1, 1], color[2, 2], color[3, 0] = 1.0, 0.0, 1.25, -0.5
    start = Scene(scene.radius, scene.position, scene.emission, color)
    mask = torch.ones_like(scene.emission)
    mask[4] = 0.0
    state_, step_fn, _ = port_inverse.make_inverse_step(
        start, cam, CFG, target, ("emission", "color", "position"), 1e-3,
        grad_mask={"emission": mask}, device="cpu")
    _, loss = step_fn(state_)
    got = {k: p.grad for k, p in state_.params.items()}

    leaves = {k: getattr(start, k).clone().requires_grad_(True) for k in ("emission", "color")}
    s = port_inverse.apply_params(start, leaves)
    a = port_grad.render_color(s, cam, CFG, 0, device="cpu")
    b = port_grad.render_color(s, cam, CFG, 1, device="cpu")
    loss_ad = torch.mean((a - target) * (b - target))
    d_e, d_c = torch.autograd.grad(loss_ad, [leaves["emission"], leaves["color"]])
    assert_agree(loss[None], loss_ad.detach()[None], "sums")
    assert_agree(flat(got["emission"], got["color"]), flat(d_e * mask, d_c), "sums")
    assert not got["position"].any()
    # The edges carry half the unclipped gradient, the outside none.
    _, d = gk.cross_grads(port_inverse.apply_params(start, {"color": color}), cam, CFG, 0,
                          target, device="cpu")
    unclipped = d["color"]
    assert unclipped[0, 0] != 0 and unclipped[1, 1] != 0
    torch.testing.assert_close(got["color"][0, 0], 0.5 * unclipped[0, 0], rtol=1e-4, atol=0)
    assert got["color"][2, 2] == 0 and got["color"][3, 0] == 0


def test_cuda_backend_matches_torch_backend(state):
    """render_loss_grads through the fused kernel's plain version against
    autograd through the wavefront, both on the CPU."""
    _, _, scene, cam, target = state
    target = torch.from_numpy(target)
    loss, (ds, dc) = port_grad.render_loss_grads(scene, cam, CFG, 0, target, device="cpu")
    loss_t, (ds_t, dc_t) = port_grad.render_loss_grads(
        scene, cam, dataclasses.replace(CFG, backend="torch"), 0, target, device="cpu")
    np.testing.assert_allclose(float(loss), float(loss_t), rtol=1e-4)
    assert_grads_close(ds.emission, ds_t.emission)
    assert_grads_close(ds.color, ds_t.color)
    for x in (ds.position, ds.radius, dc.position, dc.yaw, dc.pitch):
        assert not x.any()


@pytest.mark.parametrize("extra", [{"nee": True, "brdf": "glossy"}, {"brdf": "glossy"}])
@pytest.mark.parametrize("entry", ["loss_grads", "render_color", "inverse_step", "kernel"])
def test_cuda_backend_raises_for_unported_configs(state, extra, entry):
    """Glossy, with or without NEE, raised here while K4 was not ported. No
    configuration is unported any more: on "cuda" each entry point dispatches
    glossy to K4 (its plain version on the CPU) and returns finite gradients
    that reach the albedo and, through the NEE light sample, the geometry
    (without NEE the colour does not depend on it: exact zeros). Only the
    product-chain kernel's own wrapper still refuses what it does not
    compute, naming the module that does."""
    _, _, scene, cam, target = state
    cfg = dataclasses.replace(CFG, height=8, width=32, **extra)
    target = torch.from_numpy(target[:8, :32])
    if entry == "kernel":
        with pytest.raises(ValueError, match="ad_grad_kernel"):
            gk.dump(scene.packed(), tk.camera_block(cam, cfg), tk.make_seed_block(cfg), cfg,
                    local_h=8, spp=1)
        return
    if entry == "loss_grads":
        loss, (ds, _) = port_grad.render_loss_grads(scene, cam, cfg, 0, target, device="cpu")
        d_color, d_position = ds.color, ds.position
    elif entry == "render_color":
        leaves = [x.clone().requires_grad_(True) for x in (scene.position, scene.color)]
        s = Scene(scene.radius, leaves[0], scene.emission, leaves[1])
        loss = port_grad.l2_image_loss(port_grad.render_color(s, cam, cfg, device="cpu"), target)
        d_position, d_color = torch.autograd.grad(loss, leaves)
    else:
        state_, step_fn, _ = port_inverse.make_inverse_step(scene, cam, cfg, target,
                                                            ("color", "position"), device="cpu")
        before = {k: v.detach().clone() for k, v in state_.params.items()}
        state_, loss = step_fn(state_)
        d_color = state_.params["color"].detach() - before["color"]
        d_position = state_.params["position"].detach() - before["position"]
    assert torch.isfinite(loss) and loss > 0
    assert torch.isfinite(d_color).all() and (d_color != 0).sum() >= 3
    if cfg.nee:
        assert torch.isfinite(d_position).all() and (d_position != 0).sum() >= 3
    else:
        assert not d_position.any()


@pytest.mark.parametrize("kind", ["sums", "acc", "color"])
def test_agreement_sees_an_error(state, kind):
    """The comparison the card runs flags one wrong value, and a NaN."""
    _, _, scene, cam, _ = state
    cfg = dataclasses.replace(CFG, width=16, height=8, spp=1)
    color, acc = gk.render_grad_acc(scene, cam, cfg, 0, device="cpu")
    ref = {"sums": flat(*gk.contract(color, acc)), "acc": acc, "color": color}[kind]
    checks, err = gk.agreement(ref.clone(), ref, kind)
    assert err == 0.0 and all(ok for *_, ok in checks)
    bad = ref.clone()
    bad.view(-1)[bad.numel() // 2] += 1.0 + float(ref.abs().max())
    if kind != "sums":  # one pixel in 128 is within the 1% allowance: spoil 1 in 4
        bad.view(-1, ref.shape[-1])[::4] += 1.0 + float(ref.abs().max())
    checks, err = gk.agreement(bad, ref, kind)
    assert not all(ok for *_, ok in checks) and err >= 1.0
    bad = ref.clone()
    bad.view(-1)[0] = float("nan")
    checks, _ = gk.agreement(bad, ref, kind)
    assert {name for name, *_, ok in checks if not ok} == {"finite"}


@pytest.mark.parametrize("bad", ["bounces", "shape", "dtype", "device", "contiguous"])
def test_wrapper_rejects_bad_input(state, bad):
    _, _, scene, cam, _ = state
    cfg = dataclasses.replace(CFG, width=8, height=8, spp=1)
    target = torch.zeros(8, 8, 3)
    kw = dict(local_h=8, spp=1)
    if bad == "bounces":
        cfg = dataclasses.replace(cfg, max_bounces=gk.MAX_BOUNCES + 1)
    elif bad == "shape":
        target = torch.zeros(8, 7, 3)
    elif bad == "dtype":
        target = target.double()
    elif bad == "device":
        kw["device"] = "meta"
    elif bad == "contiguous":
        target = torch.zeros(8, 8, 6)[..., ::2]
    with pytest.raises(ValueError):
        gk.fused(scene.packed(), tk.camera_block(cam, cfg), tk.make_seed_block(cfg), cfg,
                 target, **kw)
