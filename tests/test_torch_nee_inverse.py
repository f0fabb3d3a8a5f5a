"""The NEE inverse step (geometry on the kernel route) and learning-rate schedules.

The geometry case of scripts/inverse_demo.py at a small size: sphere 6 of
the Cornell box displaced and shrunk, position and radius optimized under
NEE with decaying learning rates and gradients masked to that sphere. The
same numpy scene and target go through ``pathtrace_tpu.inverse.
make_inverse_step`` (``backend="jnp"``, optax schedules) and the port's, on
both of its routes: autograd through the wavefront (``"torch"``) and
``grad_kernel.cross_grads`` on the forward kernel's colour sums and the NEE
replay's plain version (``"cuda"`` on CPU tensors).

Tolerances, at 32x32, 4 spp, 3 bounces:

- loss of each step: rtol 5e-3 (measured worst 1.1e-3: a pixel in a
  thousand takes another path in one of the packages);
- sphere 6's gradients of each step: rtol 5e-2 plus 1e-1 of the largest
  |JAX| entry of the field (the cross-estimator's geometry tolerance of
  tests/test_torch_nee_grad.py);
- parameters: the first Adam step moves every entry with a gradient by
  exactly the scheduled rate, so after step 1 within 1e-5; after step 3
  within a tenth of the first rate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pathtrace_tpu import Camera as JaxCamera
from pathtrace_tpu import RenderConfig as JaxConfig
from pathtrace_tpu import cornell_box as jax_cornell_box
from pathtrace_tpu import inverse as jax_inverse

from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box
from pathtrace_tpu_torch import inverse
from pathtrace_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from pathtrace_tpu_torch.ops import grad_kernel as gk
from pathtrace_tpu_torch.scene import Scene

SIZE, SPP, BOUNCES, SEED, STEPS = 32, 4, 3, 5, 3
RATES = {"position": (0.5, 4, 0.02), "radius": (0.1, 4, 0.02)}  # init, steps, rate
FIELDS = ("radius", "position", "emission", "color")


def displaced(position, radius):
    position, radius = position.copy(), radius.copy()
    position[6] += np.array([6.0, -4.0, 8.0], np.float32)
    radius[6] *= 0.8
    return position, radius


@pytest.mark.parametrize("step", [0, 1, 7, 400, 1000])
@pytest.mark.parametrize("init,steps,rate", [(0.5, 400, 0.02), (0.1, 400, 0.02), (1e-3, 7, 0.5)])
def test_exponential_decay_is_optax(init, steps, rate, step):
    want = float(optax.exponential_decay(init, steps, rate)(step))
    assert inverse.exponential_decay(init, steps, rate)(step) == pytest.approx(want, rel=1e-6)


def test_exponential_decay_rejects_no_steps():
    with pytest.raises(ValueError):
        inverse.exponential_decay(0.5, 0, 0.02)


@pytest.fixture(scope="module")
def jax_run():
    """Three JAX steps on the geometry case: losses, sphere 6's gradients and
    parameters after each step."""
    jscene, jcam = jax_cornell_box(), JaxCamera.create()
    bad_pos, bad_rad = displaced(np.asarray(jscene.position), np.asarray(jscene.radius))
    jbad = jscene.replace(position=jnp.asarray(bad_pos), radius=jnp.asarray(bad_rad))
    target = np.random.default_rng(1).uniform(size=(SIZE, SIZE, 3)).astype(np.float32)
    cfg = JaxConfig(width=SIZE, height=SIZE, spp=SPP, max_bounces=BOUNCES, seed=SEED,
                    backend="jnp", nee=True)
    masks = {"position": jnp.zeros((9, 1)).at[6].set(1.0), "radius": jnp.zeros((9,)).at[6].set(1.0)}
    rates = {k: optax.exponential_decay(*v) for k, v in RATES.items()}
    state, step_fn, _ = jax_inverse.make_inverse_step(
        jbad, jcam, cfg, jnp.asarray(target), ("position", "radius"), rates, grad_mask=masks)

    def loss_fn(params, step):
        from pathtrace_tpu.grad import render_color

        scene = jax_inverse._apply_params(jbad, params)
        a = render_color(scene, jcam, cfg, frame=2 * step)
        b = render_color(scene, jcam, cfg, frame=2 * step + 1)
        return jnp.mean((a - target) * (b - target))

    losses, grads, params = [], [], []
    for i in range(STEPS):
        g = jax.grad(loss_fn)(state.params, i)
        grads.append({k: np.asarray(v)[6] for k, v in g.items()})
        state, loss = step_fn(state)
        losses.append(float(loss))
        params.append({k: np.asarray(v) for k, v in state.params.items()})
    scene = scene_from_numpy(*(np.asarray(getattr(jbad, f)) for f in FIELDS))
    cam = camera_from_numpy(np.asarray(jcam.position), np.asarray(jcam.yaw),
                            np.asarray(jcam.pitch))
    return scene, cam, target, losses, grads, params


def port_step(scene, cam, target, backend):
    cfg = RenderConfig(width=SIZE, height=SIZE, spp=SPP, max_bounces=BOUNCES, seed=SEED,
                       backend=backend, nee=True)
    pos_mask, rad_mask = torch.zeros(9, 1), torch.zeros(9)
    pos_mask[6] = rad_mask[6] = 1.0
    rates = {k: inverse.exponential_decay(*v) for k, v in RATES.items()}
    return inverse.make_inverse_step(scene, cam, cfg, torch.from_numpy(target),
                                     ("position", "radius"), rates,
                                     grad_mask={"position": pos_mask, "radius": rad_mask})


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_scheduled_geometry_steps_match_jax(jax_run, backend):
    scene, cam, target, losses, grads, params = jax_run
    state, step_fn, opt = port_step(scene, cam, target, backend)
    start = {k: v.detach().clone() for k, v in state.params.items()}
    for i in range(STEPS):
        state, loss = step_fn(state)
        np.testing.assert_allclose(float(loss), losses[i], rtol=5e-3)
        for group, name in zip(opt.param_groups, ("position", "radius")):
            want_lr = float(optax.exponential_decay(*RATES[name])(i))
            assert group["lr"] == pytest.approx(want_lr, rel=1e-6)
            g = state.params[name].grad.numpy()
            want = grads[i][name]
            np.testing.assert_allclose(g[6], want, rtol=5e-2, atol=1e-1 * np.abs(want).max(),
                                       err_msg=f"{name} step {i}")
            frozen = np.arange(9) != 6
            assert not g[frozen].any()
            p = state.params[name].detach().numpy()
            assert np.array_equal(p[frozen], start[name].numpy()[frozen])
            tol = 1e-5 if i == 0 else 0.1 * RATES[name][0]
            np.testing.assert_allclose(p[6], params[i][name][6], rtol=0, atol=tol,
                                       err_msg=f"{name} after step {i + 1}")
            if i == 0:  # Adam's first step is the rate, whatever the gradient's size
                moved = np.abs(p[6] - start[name].numpy()[6])  # eps 1e-8 on |g| ~ 1e-4
                np.testing.assert_allclose(moved, RATES[name][0], rtol=1e-3)
    assert state.step == STEPS


def test_kernel_route_step_matches_autograd_route():
    """One NEE inverse step on all four scene fields, ``cross_grads`` (forward
    kernel + NEE replay, plain versions) against autograd through the
    wavefront, on the same lattice: positions and radii included. Loss rtol
    2e-3; gradients rtol 2e-2 plus, of the field's largest entry, 2e-2
    (emission, albedo) or 1e-1 (position, radius)."""
    scene, cam = cornell_box(), Camera.create()
    pos, rad = displaced(scene.position.numpy(), scene.radius.numpy())
    color = scene.color.clone()
    color[0, 0], color[1, 1] = 1.0, 0.0  # on the albedo clip's edges
    start = Scene(rad, pos, scene.emission, color)
    target = torch.from_numpy(
        np.random.default_rng(2).uniform(size=(SIZE, SIZE, 3)).astype(np.float32))
    got = {}
    for backend in ("cuda", "torch"):
        cfg = RenderConfig(width=SIZE, height=SIZE, spp=SPP, max_bounces=BOUNCES, seed=SEED,
                           backend=backend, nee=True)
        state, step_fn, _ = inverse.make_inverse_step(start, cam, cfg, target, FIELDS, 1e-3)
        _, loss = step_fn(state)
        got[backend] = (float(loss), {k: p.grad.numpy() for k, p in state.params.items()})
    np.testing.assert_allclose(got["cuda"][0], got["torch"][0], rtol=2e-3)
    for name in FIELDS:
        want = got["torch"][1][name]
        atol = 1e-1 if name in ("position", "radius") else 2e-2
        np.testing.assert_allclose(got["cuda"][1][name], want, rtol=2e-2,
                                   atol=atol * np.abs(want).max(), err_msg=name)
        assert np.abs(got["cuda"][1][name]).max() > 0


def test_nee_step_gradients_are_the_cross_grads():
    """The kernel route hands ``cross_grads``' four gradients to Adam as they
    are, the albedo's through the clip's subgradient."""
    scene, cam = cornell_box(), Camera.create()
    cfg = RenderConfig(width=16, height=16, spp=2, max_bounces=3, seed=1, backend="cuda",
                       nee=True)
    target = torch.zeros(16, 16, 3)
    state, step_fn, _ = inverse.make_inverse_step(scene, cam, cfg, target, FIELDS, 1e-3)
    _, loss = step_fn(state)
    want_loss, want = gk.cross_grads(scene, cam, cfg, 0, target)
    assert torch.equal(loss, want_loss)
    for name in ("radius", "position", "emission"):
        assert torch.equal(state.params[name].grad, want[name])
    edge = (scene.color == 0.0) | (scene.color == 1.0)
    assert torch.equal(state.params["color"].grad, torch.where(edge, 0.5, 1.0) * want["color"])


def test_scalar_schedule_and_constant_rates_mix():
    scene, cam = cornell_box(), Camera.create()
    cfg = RenderConfig(width=8, height=8, spp=1, seed=2, nee=True)
    target = torch.zeros(8, 8, 3)
    state, step_fn, opt = inverse.make_inverse_step(
        scene, cam, cfg, target, ("position", "color"),
        {"position": inverse.exponential_decay(0.5, 2, 0.25), "color": 1e-2})
    seen = []
    for _ in range(3):
        state, _ = step_fn(state)
        seen.append([g["lr"] for g in opt.param_groups])
    assert seen == [[0.5, 1e-2], [0.25, 1e-2], [0.125, 1e-2]]
    state, step_fn, opt = inverse.make_inverse_step(scene, cam, cfg, target, ("radius",),
                                                    lambda step: 0.1 / (1 + step))
    for _ in range(2):
        state, _ = step_fn(state)
    assert opt.param_groups[0]["lr"] == pytest.approx(0.05)
