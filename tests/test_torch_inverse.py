"""Inverse rendering: the port's Adam steps against the JAX package's.

The same numpy scene (the Cornell box with every albedo corrupted, some to
exactly 0 and 1, where the clip's subgradient is 1/2) and target go through
``pathtrace_tpu.inverse.make_inverse_step`` (``backend="jnp"``, optax) and
the port's (``torch.optim.Adam``), on both of the port's backends: autograd
through the wavefront (``"torch"``) and the dump kernel's plain version with
the contraction (``"cuda"`` on CPU tensors).

The JAX step runs under ``jax.disable_jit()``: XLA's fused CPU code rounds
differently from op-by-op evaluation and so sends more samples down another
path than the port does. Even op by op, 0.02-0.2% of the pixels of a 64x64
frame take another path in one of the packages (a borderline hit decision
on the r=1e5 walls), and one such pixel moves the cross-estimator by ~2e-4
of itself at this size. Hence:

- loss of each step: rtol 2e-3 (measured worst 1.2e-3);
- gradients of each step: rtol 2e-2, atol 2e-2 of the largest |JAX| entry,
  the JAX package's own tolerance for the cross-estimator
  (tests/test_pallas_grad.py, test_pallas_cross_grads_match_jnp_ad);
- parameters after the first step: within 1e-5 on each entry whose gradient
  exceeds 1e-3 of the largest, since Adam's first step is +-lr there (optax
  and torch order the same arithmetic differently); after the third: within
  2e-3, a tenth of the learning rate (measured worst 2.7e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtrace_tpu import Camera as JaxCamera
from pathtrace_tpu import RenderConfig as JaxConfig
from pathtrace_tpu import cornell_box as jax_cornell_box
from pathtrace_tpu import inverse as jax_inverse
from pathtrace_tpu.grad import render_color as jax_render_color

from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box
from pathtrace_tpu_torch import inverse
from pathtrace_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from pathtrace_tpu_torch.ops.sampling import clip01
from pathtrace_tpu_torch.scene import Scene

SIZE, SPP, BOUNCES, SEED, STEPS, LR = 64, 2, 3, 3, 3, 2e-2
FIELDS = ("radius", "position", "emission", "color")


def corrupted_colors(true_color):
    bad = np.clip(true_color + np.random.default_rng(0).uniform(-0.35, 0.35, (9, 3)),
                  0.05, 0.95).astype(np.float32)
    bad[0] = [0.0, 1.0, 0.5]  # on the clip's boundary
    return bad


@pytest.fixture(scope="module")
def jax_run():
    """Three JAX steps: (losses, gradients, parameters after each step)."""
    jscene, jcam = jax_cornell_box(), JaxCamera.create()
    jscene = jscene.replace(color=jnp.asarray(corrupted_colors(np.asarray(jscene.color))))
    target = np.random.default_rng(1).uniform(size=(SIZE, SIZE, 3)).astype(np.float32)
    cfg = JaxConfig(width=SIZE, height=SIZE, spp=SPP, max_bounces=BOUNCES, seed=SEED,
                    backend="jnp")

    def loss_fn(params, step):
        scene = jax_inverse._apply_params(jscene, params)
        a = jax_render_color(scene, jcam, cfg, frame=2 * step)
        b = jax_render_color(scene, jcam, cfg, frame=2 * step + 1)
        return jnp.mean((a - target) * (b - target))

    losses, grads, params = [], [], []
    with jax.disable_jit():
        state, step_fn, _ = jax_inverse.make_inverse_step(jscene, jcam, cfg, jnp.asarray(target),
                                                          learning_rate=LR)
        for i in range(STEPS):
            grads.append(np.asarray(jax.grad(loss_fn)(state.params, i)["color"]))
            state, loss = step_fn(state)
            losses.append(float(loss))
            params.append(np.asarray(state.params["color"]))
    scene = scene_from_numpy(*(np.asarray(getattr(jscene, f)) for f in FIELDS))
    cam = camera_from_numpy(np.asarray(jcam.position), np.asarray(jcam.yaw),
                            np.asarray(jcam.pitch))
    return scene, cam, target, losses, grads, params


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_inverse_steps_match_jax(jax_run, backend):
    scene, cam, target, losses, grads, params = jax_run
    cfg = RenderConfig(width=SIZE, height=SIZE, spp=SPP, max_bounces=BOUNCES, seed=SEED,
                       backend=backend)
    state, step_fn, _ = inverse.make_inverse_step(scene, cam, cfg, torch.from_numpy(target),
                                                  learning_rate=LR)
    for i in range(STEPS):
        state, loss = step_fn(state)
        np.testing.assert_allclose(float(loss), losses[i], rtol=2e-3)
        g = state.params["color"].grad.numpy()
        np.testing.assert_allclose(g, grads[i], rtol=2e-2, atol=2e-2 * np.abs(grads[i]).max())
        p = state.params["color"].detach().numpy()
        if i == 0:
            big = np.abs(grads[0]) > 1e-3 * np.abs(grads[0]).max()
            np.testing.assert_allclose(p[big], params[0][big], rtol=0, atol=1e-5)
    np.testing.assert_allclose(p, params[-1], rtol=0, atol=2e-3)
    assert state.step == STEPS


@pytest.mark.parametrize("p", [-0.1, 0.0, 0.5, 1.0, 1.2])
def test_albedo_clip_subgradient_matches_jax(p):
    """The gradient through apply_params' clip is the one pathtrace_tpu.inverse
    builds by hand for its Pallas step: 1 inside, 0 outside, 1/2 on the edge."""
    color = torch.full((9, 3), p, requires_grad=True)
    scene = inverse.apply_params(cornell_box(), {"color": color})
    scene.color.sum().backward()
    inside, edge = float(0.0 <= p <= 1.0), float(p in (0.0, 1.0))
    assert torch.all(color.grad == inside - 0.5 * edge)
    assert torch.equal(scene.color, clip01(color.detach()))


def test_recover_keeps_other_params():
    scene, cam = cornell_box(), Camera.create()
    cfg = RenderConfig(width=16, height=16, spp=2, seed=3)
    color = scene.color.clone()
    color[1] = 0.4
    corrupted = Scene(scene.radius, scene.position, scene.emission, color)
    recovered, losses = inverse.recover_scene(scene, corrupted, cam, cfg, optimize=("color",),
                                              steps=5)
    assert len(losses) == 5 and np.all(np.isfinite(losses))
    for field in ("radius", "position", "emission"):
        assert torch.equal(getattr(recovered, field), getattr(scene, field))
    assert not torch.equal(recovered.color, corrupted.color)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_recover_wall_albedo_moves_toward_red(backend):
    """The red wall corrupted to grey is pulled back toward (0.75, 0.25, 0.25)
    in a few tens of steps."""
    scene, cam = cornell_box(), Camera.create()
    cfg = RenderConfig(width=16, height=16, spp=8, seed=11, backend=backend)
    color = scene.color.clone()
    color[0] = 0.5
    corrupted = Scene(scene.radius, scene.position, scene.emission, color)
    recovered, losses = inverse.recover_scene(scene, corrupted, cam, cfg, optimize=("color",),
                                              steps=30, learning_rate=5e-2, target_spp=32)
    assert np.all(np.isfinite(losses))
    wall = recovered.color[0]
    assert wall[0] > 0.55 and wall[1] < 0.45 and wall[2] < 0.45, wall


def test_learning_rates_and_grad_mask():
    scene, cam = cornell_box(), Camera.create()
    cfg = RenderConfig(width=8, height=8, spp=1, seed=2)
    target = torch.zeros(8, 8, 3)
    with pytest.raises(ValueError, match="missing"):
        inverse.make_inverse_step(scene, cam, cfg, target, ("color", "emission"),
                                  {"color": 1e-2})
    _, _, opt = inverse.make_inverse_step(scene, cam, cfg, target, ("color",),
                                          {"color": lambda n: 0.25})  # a schedule
    assert [g["lr"] for g in opt.param_groups] == [0.25]
    mask = torch.zeros(9, 1)
    mask[2] = 1.0  # the back wall: emission 0, on the clamp's edge, so its gradient is not 0
    state, step_fn, opt = inverse.make_inverse_step(
        scene, cam, cfg, target, ("color", "emission"), {"color": 1e-2, "emission": 0.5},
        grad_mask={"emission": mask})
    assert [g["lr"] for g in opt.param_groups] == [1e-2, 0.5]
    for _ in range(2):
        state, _ = step_fn(state)
    emission = state.params["emission"].detach()
    frozen = torch.arange(9) != 2
    assert torch.equal(emission[frozen], scene.emission[frozen])
    assert not torch.equal(emission[2], scene.emission[2])
