"""The glossy inverse step on the kernel route, against the JAX package's.

NEE glossy, albedo, position and radius optimized together: the same numpy
scene (every albedo corrupted, sphere 6 displaced and shrunk) and target go
through ``pathtrace_tpu.inverse.make_inverse_step`` (``backend="jnp"``,
optax, under ``jax.disable_jit()`` as in tests/test_torch_inverse.py) and
the port's, on both of its routes: autograd through the wavefront
(``"torch"``) and ``grad_kernel.cross_grads`` on the forward kernel's
colour sums and K4's replay (``"cuda"`` on CPU tensors: the plain versions).

Tolerances, at 32x32, 4 spp, 3 bounces, the cross-estimator's of
tests/test_torch_inverse.py and tests/test_torch_nee_inverse.py:

- loss of each step: rtol 5e-3;
- albedo gradient of each step: rtol 2e-2 plus 2e-2 of the largest |JAX|
  entry; position and radius: rtol 5e-2 plus 1e-1 of the largest (a
  grazing hit's 1 / sqrt(det) amplifies the two packages' rounding);
- parameters: after the first step every entry whose gradient exceeds 1e-3
  of the field's largest has moved by the rate, within 1e-5 of the JAX
  package's; after the third, within a tenth of the rate.
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
from pathtrace_tpu_torch.ops import grad_kernel as gk

SIZE, SPP, BOUNCES, SEED, STEPS = 32, 4, 3, 5, 3
OPTIMIZE = ("color", "position", "radius")
RATES = {"color": 2e-2, "position": 0.5, "radius": 0.1}
GRAD_TOL = {"color": (2e-2, 2e-2), "position": (5e-2, 1e-1), "radius": (5e-2, 1e-1)}
FIELDS = ("radius", "position", "emission", "color")
KW = dict(width=SIZE, height=SIZE, spp=SPP, max_bounces=BOUNCES, seed=SEED, nee=True,
          brdf="glossy")


def corrupted(scene_np):
    radius, position, emission, color = (x.copy() for x in scene_np)
    color = np.clip(color + np.random.default_rng(0).uniform(-0.35, 0.35, (9, 3)),
                    0.05, 0.95).astype(np.float32)
    color[0] = [0.0, 1.0, 0.5]  # on the clip's boundary
    position[6] += np.array([6.0, -4.0, 8.0], np.float32)
    radius[6] *= 0.8
    return radius, position, emission, color


@pytest.fixture(scope="module")
def jax_run():
    """Three JAX steps: losses, gradients and parameters after each step."""
    jscene, jcam = jax_cornell_box(), JaxCamera.create()
    bad = corrupted([np.asarray(getattr(jscene, f)) for f in FIELDS])
    jbad = jscene.replace(**{f: jnp.asarray(x) for f, x in zip(FIELDS, bad)})
    target = np.random.default_rng(1).uniform(size=(SIZE, SIZE, 3)).astype(np.float32)
    cfg = JaxConfig(backend="jnp", **KW)

    def loss_fn(params, step):
        scene = jax_inverse._apply_params(jbad, params)
        a = jax_render_color(scene, jcam, cfg, frame=2 * step)
        b = jax_render_color(scene, jcam, cfg, frame=2 * step + 1)
        return jnp.mean((a - target) * (b - target))

    losses, grads, params = [], [], []
    with jax.disable_jit():
        state, step_fn, _ = jax_inverse.make_inverse_step(jbad, jcam, cfg, jnp.asarray(target),
                                                          OPTIMIZE, dict(RATES))
        for i in range(STEPS):
            g = jax.grad(loss_fn)(state.params, i)
            grads.append({k: np.asarray(v) for k, v in g.items()})
            state, loss = step_fn(state)
            losses.append(float(loss))
            params.append({k: np.asarray(v) for k, v in state.params.items()})
    scene = scene_from_numpy(*bad)
    cam = camera_from_numpy(np.asarray(jcam.position), np.asarray(jcam.yaw),
                            np.asarray(jcam.pitch))
    return scene, cam, target, losses, grads, params


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_glossy_inverse_steps_match_jax(jax_run, backend):
    scene, cam, target, losses, grads, params = jax_run
    cfg = RenderConfig(backend=backend, **KW)
    state, step_fn, _ = inverse.make_inverse_step(scene, cam, cfg, torch.from_numpy(target),
                                                  OPTIMIZE, dict(RATES))
    for i in range(STEPS):
        state, loss = step_fn(state)
        np.testing.assert_allclose(float(loss), losses[i], rtol=5e-3)
        for name in OPTIMIZE:
            g, want = state.params[name].grad.numpy(), grads[i][name]
            rtol, atol = GRAD_TOL[name]
            np.testing.assert_allclose(g, want, rtol=rtol, atol=atol * np.abs(want).max(),
                                       err_msg=f"{name} step {i}")
            p = state.params[name].detach().numpy()
            if i == 0:
                big = np.abs(want) > 1e-3 * np.abs(want).max()
                np.testing.assert_allclose(p[big], params[0][name][big], rtol=0, atol=1e-5,
                                           err_msg=name)
            np.testing.assert_allclose(p, params[i][name], rtol=0, atol=0.1 * RATES[name],
                                       err_msg=f"{name} after step {i + 1}")
    assert state.step == STEPS


@pytest.mark.parametrize("extra", [{"brdf": "glossy"}, {"brdf": "glossy", "nee": True}],
                         ids=["glossy", "nee_glossy"])
def test_glossy_step_gradients_are_the_cross_grads(extra):
    """The kernel route hands ``cross_grads``' four gradients to Adam as they
    are, the albedo's through the clip's subgradient."""
    scene, cam = cornell_box(), Camera.create()
    cfg = RenderConfig(width=16, height=16, spp=2, max_bounces=3, seed=1, backend="cuda",
                       **extra)
    target = torch.zeros(16, 16, 3)
    state, step_fn, _ = inverse.make_inverse_step(scene, cam, cfg, target, FIELDS, 1e-3)
    _, loss = step_fn(state)
    want_loss, want = gk.cross_grads(scene, cam, cfg, 0, target)
    assert torch.equal(loss, want_loss) and set(want) == set(FIELDS)
    for name in ("radius", "position", "emission"):
        assert torch.equal(state.params[name].grad, want[name])
    edge = (scene.color == 0.0) | (scene.color == 1.0)
    assert torch.equal(state.params["color"].grad, torch.where(edge, 0.5, 1.0) * want["color"])
    assert bool(want["position"].any()) == cfg.nee and want["color"].any()


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_recover_glossy_wall_albedo_moves_toward_red(backend):
    """Under NEE and the glossy BRDF the red wall corrupted to grey is pulled
    back toward (0.75, 0.25, 0.25) in a dozen steps, on either route.
    (Without NEE no path of a 16x16x8 frame that meets that wall goes on to
    the light through near-mirror bounces: its albedo gets no gradient.)"""
    scene, cam = cornell_box(), Camera.create()
    cfg = RenderConfig(width=16, height=16, spp=4, seed=11, backend=backend, brdf="glossy",
                       nee=True)
    color = scene.color.clone()
    color[0] = 0.5
    corrupted_scene = type(scene)(scene.radius, scene.position, scene.emission, color)
    recovered, losses = inverse.recover_scene(scene, corrupted_scene, cam, cfg,
                                              optimize=("color",), steps=12, learning_rate=5e-2,
                                              target_spp=16)
    assert np.all(np.isfinite(losses))
    wall = recovered.color[0]
    assert wall[0] > 0.55 and wall[1] < 0.45 and wall[2] < 0.45, wall
