"""The port's autograd gradients against the JAX package's jnp reverse mode.

Both packages trace the same paths (same RNG lattice) at 32x32, 4 spp (the
CFG of tests/test_grad.py), the port on its ``"torch"`` backend. The scene
and camera are carried across with ``convert``; the target is made with
numpy. Tolerances:

- loss: rtol 1e-4;
- emission and albedo gradients: rtol 2e-2, atol 2e-3 of the largest |JAX|
  entry (tests/test_pallas_grad.py's): a borderline hit decision that
  rounds the other way moves single entries;
- geometry-probe gradients (sphere position and radius, camera position,
  yaw, pitch): rtol 1e-3, atol 1e-4 of the block's largest entry; measured
  agreement is 4e-5 of the largest;
- NEE gradients of geometry and camera: rtol 2e-2, atol 2e-2 of the
  block's largest entry. A shadow-ray decision that flips toggles one
  sample's Lambert term; the blocks' large entries agree to < 1%, while a
  small entry such as yaw moved by 2% (seed 5) to 14% (seed 7) of itself.
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
from pathtrace_tpu import grad as jax_grad

from pathtrace_tpu_torch import RenderConfig
from pathtrace_tpu_torch import grad as port_grad
from pathtrace_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from pathtrace_tpu_torch.ops.sampling import clip01

JAX_CFG = JaxConfig(width=32, height=32, spp=4, backend="jnp", seed=5)
CFG = RenderConfig(width=32, height=32, spp=4, backend="torch", seed=5)
SCENE_FIELDS = ("radius", "position", "emission", "color")
CAMERA_FIELDS = ("position", "yaw", "pitch")


@pytest.fixture(scope="module")
def state():
    jscene, jcam = jax_cornell_box(), JaxCamera.create()
    scene = scene_from_numpy(*(np.asarray(getattr(jscene, f)) for f in SCENE_FIELDS))
    cam = camera_from_numpy(*(np.asarray(getattr(jcam, f)) for f in CAMERA_FIELDS))
    target = np.random.default_rng(0).uniform(size=(32, 32, 3)).astype(np.float32)
    return jscene, jcam, scene, cam, target


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x, np.float64)


def assert_block_close(got, want, rtol, atol_share):
    """Each pair of a block within rtol plus atol_share of the block's largest
    |want| entry."""
    scale = max(float(np.abs(_np(w)).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=rtol, atol=atol_share * max(scale, 1e-12))


@pytest.mark.parametrize("x", [0.0, 0.5, 1.0, 2.0])
def test_clip01_subgradient_matches_jnp_clip(x):
    """jnp.clip splits a tie at the boundary (1/2); torch.clamp does not."""
    t = torch.tensor(x, requires_grad=True)
    clip01(t).backward()
    assert float(t.grad) == float(jax.grad(lambda v: jnp.clip(v, 0.0, 1.0))(jnp.float32(x)))
    assert float(clip01(torch.tensor(x))) == float(np.clip(x, 0.0, 1.0))


def test_loss_grads_match_jax(state):
    """Diffuse: every wall has emission 0, so every bounce-0 wall hit sits on
    the emission clamp's boundary, where the subgradient must be 1/2."""
    jscene, jcam, scene, cam, target = state
    loss_j, (ds_j, dc_j) = jax_grad.render_loss_grads(jscene, jcam, JAX_CFG, 0,
                                                      jnp.asarray(target))
    loss, (ds, dc) = port_grad.render_loss_grads(scene, cam, CFG, 0, torch.from_numpy(target),
                                                 device="cpu")
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-4)
    for field in ("emission", "color"):
        want = _np(getattr(ds_j, field))
        np.testing.assert_allclose(_np(getattr(ds, field)), want, rtol=2e-2,
                                   atol=2e-3 * np.abs(want).max())
    for x in (ds.position, ds.radius, dc.position, dc.yaw, dc.pitch):
        assert not x.any()


def test_geometry_grads_match_jax(state):
    jscene, jcam, scene, cam, _ = state
    value_j, (ds_j, dc_j) = jax_grad.render_geometry_grads(jscene, jcam, JAX_CFG, 0)
    value, (ds, dc) = port_grad.render_geometry_grads(scene, cam, CFG, 0, device="cpu")
    np.testing.assert_allclose(float(value), float(value_j), rtol=1e-4)
    assert_block_close([ds.position, ds.radius], [ds_j.position, ds_j.radius], 1e-3, 1e-4)
    assert_block_close([getattr(dc, f) for f in CAMERA_FIELDS],
                       [getattr(dc_j, f) for f in CAMERA_FIELDS], 1e-3, 1e-4)
    assert float(np.abs(_np(ds.position)).sum()) > 0 and float(np.abs(_np(dc.pitch))) > 0


def test_nee_scalar_grads_match_jax(state):
    """With NEE the colour depends on geometry through the Lambert term."""
    jscene, jcam, scene, cam, _ = state
    value_j, (ds_j, dc_j) = jax_grad.render_scalar_grads(
        jscene, jcam, dataclasses.replace(JAX_CFG, nee=True), 0)
    value, (ds, dc) = port_grad.render_scalar_grads(scene, cam,
                                                    dataclasses.replace(CFG, nee=True), 0,
                                                    device="cpu")
    np.testing.assert_allclose(float(value), float(value_j), rtol=1e-4)
    for field in ("emission", "color"):
        want = _np(getattr(ds_j, field))
        np.testing.assert_allclose(_np(getattr(ds, field)), want, rtol=2e-2,
                                   atol=2e-3 * np.abs(want).max())
    assert_block_close([ds.position, ds.radius], [ds_j.position, ds_j.radius], 2e-2, 2e-2)
    assert_block_close([getattr(dc, f) for f in CAMERA_FIELDS],
                       [getattr(dc_j, f) for f in CAMERA_FIELDS], 2e-2, 2e-2)
    assert float(np.abs(_np(ds.position)).sum()) > 0


def test_finite_difference_and_grad_config():
    """The port's finite_difference is central differences; grad_config
    picks the torch backend with checkpointed chunks of <= 8 samples."""
    fd = port_grad.finite_difference(lambda v: float(np.sum(v.astype(np.float64) ** 2)),
                                     np.array([1.0, -2.0]), eps=1e-3)
    np.testing.assert_allclose(fd, [2.0, -4.0], rtol=1e-4)  # f sees float32 inputs
    cfg = port_grad.grad_config(dataclasses.replace(CFG, spp=32, backend="auto"))
    assert cfg.backend == "torch" and cfg.spp_chunk == 8


def test_checkpointed_chunks_match_one_chunk(state):
    """Chunked, checkpointed autograd gives the gradients of one chunk."""
    _, _, scene, cam, _ = state
    _, (g1, _) = port_grad.render_scalar_grads(scene, cam, CFG, device="cpu")
    _, (g2, _) = port_grad.render_scalar_grads(scene, cam, dataclasses.replace(CFG, spp_chunk=2),
                                               device="cpu")
    np.testing.assert_allclose(_np(g2.color), _np(g1.color), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(_np(g2.emission), _np(g1.emission), rtol=1e-4, atol=1e-7)
