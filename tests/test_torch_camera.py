"""The port's camera, scene and state conversion against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtrace_tpu import camera as jcamera
from pathtrace_tpu import config as jconfig
from pathtrace_tpu import render as jrender
from pathtrace_tpu import scene as jscene
from pathtrace_tpu_torch import camera, config, render, scene
from pathtrace_tpu_torch.convert import camera_from_numpy, scene_from_numpy

POSES = [
    ((50.0, 52.0, 295.6), -90.0, 0.0),
    ((10.0, 20.0, 30.0), -70.0, 5.0),
    ((73.5, 40.0, 170.25), -123.0, -31.5),
]


@pytest.mark.parametrize("pose", POSES)
@pytest.mark.parametrize("size", [(128, 128), (160, 96)])
def test_eye_ray_basis_matches_jax(pose, size):
    pos, yaw, pitch = pose
    ref = np.asarray(jcamera.Camera.create(pos, yaw, pitch).eye_ray_basis(*size))
    got = camera.Camera.create(pos, yaw, pitch).eye_ray_basis(*size)
    assert got.dtype == torch.float32 and got.shape == (4, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pose", POSES)
def test_basis_and_inverse_matrices_match_jax(pose):
    jc, tc = jcamera.Camera.create(*pose), camera.Camera.create(*pose)
    for a, b in zip(jc.basis_vectors(), tc.basis_vectors()):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tc.inverse_view_matrix().numpy(),
                               np.asarray(jc.inverse_view_matrix()), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(camera.Camera.inverse_projection_matrix(160, 96).numpy(),
                               np.asarray(jcamera.Camera.inverse_projection_matrix(160, 96)),
                               rtol=1e-6)


def _np_look_at(eye, center, up):
    """tests/test_camera.py's numpy lookAt."""
    f = center - eye
    f = f / np.linalg.norm(f)
    r = np.cross(f, up)
    r = r / np.linalg.norm(r)
    u = np.cross(r, f)
    m = np.eye(4)
    m[0, :3], m[1, :3], m[2, :3] = r, u, -f
    m[0, 3], m[1, 3], m[2, 3] = -r @ eye, -u @ eye, f @ eye
    return m


@pytest.mark.parametrize("pose", POSES + [((1.0, 2.0, 3.0), -35.0, 10.0)])
def test_view_and_projection_matrices_match_jax(pose):
    """glm's lookAt and perspective (tests/test_camera.py's cases): the same
    matrices as the JAX package, lookAt as the numpy oracle builds it, and
    their product inverts through the analytic inverses the basis uses."""
    jc, tc = jcamera.Camera.create(*pose), camera.Camera.create(*pose)
    view = tc.view_matrix()
    assert view.dtype == torch.float32 and view.shape == (4, 4)
    np.testing.assert_allclose(view.numpy(), np.asarray(jc.view_matrix()), rtol=1e-6, atol=1e-5)
    front, _, up = (v.numpy().astype(np.float64) for v in tc.basis_vectors())
    eye = np.asarray(pose[0], np.float64)
    np.testing.assert_allclose(view.numpy(), _np_look_at(eye, eye + front, up), atol=1e-4)
    for size in [(128, 128), (160, 96)]:
        proj = camera.Camera.projection_matrix(*size)
        np.testing.assert_allclose(proj.numpy(),
                                   np.asarray(jcamera.Camera.projection_matrix(*size)),
                                   rtol=1e-6)
        np.testing.assert_allclose((camera.Camera.inverse_projection_matrix(*size) @ proj)
                                   .numpy(), np.eye(4), atol=1e-6)
    # f32 translations of ~2e2 (an ulp 1.5e-5) cancel in the product
    np.testing.assert_allclose((tc.inverse_view_matrix() @ view).numpy(), np.eye(4),
                               atol=1e-4)


def test_unprojection_consistency():
    """tests/test_camera.py's case: the interpolated ray through a pixel
    passes through that pixel's NDC point unprojected by the inverse of
    projection_matrix @ view_matrix."""
    cam = camera.Camera.create(position=(10.0, 20.0, 30.0), yaw=-70.0, pitch=5.0)
    w = h = 128
    inv_vp = np.linalg.inv(camera.Camera.projection_matrix(w, h).numpy().astype(np.float64)
                           @ cam.view_matrix().numpy().astype(np.float64))
    basis = cam.eye_ray_basis(w, h)
    for r, c in [(0, 0), (64, 64), (13, 101)]:
        ndc_x, ndc_y = camera.pixel_ndc(torch.tensor(float(r)), torch.tensor(float(c)), w, h)
        d = camera.ray_directions(basis, ndc_x, ndc_y).numpy()
        p = inv_vp @ np.array([float(ndc_x), float(ndc_y), 0.0, 1.0])
        np.testing.assert_allclose(d, p[:3] / p[3] - cam.position.numpy(), rtol=2e-3, atol=2e-3)


def test_num_pixels_replace_and_frame_moments_match_jax():
    for w, h in [(64, 64), (160, 96)]:
        assert config.RenderConfig(width=w, height=h).num_pixels == \
            jconfig.RenderConfig(width=w, height=h).num_pixels == w * h
    ref, got = jscene.cornell_box(), scene.cornell_box()
    color = np.random.default_rng(2).uniform(size=(9, 3)).astype(np.float32)
    jnew, new = ref.replace(color=jnp.asarray(color)), got.replace(color=color)
    assert isinstance(new, scene.Scene) and new is not got
    for f in ("radius", "position", "emission", "color"):
        np.testing.assert_array_equal(getattr(new, f).numpy(), np.asarray(getattr(jnew, f)))
    np.testing.assert_array_equal(got.color.numpy(), np.asarray(ref.color))  # unchanged
    assert new.replace(radius=got.radius.double()).radius.dtype == torch.float64  # kept
    frame = render.FrameMoments(color=torch.zeros(2))
    assert isinstance(frame, dict) and issubclass(jrender.FrameMoments, dict)


def test_pixel_ndc_and_ray_directions_match_jax():
    rng = np.random.default_rng(1)
    rows = rng.uniform(-0.5, 95.5, (7, 5)).astype(np.float32)
    cols = rng.uniform(-0.5, 159.5, (7, 5)).astype(np.float32)
    jx, jy = jcamera.pixel_ndc(jnp.asarray(rows), jnp.asarray(cols), 160, 96)
    tx, ty = camera.pixel_ndc(torch.from_numpy(rows), torch.from_numpy(cols), 160, 96)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6, atol=1e-7)
    basis = jcamera.Camera.create(*POSES[1]).eye_ray_basis(160, 96)
    ref = np.asarray(jcamera.ray_directions(basis, jx, jy))
    got = camera.ray_directions(torch.from_numpy(np.array(basis)), tx, ty)
    assert got.shape == (7, 5, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_ray_direction_orientation():
    """Row 0 is the top of the image, col 0 the left."""
    basis = camera.Camera.create().eye_ray_basis(64, 64)
    rows = torch.tensor([[0.0, 0.0], [63.0, 63.0]])
    cols = torch.tensor([[0.0, 63.0], [0.0, 63.0]])
    d = camera.ray_directions(basis, *camera.pixel_ndc(rows, cols, 64, 64))
    assert d[0, 0, 1] > 0 and d[1, 0, 1] < 0
    assert d[0, 0, 0] < 0 and d[0, 1, 0] > 0


def test_move_look_zoom_and_pose_string_match_jax():
    jc, tc = jcamera.Camera.create(*POSES[2]), camera.Camera.create(*POSES[2])
    for direction in ("forward", "backward", "left", "right"):
        np.testing.assert_allclose(tc.move(direction, 0.1).position.numpy(),
                                   np.asarray(jc.move(direction, 0.1).position), rtol=1e-6)
    for dx, dy in [(4.0, 100.0), (-3.0, -2.5)]:
        jl, tl = jc.look(dx, dy), tc.look(dx, dy)
        assert float(tl.yaw) == pytest.approx(float(jl.yaw))
        assert float(tl.pitch) == pytest.approx(float(jl.pitch))
    assert float(camera.Camera.create().look(0.0, 100.0).pitch) == 89.0
    assert camera.Camera.scroll_zoom(45.0, 3.0) == jcamera.Camera.scroll_zoom(45.0, 3.0) == 42.0
    assert camera.Camera.scroll_zoom(2.0, 5.0) == 1.0
    assert tc.pose_string() == jc.pose_string()


def test_cornell_box_equal():
    ref, got = jscene.cornell_box(), scene.cornell_box()
    assert got.num_objects == 9
    for f in ("radius", "position", "emission", "color"):
        t = getattr(got, f)
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(ref, f)))
    assert got.packed().shape == (9, 10)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_convert_carries_perturbed_state(seed):
    rng = np.random.default_rng(seed)
    base = jscene.cornell_box()
    fields = {f: np.asarray(getattr(base, f)) for f in ("radius", "position", "emission", "color")}
    perturbed = {f: (v * (1.0 + 0.01 * rng.standard_normal(v.shape))).astype(np.float32)
                 for f, v in fields.items()}
    jsc = base.replace(**{f: jnp.asarray(v) for f, v in perturbed.items()})
    got = scene_from_numpy(*(np.asarray(getattr(jsc, f)) for f in perturbed))
    for f in perturbed:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(jsc, f)))
    pos = rng.uniform(0, 100, 3).astype(np.float32)
    yaw, pitch = np.float32(rng.uniform(-180, 0)), np.float32(rng.uniform(-30, 30))
    jc = jcamera.Camera.create(pos, yaw, pitch)
    tc = camera_from_numpy(np.asarray(jc.position), np.asarray(jc.yaw), np.asarray(jc.pitch))
    np.testing.assert_array_equal(tc.position.numpy(), np.asarray(jc.position))
    assert float(tc.yaw) == float(jc.yaw) and float(tc.pitch) == float(jc.pitch)
    np.testing.assert_allclose(tc.eye_ray_basis(64, 48).numpy(),
                               np.asarray(jc.eye_ray_basis(64, 48)), rtol=1e-6, atol=1e-6)


def test_convert_rejects_bad_shapes():
    with pytest.raises(ValueError):
        scene_from_numpy(np.ones(3), np.ones((3, 3)), np.ones((3, 3)), np.ones((2, 3)))
    with pytest.raises(ValueError):
        camera_from_numpy(np.ones(2), 0.0, 0.0)
