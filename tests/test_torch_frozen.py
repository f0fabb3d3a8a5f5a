"""The port's frozen-decision record/replay (ops/frozen.py) against the JAX
package's, on the CPU: Cornell 32x32 x 4 spp, seed 5, chunks of 2 spp, for
diffuse, NEE and glossy (tests/test_frozen.py's lattice).

Chain of trust, as in the JAX tests:
1. record mode is the port's renderer: the colour of ``record_frame``
   equals ``render.accumulate_frame``'s (``ops/trace.py::trace_paths``) to
   the bit, and the f32 replay at the record point reproduces it (1e-6);
2. the record is JAX's: the decisions agree on >= 99.5% of the (sample,
   pixel, bounce) lanes (measured: 99.946% diffuse and NEE, 99.990%
   glossy; the rest are borderline lanes of two f32 codes), and with JAX's
   decisions carried across (``convert.decisions_from_jax``) the port's f64
   loss and gradients equal JAX's f64 ones within 1e-9 of each block's
   largest magnitude (measured: 0; both run the chain in f64 and round the
   gradient once to the f32 of the given scene);
3. the capture is complete: the f32 frozen gradient equals the port's
   torch-autograd estimator (2e-4 of scale), and the per-pixel forward
   derivative (``torch.func.jvp``) of the f64 replay equals its central FD.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtrace_tpu import Camera as JaxCamera
from pathtrace_tpu import RenderConfig as JaxRenderConfig
from pathtrace_tpu import cornell_box as jax_cornell_box
from pathtrace_tpu.ops import frozen as jax_frozen
from pathtrace_tpu.ops import sampling as jax_sampling

from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box, grad
from pathtrace_tpu_torch.convert import decisions_from_jax
from pathtrace_tpu_torch.ops import frozen, sampling
from pathtrace_tpu_torch.render import accumulate_frame

CASES = {"diffuse": {}, "nee": {"nee": True}, "glossy": {"brdf": "glossy"}}
SIZE = 32


def port_cfg(case):
    return RenderConfig(width=SIZE, height=SIZE, spp=4, backend="torch", seed=5, spp_chunk=2,
                        **CASES[case])


def jax_cfg(case):
    return dataclasses.replace(
        JaxRenderConfig(width=SIZE, height=SIZE, spp=4, backend="jnp", seed=5, spp_chunk=2),
        **CASES[case])


@pytest.fixture(scope="module")
def port_records():
    scene, cam = cornell_box(), Camera.create()
    return {case: frozen.record_frame(scene, cam, port_cfg(case), device="cpu")
            for case in CASES}


@pytest.fixture(scope="module")
def jax_records():
    scene, cam = jax_cornell_box(), JaxCamera.create()
    return {case: jax_frozen.record_frame(scene, cam, jax_cfg(case)) for case in CASES}


def blocks(d_scene, d_cam):
    return {"radius": d_scene.radius, "position": d_scene.position,
            "emission": d_scene.emission, "albedo": d_scene.color,
            "cam_position": d_cam.position, "yaw": d_cam.yaw, "pitch": d_cam.pitch}


@pytest.mark.parametrize("case", CASES)
def test_record_is_the_renderer_bitwise(port_records, case):
    cfg = port_cfg(case)
    sums, _ = accumulate_frame(cornell_box(), Camera.create(), cfg, 0)
    color, recs = port_records[case]
    assert len(recs) == 2 and recs[0].idx.shape == (2, SIZE, SIZE, cfg.max_bounces)
    assert torch.equal(color, sums["color"] / cfg.spp)


@pytest.mark.parametrize("case", CASES)
def test_replay_reproduces_the_forward(port_records, case):
    cam = Camera.create()
    color, recs = port_records[case]
    rep = frozen.replay_color(cornell_box(), cam.position, cam.eye_ray_basis(SIZE, SIZE),
                              port_cfg(case), 0, recs, device="cpu")
    np.testing.assert_allclose(rep.numpy(), color.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", CASES)
def test_decisions_match_jax(port_records, jax_records, case):
    same = total = 0
    for jax_dec, dec in zip(jax_records[case][1], port_records[case][1]):
        theirs = decisions_from_jax(jax_dec)
        agree = torch.ones(dec.idx.shape, dtype=torch.bool)
        for a, b in zip(theirs, dec):
            agree &= a == b.to(a.dtype)
        same += int(agree.sum())
        total += agree.numel()
    assert same / total >= 0.995, same / total


@pytest.mark.parametrize("case", CASES)
def test_f64_replay_on_jax_decisions_matches_jax(jax_records, case):
    target = np.zeros((SIZE, SIZE, 3), np.float32)
    jax_recs = jax_records[case][1]
    with jax.enable_x64(True):
        loss_j, grads_j = jax_frozen.replay_loss_grads(
            jax_cornell_box(), JaxCamera.create(), jax_cfg(case), 0, jax_recs,
            jnp.asarray(target), dtype=jnp.float64)
        loss_j = float(loss_j)
        grads_j = {k: np.asarray(v, np.float64) for k, v in blocks(*grads_j).items()}
    loss, grads = frozen.replay_loss_grads(
        cornell_box(), Camera.create(), port_cfg(case), 0,
        [decisions_from_jax(d) for d in jax_recs], torch.from_numpy(target),
        dtype=torch.float64, device="cpu")
    assert loss.dtype == torch.float64
    assert abs(float(loss) - loss_j) <= 1e-9 * abs(loss_j)
    for name, g in blocks(*grads).items():
        want = grads_j[name]
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(g.double().numpy() - want).max() <= 1e-9 * scale, name


def test_frozen_grad_equals_the_torch_estimator(port_records):
    """The f32 frozen gradient is autograd's detached-decision estimator at
    the record point, for every parameter: the capture is complete."""
    cfg = port_cfg("nee")
    scene, cam = cornell_box(), Camera.create()
    target = torch.zeros((SIZE, SIZE, 3))
    loss_f, grads_f = frozen.replay_loss_grads(scene, cam, cfg, 0, port_records["nee"][1],
                                               target, device="cpu")
    loss_l, grads_l = grad.render_loss_grads(scene, cam, cfg, 0, target, device="cpu")
    np.testing.assert_allclose(float(loss_f), float(loss_l), rtol=1e-6)
    live = blocks(*grads_l)
    for name, a in blocks(*grads_f).items():
        a, b = a.double().numpy(), live[name].double().numpy()
        scale = max(np.abs(a).max(), np.abs(b).max(), 1e-12)
        assert np.abs(a - b).max() / scale < 2e-4, name


def _unit(shape, index):
    e = torch.zeros(shape, dtype=torch.float64)
    e[index] = 1.0
    return e


# (name, h -> (scene64, cam64) moved by h, eps): the oracle script's probes.
PROBES = {
    "radius": (lambda s, c, h: (s.replace(radius=s.radius + h * _unit(9, 6)), c), 2e-5),
    "position_z": (lambda s, c, h: (s.replace(position=s.position + h * _unit((9, 3), (6, 2))),
                                    c), 2e-4),
    "camera_z": (lambda s, c, h: (s, Camera(c.position + h * _unit(3, 2), c.yaw, c.pitch,
                                            dtype=torch.float64)), 2e-3),
    "yaw": (lambda s, c, h: (s, Camera(c.position, c.yaw + h, c.pitch, dtype=torch.float64)),
            5e-5),
}


@pytest.mark.parametrize("probe", PROBES)
def test_pixel_jvp_matches_central_fd(port_records, probe):
    """Per pixel, the f64 forward derivative of the replayed colour against
    its central FD: decisions cannot flip inside the bracket, so the two
    agree to the FD's truncation error. The gate's metric and bounds
    (scripts/torch_grad_gate.py): gross-normalised error and the p90 of the
    per-pixel error both below 2e-2 (measured here: <= 7.9e-5 and <= 1.4e-7)."""
    perturb, eps = PROBES[probe]
    scene64 = cornell_box().astype(torch.float64)
    cam64 = Camera.create().astype(torch.float64)
    J, D = frozen.pixel_jvp_fd(lambda h: perturb(scene64, cam64, h), port_cfg("nee"), 0,
                               port_records["nee"][1], eps, device="cpu")
    mag = np.abs(J) + np.abs(D)
    assert np.abs(J).max() > 0
    gross = np.abs(J - D).sum() / mag.sum()
    active = mag > 1e-3 * mag.max()
    p90 = np.quantile((np.abs(J - D) / np.maximum(mag, 1e-300))[active], 0.9)
    assert gross < 2e-2 and p90 < 2e-2, (gross, p90)


def _cosine_direction_before(normal, u1, u2):
    """``sampling.cosine_weighted_direction`` as it stood before ``ortho_cond``."""
    n = sampling._normalize(normal)
    cond = torch.abs(n[..., 0]) > torch.abs(n[..., 2])
    zero = torch.zeros_like(n[..., 0])
    a = torch.stack([-n[..., 1], n[..., 0], zero], dim=-1)
    b = torch.stack([zero, -n[..., 2], n[..., 1]], dim=-1)
    o1 = sampling._normalize(torch.where(cond[..., None], a, b))
    o2 = sampling._normalize(torch.linalg.cross(n, o1, dim=-1))
    phi = u1 * sampling.TWO_PI
    z = torch.sqrt(u2)
    sin_t = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    d = ((torch.cos(phi) * sin_t)[..., None] * o1 + (torch.sin(phi) * sin_t)[..., None] * o2
         + z[..., None] * n)
    return sampling._normalize(d)


def test_ortho_cond_none_is_the_sampler_and_a_cond_picks_its_branch():
    g = np.random.default_rng(0)
    normal = torch.from_numpy(g.normal(size=(257, 3)).astype(np.float32))
    u = [torch.from_numpy(g.uniform(size=257).astype(np.float32)) for _ in range(5)]
    d = sampling.cosine_weighted_direction(normal, u[0], u[1])
    assert torch.equal(d, _cosine_direction_before(normal, u[0], u[1]))
    n = sampling._normalize(normal)
    own = torch.abs(n[..., 0]) > torch.abs(n[..., 2])
    assert torch.equal(sampling.cosine_weighted_direction(normal, u[0], u[1], ortho_cond=own), d)
    assert torch.equal(sampling.glossy_direction(normal, *u, ortho_cond=own),
                       sampling.glossy_direction(normal, *u))
    flipped = sampling.cosine_weighted_direction(normal, u[0], u[1], ortho_cond=~own)
    assert not torch.equal(flipped, d)
    # the other branch is still a unit direction, and is JAX's under the same cond
    np.testing.assert_allclose(torch.linalg.norm(flipped, dim=-1).numpy(), 1.0, atol=1e-6)
    want = jax_sampling.cosine_weighted_direction(
        jnp.asarray(normal.numpy()), jnp.asarray(u[0].numpy()), jnp.asarray(u[1].numpy()),
        ortho_cond=jnp.asarray((~own).numpy()))
    np.testing.assert_allclose(flipped.numpy(), np.asarray(want), atol=2e-6)
    ortho = sampling.ortho_vector(n, cond=~own)
    np.testing.assert_allclose(torch.sum(ortho * n, dim=-1).numpy(), 0.0, atol=1e-6)


def test_f64_camera_basis_matches_jax():
    cam = Camera.create(position=(50.0, 52.0, 295.6), yaw=-87.5, pitch=3.25)
    cam64 = cam.astype(torch.float64)
    assert cam64.position.dtype == cam64.yaw.dtype == torch.float64
    assert cam64.to("cpu").position.dtype == torch.float64
    basis = cam64.eye_ray_basis(48, 32)
    with jax.enable_x64(True):
        jcam = JaxCamera.create(position=(50.0, 52.0, 295.6), yaw=-87.5, pitch=3.25)
        jcam = dataclasses.replace(jcam, position=jcam.position.astype(jnp.float64),
                                   yaw=jcam.yaw.astype(jnp.float64),
                                   pitch=jcam.pitch.astype(jnp.float64))
        want = np.asarray(jcam.eye_ray_basis(48, 32))
    assert basis.dtype == torch.float64 and want.dtype == np.float64
    np.testing.assert_allclose(basis.numpy(), want, rtol=0, atol=1e-12)
    # the f32 matrices of the rasteriser's view stay f32
    assert cam64.view_matrix().dtype == torch.float32
