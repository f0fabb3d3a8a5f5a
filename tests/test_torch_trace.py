"""The ``"torch"`` backend (the wavefront of ops/trace.py) against the JAX
package's ``"jnp"`` backend, on the same random lattice, plus the ops it is
built from. Tolerances as in tests/test_torch_trace_kernel.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtrace_tpu import Camera as JaxCamera
from pathtrace_tpu import RenderConfig as JaxConfig
from pathtrace_tpu import cornell_box as jax_cornell_box
from pathtrace_tpu.ops import intersect as jintersect
from pathtrace_tpu.ops import sampling as jsampling
from pathtrace_tpu.ops import variance as jvariance
from pathtrace_tpu.render import pack_channels as jax_pack_channels
from pathtrace_tpu.render import render_aovs as jax_render_aovs

from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box
from pathtrace_tpu_torch.ops import intersect, sampling, variance
from pathtrace_tpu_torch.ops.trace import trace_paths
from pathtrace_tpu_torch.scene import Scene
from pathtrace_tpu_torch.render import (
    accumulate_frame,
    pack_channels,
    render_aovs,
    render_channels,
    unpack_channels,
)
from test_torch_trace_kernel import CONFIGS, assert_channels_close


@pytest.mark.parametrize("config", list(CONFIGS))
def test_torch_backend_matches_jnp(config):
    jcfg = JaxConfig(width=128, height=16, spp=2, backend="jnp", **CONFIGS[config])
    ref = np.asarray(jax_pack_channels(
        jax_render_aovs(jax_cornell_box(), JaxCamera.create(), jcfg, frame=1)))
    cfg = RenderConfig(width=128, height=16, spp=2, backend="torch", **CONFIGS[config])
    got = render_channels(cornell_box(), Camera.create(), cfg, frame=1, device="cpu")
    assert got.shape == (16, 128, 14) and got.dtype == torch.float32
    assert_channels_close(got.numpy(), ref)


def test_spp_chunks_match_unchunked():
    scene, cam = cornell_box(), Camera.create()
    cfg = RenderConfig(width=32, height=8, spp=6, backend="torch", max_bounces=3)
    whole = render_channels(scene, cam, cfg, device="cpu").numpy()
    for chunk in (2, 4):
        parts = render_channels(scene, cam, dataclasses.replace(cfg, spp_chunk=chunk),
                                device="cpu").numpy()
        np.testing.assert_allclose(parts[..., :10], whole[..., :10], rtol=1e-5, atol=1e-5)
        # Variances to 1e-5 of each channel's scale: depth is ~1e4, so its
        # moments carry f32 rounding of that size whichever way they merge.
        for k in range(10, 14):
            scale = max(1.0, float(np.abs(whole[..., k]).max()))
            np.testing.assert_allclose(parts[..., k], whole[..., k], rtol=0, atol=1e-5 * scale)


def test_accumulate_frame_slab_is_a_slice():
    scene, cam = cornell_box(), Camera.create()
    cfg = RenderConfig(width=16, height=16, spp=2, backend="torch")
    s_full, m_full = accumulate_frame(scene, cam, cfg, 0)
    s_slab, m_slab = accumulate_frame(scene, cam, cfg, 0, row_offset=8, local_h=8)
    np.testing.assert_array_equal(s_slab["albedo"].numpy(), s_full["albedo"][8:].numpy())
    np.testing.assert_allclose(s_slab["color"].numpy(), s_full["color"][8:].numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(m_slab["depth"].n.numpy(), m_full["depth"].n[8:].numpy())


def test_pack_unpack_roundtrip_and_auto_backend():
    cfg = RenderConfig(width=8, height=4, spp=1)
    aovs = render_aovs(cornell_box(), Camera.create(), cfg, device="cpu")
    buf = pack_channels(aovs)
    assert buf.shape == (4, 8, 14)
    for k, v in unpack_channels(buf).items():
        np.testing.assert_array_equal(v.numpy(), aovs[k].numpy())
    with pytest.raises(ValueError):
        RenderConfig(backend="pallas")


def _rays(n=64, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform([5, 5, 20], [95, 75, 250], (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    return o, d


def test_intersect_ops_match_jax():
    jsc, sc = jax_cornell_box(), cornell_box()
    o, d = _rays()
    jt, jv = jintersect.intersect_spheres(jnp.asarray(o), jnp.asarray(d), jsc.radius, jsc.position)
    t, v = intersect.intersect_spheres(torch.from_numpy(o), torch.from_numpy(d), sc.radius,
                                       sc.position)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    # Inside a r=1e5 wall sphere t is a difference of two ~1e5 numbers, so
    # its rounding error is absolute: about one ulp of 1e5 (7.8e-3).
    np.testing.assert_allclose(t.numpy()[v.numpy()], np.asarray(jt)[np.asarray(jv)],
                               rtol=5e-4, atol=2e-2)
    jh = jintersect.intersect_scene(jnp.asarray(o), jnp.asarray(d), jsc)
    h = intersect.intersect_scene(torch.from_numpy(o), torch.from_numpy(d), sc)
    np.testing.assert_array_equal(h.hit.numpy(), np.asarray(jh.hit))
    np.testing.assert_array_equal(h.index.numpy(), np.asarray(jh.index))
    js = jintersect.intersect_scene_select(jnp.asarray(o), jnp.asarray(d), jsc)
    s = intersect.intersect_scene_select(torch.from_numpy(o), torch.from_numpy(d), sc)
    np.testing.assert_array_equal(s.color.numpy(), np.asarray(js.color))
    np.testing.assert_allclose(s.t.numpy(), np.asarray(js.t), rtol=5e-4, atol=2e-2)
    jvis = jintersect.shadow_visibility(jnp.asarray(o), jnp.asarray(d), jsc, 8)
    vis = intersect.shadow_visibility(torch.from_numpy(o), torch.from_numpy(d), sc, 8)
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))


def test_sampling_ops_match_jax():
    rng = np.random.default_rng(3)
    n = rng.standard_normal((64, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    u = rng.uniform(0, 1, (5, 64)).astype(np.float32)
    ju = [jnp.asarray(x) for x in u]
    tu = [torch.from_numpy(x) for x in u]
    np.testing.assert_array_equal(sampling.ortho_vector(torch.from_numpy(n)).numpy(),
                                  np.asarray(jsampling.ortho_vector(jnp.asarray(n))))
    np.testing.assert_allclose(
        sampling.cosine_weighted_direction(torch.from_numpy(n), tu[0], tu[1]).numpy(),
        np.asarray(jsampling.cosine_weighted_direction(jnp.asarray(n), ju[0], ju[1])),
        atol=2e-6)
    np.testing.assert_allclose(
        sampling.glossy_direction(torch.from_numpy(n), *tu).numpy(),
        np.asarray(jsampling.glossy_direction(jnp.asarray(n), *ju)), atol=2e-6)
    o, _ = _rays(seed=4)
    o[:, 1] = 1.0  # points just above the floor, lit from above
    up = np.tile(np.float32([0, 1, 0]), (64, 1))
    ref = jsampling.direct_lighting(jax_cornell_box(), jnp.asarray(up), jnp.asarray(o), 8, 0.05)
    got = sampling.direct_lighting(cornell_box(), torch.from_numpy(up), torch.from_numpy(o), 8,
                                   0.05)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_variance_ops_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 4, 3)).astype(np.float32)
    inc = rng.uniform(size=(6, 4, 3)) > 0.3
    np.testing.assert_allclose(variance.luminance(torch.from_numpy(x)).numpy(),
                               np.asarray(jvariance.luminance(jnp.asarray(x))), rtol=1e-6)
    a = variance.moments_from_samples(torch.from_numpy(x[:3]), torch.from_numpy(inc[:3]))
    b = variance.moments_from_samples(torch.from_numpy(x[3:]), torch.from_numpy(inc[3:]))
    ja = jvariance.moments_from_samples(jnp.asarray(x[:3]), jnp.asarray(inc[:3]))
    jb = jvariance.moments_from_samples(jnp.asarray(x[3:]), jnp.asarray(inc[3:]))
    merged, jmerged = variance.merge_moments(a, b), jvariance.merge_moments(ja, jb)
    whole = variance.moments_from_samples(torch.from_numpy(x), torch.from_numpy(inc))
    for got, ref in zip(merged, jmerged):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(variance.variance(merged).numpy(),
                               variance.variance(whole).numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(variance.variance(whole).numpy(),
                               np.asarray(jvariance.variance(
                                   jvariance.moments_from_samples(jnp.asarray(x), jnp.asarray(inc)))),
                               rtol=1e-5, atol=1e-6)
    # zeros_moments: the identity of the merge, as the JAX package's.
    zero, jzero = variance.zeros_moments((4, 3)), jvariance.zeros_moments((4, 3))
    for got, ref in zip(zero, jzero):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for got, ref in zip(variance.merge_moments(zero, whole), whole):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6, atol=1e-7)


ORACLE_BOUNCES = 5


def _oracle_cases():
    """tests/test_trace.py's rays: 48 into the box from the default eye with
    spread, one from inside the box straight at the light (the first-bounce
    emission clamp), and two in a one-sphere scene (an escape and a hit)."""
    rng = np.random.default_rng(11)
    dirs = rng.normal([0, 0, -1.0], 0.35, size=(48, 3)).astype(np.float32)
    uniforms = rng.uniform(size=(48, 2 * ORACLE_BOUNCES)).astype(np.float32)
    box = cornell_box()
    eye = np.float32([50.0, 52.0, 295.6])
    inside = np.float32([50.0, 52.0, 81.6])
    tiny = Scene([1.0], [(0.0, 0.0, -5.0)], [[0.1, 0.1, 0.1]], [[0.5, 0.5, 0.5]])
    return {
        "interior": (box, np.tile(eye, (48, 1)), dirs, uniforms),
        "light": (box, inside[None], (box.position[8].numpy() - inside)[None],
                  np.full((1, 2 * ORACLE_BOUNCES), 0.5, np.float32)),
        "escape": (tiny, np.zeros((2, 3), np.float32),
                   np.float32([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]]),
                   np.full((2, 2 * ORACLE_BOUNCES), 0.5, np.float32)),
    }


@pytest.mark.parametrize("case", ["interior", "light", "escape"])
def test_wavefront_matches_scalar_oracle(case):
    """The port's wavefront against tests/oracle.py's scalar tracer on the
    same uniforms, at tests/test_trace.py's tolerances; the include masks
    and bounce-0 hits exactly."""
    from oracle import trace_path as oracle_trace

    scene, origins, dirs, uniforms = _oracle_cases()[case]
    res = trace_paths(scene, torch.from_numpy(origins), torch.from_numpy(dirs),
                      torch.from_numpy(uniforms), max_bounces=ORACLE_BOUNCES)
    for i in range(len(dirs)):
        o = oracle_trace(scene, origins[i], dirs[i], uniforms[i], ORACLE_BOUNCES)
        np.testing.assert_allclose(res.color[i].numpy(), o["color"], rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(res.normal[i].numpy(), o["normal"], rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(res.albedo[i].numpy(), o["albedo"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(res.depth[i]), o["depth"], rtol=1e-3, atol=1e-3)
        assert bool(res.hit0[i]) == o["hit0"]
        assert bool(res.include_color[i]) == o["include_color"]
    if case == "light":  # the clamp: (4, 3.6, 3.2) -> (1, 1, 1)
        np.testing.assert_allclose(res.color[0].numpy(), [1.0, 1.0, 1.0], atol=1e-5)
    if case == "escape":
        assert res.hit0.tolist() == [False, True] and not bool(res.include_color[0])
