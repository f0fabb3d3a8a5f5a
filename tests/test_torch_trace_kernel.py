"""The trace kernel's plain PyTorch version against the Pallas kernel.

Both draw the same (seed, frame, sample, slot, row, col) lattice, so values
are compared directly. The JAX side runs ``pallas_trace`` in interpret mode
on the CPU; each such call takes seconds, so a module fixture makes five of
them and the nine (config x output mode) cases share them. The tolerances
follow tests/test_pallas.py: albedo bit-equal, normal within 2e-6, depth
within rtol 5e-4 (rsqrt rounding differs between the two libraries and the
wall spheres amplify it), and at most 1% of pixels off by more than 1e-3
in colour and in the variance statistics (borderline hit decisions flip).
The 2e-6 on normals comes from un-jittered single-sample frames; with
jitter a sample can graze a ball, where the normal amplifies the depth
rounding, so at most 1% of pixels may exceed it, and none 1e-4.

The kernel against the plain version on the card is in
tests/test_torch_kernel_cuda.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pathtrace_tpu import Camera as JaxCamera
from pathtrace_tpu import RenderConfig as JaxConfig
from pathtrace_tpu import cornell_box as jax_cornell_box
from pathtrace_tpu.ops import pallas_trace
from pathtrace_tpu.render import finalize_aovs, pack_channels

from pathtrace_tpu_torch import RenderConfig
from pathtrace_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from pathtrace_tpu_torch.ops import trace_kernel as tk
from pathtrace_tpu_torch.ops.variance import merge_moments, variance

WIDTH, HEIGHT, SPP = 128, 16, 2
ROW_OFFSET, LOCAL_H, SAMPLE_OFFSET = 8, 8, 3
CONFIGS = {
    "diffuse": {},
    "nee": {"nee": True},
    "glossy": {"brdf": "glossy"},
}
COLOR_ATOL = 1e-3
MAX_FLIP_SHARE = 0.01


def flip_share(got, ref, scale=1.0):
    """Share of pixels whose largest |difference| over the last axis exceeds
    1e-3 * max(1, scale)."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    if d.ndim == 3:
        d = d.max(axis=-1)
    return float((d > COLOR_ATOL * max(1.0, scale)).mean())


def assert_normals_close(got, ref, atol=2e-6):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64)).max(axis=-1)
    assert d.max() <= 1e-4, f"normal off by {d.max():.3g}"
    assert (d > atol).mean() <= MAX_FLIP_SHARE, f"{(d > atol).mean():.4f} of normals off"


def assert_stat_close(got, ref, name):
    share = flip_share(got, ref, float(np.abs(ref).max()))
    assert share <= MAX_FLIP_SHARE, f"{name}: {share:.4f} of pixels differ"


def assert_channels_close(got, ref):
    """[H, W, 14] buffers under the stated tolerances."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got[..., 6:9], ref[..., 6:9])
    assert_normals_close(got[..., 3:6], ref[..., 3:6])
    np.testing.assert_allclose(got[..., 9], ref[..., 9], rtol=5e-4)
    assert flip_share(got[..., 0:3], ref[..., 0:3]) <= MAX_FLIP_SHARE
    for k in range(10, 14):
        assert_stat_close(got[..., k], ref[..., k], f"channel {k}")


def assert_partials_close(got, ref, spp):
    """[h, W, 22] partials: 10 raw sums + (n, mean, M2) x 4."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got[..., 6:9], ref[..., 6:9])
    assert_normals_close(got[..., 3:6] / spp, ref[..., 3:6] / spp)
    np.testing.assert_allclose(got[..., 9], ref[..., 9], rtol=5e-4)
    assert flip_share(got[..., 0:3], ref[..., 0:3]) <= MAX_FLIP_SHARE
    for k in (13, 16, 19):  # bounce-0 counts do not depend on any draw
        np.testing.assert_array_equal(got[..., k], ref[..., k])
    for k in range(10, 22):
        assert_stat_close(got[..., k], ref[..., k], f"partial {k}")


def jax_partials_block(sums, moments):
    """The JAX package's (sums, moments) -> [h, W, 22] numpy."""
    chans = [np.asarray(sums["color"]), np.asarray(sums["normal"]),
             np.asarray(sums["albedo"]), np.asarray(sums["depth"])[..., None]]
    for k in ("color", "normal", "albedo", "depth"):
        m = moments[k]
        chans += [np.asarray(m.n)[..., None], np.asarray(m.mean)[..., None],
                  np.asarray(m.m2)[..., None]]
    return np.concatenate(chans, axis=-1)


@pytest.fixture(scope="module")
def state():
    """The JAX scene and camera, and the port's copies of them."""
    jscene, jcam = jax_cornell_box(), JaxCamera.create()
    scene = scene_from_numpy(*(np.asarray(getattr(jscene, f))
                               for f in ("radius", "position", "emission", "color")))
    cam = camera_from_numpy(np.asarray(jcam.position), np.asarray(jcam.yaw),
                            np.asarray(jcam.pitch))
    return jscene, jcam, scene, cam


@pytest.fixture(scope="module")
def pallas_refs(state):
    """Five interpret-mode Pallas calls, numpy results by (config, mode)."""
    jscene, jcam, _, _ = state
    refs = {}
    cfg = JaxConfig(width=WIDTH, height=LOCAL_H, spp=SPP)
    refs["diffuse", "channels_frame"] = np.asarray(
        pallas_trace.render_channels_pallas(jscene, jcam, cfg, 0, interpret=True))
    for name, extra in CONFIGS.items():
        cfg = JaxConfig(width=WIDTH, height=HEIGHT, spp=SPP, **extra)
        sums, moments = pallas_trace.accumulate_frame_pallas(
            jscene, jcam, cfg, 0, row_offset=ROW_OFFSET, local_h=LOCAL_H, spp=SPP,
            sample_offset=SAMPLE_OFFSET, interpret=True)
        refs[name, "partials"] = jax_partials_block(sums, moments)
        refs[name, "channels"] = np.asarray(
            pack_channels(finalize_aovs(sums, moments, SPP)))
        refs[name, "color"] = refs[name, "partials"][..., 0:3]
    cfg = JaxConfig(width=WIDTH, height=HEIGHT, spp=SPP)
    refs["diffuse", "color"] = np.asarray(pallas_trace.render_color_sums_pallas(
        jscene, jcam, cfg, 0, row_offset=ROW_OFFSET, local_h=LOCAL_H, spp=SPP,
        sample_offset=SAMPLE_OFFSET, interpret=True))
    return refs


def _slab(scene, cam, cfg, mode, device="cpu"):
    """The wrapper on a slab at the row and sample offsets."""
    return tk.trace(scene.packed().to(device), tk.camera_block(cam.to(device), cfg),
                    tk.make_seed_block(cfg, 0, SAMPLE_OFFSET, ROW_OFFSET), cfg,
                    local_h=LOCAL_H, spp=SPP, mode=mode)


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("mode", ["channels", "partials", "color"])
def test_plain_matches_pallas(state, pallas_refs, config, mode):
    _, _, scene, cam = state
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=SPP, **CONFIGS[config])
    got = _slab(scene, cam, cfg, mode).numpy()
    ref = pallas_refs[config, mode]
    assert got.shape == (LOCAL_H, WIDTH, tk.MODES[mode])
    if mode == "channels":
        assert_channels_close(got, ref)
    elif mode == "partials":
        assert_partials_close(got, ref, SPP)
    else:
        assert flip_share(got, ref) <= MAX_FLIP_SHARE


def test_full_frame_entry_points_match_pallas(state, pallas_refs):
    """render_channels / render_aovs / render_partials / render_color_sums
    on a whole 128x8 frame."""
    _, _, scene, cam = state
    cfg = RenderConfig(width=WIDTH, height=LOCAL_H, spp=SPP)
    ref = pallas_refs["diffuse", "channels_frame"]
    buf = tk.render_channels(scene, cam, cfg)
    assert_channels_close(buf.numpy(), ref)
    aovs = tk.render_aovs(scene, cam, cfg)
    np.testing.assert_array_equal(aovs["albedo"].numpy(), ref[..., 6:9])
    sums, moments = tk.render_partials(scene, cam, cfg)
    np.testing.assert_array_equal((sums["color"] / SPP).numpy(), buf[..., 0:3].numpy())
    np.testing.assert_array_equal(variance(moments["depth"]).numpy(), buf[..., 13].numpy())
    color = tk.render_color_sums(scene, cam, cfg, 0)
    np.testing.assert_array_equal(color.numpy(), sums["color"].numpy())


def test_slab_is_a_slice_of_the_frame(state):
    """Row and sample offsets address the global lattice: a slab equals its
    rows of the full frame, and two sample ranges merge into one."""
    _, _, scene, cam = state
    cfg = RenderConfig(width=32, height=16, spp=4, max_bounces=3)
    s_full, m_full = tk.accumulate_frame_kernel(scene, cam, cfg, 0)
    s_slab, m_slab = tk.accumulate_frame_kernel(scene, cam, cfg, 0, row_offset=8, local_h=8)
    np.testing.assert_array_equal(s_slab["color"].numpy(), s_full["color"][8:].numpy())
    np.testing.assert_array_equal(m_slab["depth"].m2.numpy(), m_full["depth"].m2[8:].numpy())
    s_a, m_a = tk.accumulate_frame_kernel(scene, cam, cfg, 0, spp=2)
    s_b, m_b = tk.accumulate_frame_kernel(scene, cam, cfg, 0, spp=2, sample_offset=2)
    np.testing.assert_allclose((s_a["color"] + s_b["color"]).numpy(),
                               s_full["color"].numpy(), rtol=1e-5, atol=1e-5)
    merged = merge_moments(m_a["color"], m_b["color"])
    np.testing.assert_allclose(merged.m2.numpy(), m_full["color"].m2.numpy(),
                               rtol=1e-4, atol=1e-5)


def _check_name(mode, k):
    """The name of the ``agreement`` check that covers channel ``k``."""
    groups = ("colour",) * 3 + ("normal",) * 3 + ("albedo",) * 3 + ("depth",)
    return groups[k] if k < 10 else tk.STAT_CHANNELS[mode][k - 10]


@pytest.mark.parametrize("mode", list(tk.MODES))
def test_agreement_sees_an_error_in_any_channel(state, mode):
    """The comparison the card runs (chip_smoke.py, test_torch_kernel_cuda.py)
    flags a wrong value in any one channel, and only that channel's check."""
    _, _, scene, cam = state
    cfg = RenderConfig(width=32, height=16, spp=2, nee=True)
    ref = tk.trace(scene.packed(), tk.camera_block(cam, cfg), tk.make_seed_block(cfg, 0, 1, 4),
                   cfg, local_h=16, spp=2, mode=mode)
    checks, err = tk.agreement(ref.clone(), ref, mode, 2)
    assert err == 0.0 and all(ok for *_, ok in checks)
    assert len(checks) == 2 + (0 if mode == "color" else 3 + len(tk.STAT_CHANNELS[mode]))
    for k in range(ref.shape[-1]):
        bad = ref.clone()
        bad[::4, ::4, k] += 1.0 + ref[..., k].abs().max()  # 1 pixel in 16
        checks, err = tk.agreement(bad, ref, mode, 2)
        assert {name for name, *_, ok in checks if not ok} == {_check_name(mode, k)}
        assert err >= 1.0
    bad = ref.clone()
    bad[0, 0, 0] = float("nan")
    checks, _ = tk.agreement(bad, ref, mode, 2)
    assert {name for name, *_, ok in checks if not ok} == {"finite"}


@pytest.mark.parametrize("bad", [
    "dtype", "columns", "spheres", "camera", "contiguous", "mode", "seed", "light", "block",
    "device",
])
def test_wrapper_rejects_bad_input(state, bad):
    _, _, scene, cam = state
    cfg = RenderConfig(width=8, height=8, spp=1)
    sb, cb = scene.packed(), tk.camera_block(cam, cfg)
    seed = tk.make_seed_block(cfg)
    kw = dict(local_h=8, spp=1, mode="channels")
    if bad == "dtype":
        sb = sb.double()
    elif bad == "columns":
        sb = sb[:, :9].contiguous()
    elif bad == "spheres":
        sb = sb.repeat(2, 1)
    elif bad == "camera":
        cb = cb[:4]
    elif bad == "contiguous":
        sb = torch.cat([sb, sb], dim=1)[:, ::2]
    elif bad == "mode":
        kw["mode"] = "rgb"
    elif bad == "seed":
        seed = seed[:4]
    elif bad == "light":
        cfg = dataclasses.replace(cfg, nee=True, light_index=9)
    elif bad == "block":
        cfg = dataclasses.replace(cfg, block=tk.MAX_BLOCK + 1)
    elif bad == "device":
        kw["device"] = "meta"
    with pytest.raises(ValueError):
        tk.trace(sb, cb, seed, cfg, **kw)
