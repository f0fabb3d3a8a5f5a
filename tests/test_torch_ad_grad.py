"""The all-parameter backward kernel's plain PyTorch version against the JAX package.

K4's TPU kernel is ``jax.vjp`` of the trajectory inside a Pallas kernel; the
port's is that vjp derived by hand, and on the CPU its wrapper runs the
plain version, the kernel's formulas over [h, W] tensors. The reference is
jnp reverse-mode AD of the jnp backend on the same lattice, the estimator
tests/test_pallas_ad.py holds the TPU kernel to, and, in two cases, the
Pallas kernel itself in interpret mode.

Tolerances against JAX, at 128x16, 2 spp, 3 bounces, seed 3, from
tests/test_pallas_ad.py: loss rtol 1e-4; position and radius rtol 2e-3 plus
2e-3 of the largest; camera position 5e-3 of the largest; yaw and pitch
5e-2 of the largest camera-position entry. Emission and albedo: rtol 2e-3
plus 5e-4 of the largest where that test has 1e-5, as in
tests/test_torch_nee_grad.py: a pixel in a thousand takes another path in
one of the packages (a borderline hit decision rounds the other way).
Measured here, largest |difference| over the largest |JAX| entry of the
block: emission 5.2e-4 (diffuse), 1.9e-4 (glossy), 3.2e-4 (NEE), 4.1e-4
(NEE glossy); albedo 1.2e-7, 7.6e-8, 1.1e-4, 8.0e-4; position and radius
4.2e-4 (NEE), 1.7e-3 (NEE glossy); camera position 1.1e-4, 5.2e-4; yaw
4.6e-4, 1.5e-3 of the camera-position scale; loss 1.8e-7, 1.8e-7, 1.4e-5,
8.8e-5. NEE glossy sits at the edge of two of those tolerances (a grazing
glossy reflection amplifies one flipped pixel), so for it alone the loss is
held to rtol 5e-4 and position and radius to 5e-3 of the largest. The AOV
probes (depth x 1e-4 + normal-y; albedo sum) are held to the tolerances
above and measured 3e-7 (position), 3.9e-6 (camera position), 7.8e-5
(pitch) and 0 (albedo).

The kernel against the plain version on the card is in
tests/test_torch_ad_grad_cuda.py.
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
from pathtrace_tpu.grad import l2_image_loss, render_aovs_diff, render_color
from pathtrace_tpu.ops import pallas_ad

from pathtrace_tpu_torch import Camera, RenderConfig
from pathtrace_tpu_torch import grad as port_grad
from pathtrace_tpu_torch import inverse as port_inverse
from pathtrace_tpu_torch.convert import camera_from_numpy, grads_to_numpy, scene_from_numpy
from pathtrace_tpu_torch.ops import ad_grad_kernel as ak
from pathtrace_tpu_torch.ops import grad_kernel as gk
from pathtrace_tpu_torch.ops import nee_grad_kernel as nk
from pathtrace_tpu_torch.ops import trace_kernel as tk
from pathtrace_tpu_torch.scene import Scene

WIDTH, HEIGHT, SPP, BOUNCES, SEED = 128, 16, 2, 3, 3
BASE = dict(width=WIDTH, height=HEIGHT, spp=SPP, max_bounces=BOUNCES, seed=SEED)
CONFIGS = {"diffuse": {}, "nee": {"nee": True}, "glossy": {"brdf": "glossy"},
           "nee_glossy": {"nee": True, "brdf": "glossy"}}
SCENE_FIELDS = ("radius", "position", "emission", "color")
GEOMETRY = ("radius", "position", "cam_position", "yaw", "pitch")


def port_cfg(name, **kw):
    return RenderConfig(**{**BASE, "backend": "cuda", **CONFIGS[name], **kw})


def jax_cfg(name, **kw):
    return JaxConfig(**{**BASE, "backend": "jnp", **CONFIGS[name], **kw})


def jax_grads_to_numpy(d_scene, d_cam) -> dict:
    out = {k: np.asarray(getattr(d_scene, k)) for k in SCENE_FIELDS}
    out.update(cam_position=np.asarray(d_cam.position), yaw=np.asarray(d_cam.yaw),
               pitch=np.asarray(d_cam.pitch))
    return out


def assert_blocks_close(got: dict, want: dict, geometry_atol=2e-3, names=None):
    def close(name, rtol, atol_scale, scale=None):
        if names is not None and name not in names:
            return
        w = want[name]
        scale = max(float(np.abs(w).max()), 1e-12) if scale is None else scale
        np.testing.assert_allclose(got[name], w, rtol=rtol, atol=atol_scale * scale,
                                   err_msg=name)

    close("emission", 2e-3, 5e-4)
    close("color", 2e-3, 5e-4)
    close("position", 2e-3, geometry_atol)
    close("radius", 2e-3, geometry_atol)
    close("cam_position", 2e-3, 5e-3)
    cam_scale = max(float(np.abs(want["cam_position"]).max()), 1e-12)
    close("yaw", 0.0, 5e-2, cam_scale)
    close("pitch", 0.0, 5e-2, cam_scale)


def assert_agree(got, ref, atol=nk.SUMS_ATOL):
    checks, _ = ak.agreement(got, ref, "sums", atol)
    failed = [(name, share) for name, share, _, ok in checks if not ok]
    assert not failed, failed


def flat(block):
    return torch.cat([block[:9, :10].reshape(-1), block[9, :3], block[10:14, :3].reshape(-1),
                      block[9, 10:11]])


@pytest.fixture(scope="module")
def state():
    jscene, jcam = jax_cornell_box(), JaxCamera.create()
    scene = scene_from_numpy(*(np.asarray(getattr(jscene, f)) for f in SCENE_FIELDS))
    cam = camera_from_numpy(np.asarray(jcam.position), np.asarray(jcam.yaw),
                            np.asarray(jcam.pitch))
    target = np.random.default_rng(0).uniform(size=(HEIGHT, WIDTH, 3)).astype(np.float32)
    return jscene, jcam, scene, cam, target


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_grads_match_jnp_ad(state, name):
    """``ad_loss_and_grads`` (the forward kernel's colour sums, then one replay
    against the loss's cotangent) against ``jax.value_and_grad`` of the jnp
    backend: all seven blocks, every configuration."""
    jscene, jcam, scene, cam, target = state
    jcfg = jax_cfg(name)

    def loss_fn(scene_, cam_):
        return l2_image_loss(render_color(scene_, cam_, jcfg, 0), jnp.asarray(target))

    loss_j, (ds_j, dc_j) = jax.value_and_grad(loss_fn, argnums=(0, 1))(jscene, jcam)
    want = jax_grads_to_numpy(ds_j, dc_j)
    loss, (ds, dc) = ak.ad_loss_and_grads(scene, cam, port_cfg(name), 0,
                                          torch.from_numpy(target))
    got = grads_to_numpy(ds, dc)
    edge = name == "nee_glossy"
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=5e-4 if edge else 1e-4)
    assert_blocks_close(got, want, geometry_atol=5e-3 if edge else 2e-3)
    assert np.abs(got["emission"]).max() > 0 and np.abs(got["color"]).max() > 0
    if "nee" in name:
        assert all(np.abs(got[k]).max() > 0 for k in GEOMETRY)
    else:  # the colour does not depend on geometry: exact zeros, here and under jnp AD
        assert all(not got[k].any() and not want[k].any() for k in GEOMETRY)


@pytest.mark.parametrize("name", ["diffuse", "glossy"])
def test_depth_and_normal_cotangents_match_jnp_ad(state, name):
    """The geometry probe of ``render_geometry_grads`` (mean depth x 1e-4 +
    mean normal-y) through the kernel's normal and depth cotangents."""
    jscene, jcam, scene, cam, _ = state
    jcfg = jax_cfg(name)
    npix = HEIGHT * WIDTH

    def probe(scene_, cam_):
        aovs = render_aovs_diff(scene_, cam_, jcfg, 0)
        return jnp.mean(aovs["depth"]) * 1e-4 + jnp.mean(aovs["normal"][..., 1])

    _, (ds_j, dc_j) = jax.value_and_grad(probe, argnums=(0, 1))(jscene, jcam)
    ct_normal = torch.zeros(HEIGHT, WIDTH, 3)
    ct_normal[..., 1] = 1.0 / npix
    ct_depth = torch.full((HEIGHT, WIDTH), 1e-4 / npix)
    got = grads_to_numpy(*ak.ad_aov_grads(scene, cam, port_cfg(name), 0, ct_normal=ct_normal,
                                          ct_depth=ct_depth))
    assert_blocks_close(got, jax_grads_to_numpy(ds_j, dc_j), names=GEOMETRY)
    assert all(np.abs(got[k]).max() > 0 for k in GEOMETRY)
    assert not got["emission"].any() and not got["color"].any()


@pytest.mark.parametrize("name", ["diffuse", "glossy"])
def test_albedo_cotangent_matches_jnp_ad(state, name):
    jscene, jcam, scene, cam, _ = state
    jcfg = jax_cfg(name)

    def probe(scene_, cam_):
        return jnp.sum(render_aovs_diff(scene_, cam_, jcfg, 0)["albedo"])

    _, (ds_j, _) = jax.value_and_grad(probe, argnums=(0, 1))(jscene, jcam)
    ds, dc = ak.ad_aov_grads(scene, cam, port_cfg(name), 0,
                             ct_albedo=torch.ones(HEIGHT, WIDTH, 3))
    want = np.asarray(ds_j.color)
    np.testing.assert_allclose(ds.color.numpy(), want, rtol=2e-3, atol=1e-5 * np.abs(want).max())
    assert not ds.position.any() and not ds.emission.any() and not dc.position.any()


def test_albedo_cotangent_matches_the_pallas_kernel(state):
    """Against the TPU kernel itself in interpret mode, the JAX package's own
    not-slow case: 128x16, 1 spp, 2 bounces, an all-ones albedo cotangent."""
    jscene, jcam, scene, cam, _ = state
    ds_p, dc_p = pallas_ad.ad_aov_grads_pallas(
        jscene, jcam, jax_cfg("diffuse", spp=1, max_bounces=2), 0,
        ct_albedo=jnp.ones((HEIGHT, WIDTH, 3), jnp.float32), interpret=True)
    ds, dc = ak.ad_aov_grads(scene, cam, port_cfg("diffuse", spp=1, max_bounces=2), 0,
                             ct_albedo=torch.ones(HEIGHT, WIDTH, 3))
    got, want = grads_to_numpy(ds, dc), jax_grads_to_numpy(ds_p, dc_p)
    np.testing.assert_allclose(got["color"], want["color"], rtol=2e-3,
                               atol=1e-5 * np.abs(want["color"]).max())
    for k in ("radius", "position", "emission", "cam_position", "yaw", "pitch"):
        assert not got[k].any() and not np.asarray(want[k]).any()


def test_glossy_loss_grads_match_the_pallas_kernel(state):
    """``ad_loss_and_grads_pallas`` in interpret mode at 128x16, 1 spp, 2
    bounces, glossy (the JAX package's own glossy case, slow-marked there)."""
    jscene, jcam, scene, cam, target = state
    loss_p, (ds_p, dc_p) = pallas_ad.ad_loss_and_grads_pallas(
        jscene, jcam, jax_cfg("glossy", spp=1, max_bounces=2), 0, jnp.asarray(target),
        interpret=True)
    loss, (ds, dc) = ak.ad_loss_and_grads(scene, cam, port_cfg("glossy", spp=1, max_bounces=2),
                                          0, torch.from_numpy(target))
    np.testing.assert_allclose(float(loss), float(loss_p), rtol=1e-4)
    assert_blocks_close(grads_to_numpy(ds, dc), jax_grads_to_numpy(ds_p, dc_p))


def test_equals_the_nee_kernels_plain_version_on_nee_diffuse(state):
    """With a colour-only cotangent on NEE diffuse the shared sweep computes
    K3's replay plus additions of zero: the same sums, bit for bit."""
    _, _, scene, cam, _ = state
    cfg = port_cfg("nee")
    ct = torch.from_numpy(
        np.random.default_rng(1).normal(size=(3, HEIGHT, WIDTH)).astype(np.float32))
    args = (scene.packed(), tk.camera_block(cam, cfg), tk.make_seed_block(cfg, 2), cfg)
    ct10 = torch.cat([ct, torch.zeros(7, HEIGHT, WIDTH)])
    k4 = ak.replay(*args, ct10, local_h=HEIGHT, spp=SPP)
    k3 = nk.replay_plain(*args, ct.permute(1, 2, 0).contiguous(), local_h=HEIGHT, spp=SPP)
    assert torch.equal(k4, k3) and k4.abs().max() > 0


@pytest.mark.parametrize("name", ["glossy", "nee_glossy"])
def test_slabs_and_sample_ranges_add_up(state, name):
    """``ad_grads_block_slab`` at row and sample offsets addresses the global
    lattice: two slabs x two sample ranges sum to the whole frame's block
    (1e-4 of the largest of the kind: another order of the same terms)."""
    _, _, scene, cam, _ = state
    cfg = port_cfg(name)
    ct = np.random.default_rng(2).normal(size=(10, HEIGHT, WIDTH)).astype(np.float32) / SPP
    ct[9] *= 1e-4
    whole = ak.ad_grads_block_slab(scene, cam, cfg, 4, torch.from_numpy(ct))
    assert whole.shape == (14, nk.BLOCK_COLS)
    parts = 0
    for row in (0, 8):
        for offset, spp in ((0, 1), (1, 1)):
            parts = parts + ak.ad_grads_block_slab(
                scene, cam, cfg, 4, torch.from_numpy(ct[:, row:row + 8].copy()), row_offset=row,
                local_h=8, spp=spp, sample_offset=offset)
    assert_agree(flat(parts), flat(whole), ak.CROSS_ATOL)


def test_replay_is_linear_in_the_cotangent(state):
    """Doubling the cotangent doubles every sum to the bit; channels add up
    (1e-4 of the largest of the kind); a zero cotangent gives zeros."""
    _, _, scene, cam, _ = state
    cfg = port_cfg("nee_glossy", width=32, height=8, spp=4)
    ct = torch.from_numpy(np.random.default_rng(3).normal(size=(10, 8, 32)).astype(np.float32))
    ct[9] *= 1e-4
    args = (scene.packed(), tk.camera_block(cam, cfg), tk.make_seed_block(cfg, 1), cfg)
    kw = dict(local_h=8, spp=4)
    once = ak.replay(*args, ct, **kw)
    assert torch.equal(ak.replay(*args, 2.0 * ct, **kw), 2.0 * once)
    colour, aov = ct.clone(), ct.clone()
    colour[3:] = 0.0
    aov[:3] = 0.0
    assert_agree(ak.replay(*args, colour, **kw) + ak.replay(*args, aov, **kw), once,
                 ak.CROSS_ATOL)
    assert once.abs().max() > 0 and once[-1] == 0
    assert not ak.replay(*args, torch.zeros_like(ct), **kw).any()


def test_pack_cotangents_is_the_jax_packages(state):
    rng = np.random.default_rng(4)
    c, n, a = (rng.normal(size=(HEIGHT, WIDTH, 3)).astype(np.float32) for _ in range(3))
    d = rng.normal(size=(HEIGHT, WIDTH)).astype(np.float32)
    want = pallas_ad.pack_cotangents(jax_cfg("glossy"), jnp.asarray(c), jnp.asarray(n),
                                     jnp.asarray(a), jnp.asarray(d))
    got = ak.pack_cotangents(port_cfg("glossy"), *(torch.from_numpy(x) for x in (c, n, a, d)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    only = ak.pack_cotangents(port_cfg("glossy"), ct_depth=torch.from_numpy(d), local_h=HEIGHT,
                              spp=1)
    assert not only[:9].any() and torch.equal(only[9], torch.from_numpy(d))


@pytest.mark.parametrize("name", ["glossy", "nee_glossy"])
def test_entry_points_dispatch_glossy_to_k4(state, name):
    """``render_loss_grads`` -> ``grad_kernel.loss_and_grads`` ->
    ``ad_loss_and_grads`` on "cuda", bit for bit; ``fused_loss_grads`` and
    ``render_color_grads`` return its emission and albedo parts; the
    ``autograd.Function`` of ``render_color`` has K4's replay as backward
    (rtol 1e-4 plus 1e-4 of the largest: autograd builds the loss's
    cotangent in another order)."""
    _, _, scene, cam, target = state
    cfg = port_cfg(name)
    target = torch.from_numpy(target)
    loss, (ds, dc) = port_grad.render_loss_grads(scene, cam, cfg, 0, target)
    loss_k, (ds_k, dc_k) = ak.ad_loss_and_grads(scene, cam, cfg, 0, target)
    got, want = grads_to_numpy(ds, dc), grads_to_numpy(ds_k, dc_k)
    assert torch.equal(loss, loss_k) and all(np.array_equal(got[k], want[k]) for k in got)
    loss_f, d_e, d_c, color = gk.fused_loss_grads(scene, cam, cfg, 0, target)
    assert torch.equal(loss_f, loss) and torch.equal(d_e, ds.emission)
    assert torch.equal(d_c, ds.color)
    assert torch.equal(color, tk.render_color_sums(scene, cam, cfg, 0) / SPP)
    ct = 2.0 * (color - target) / color.numel()
    d_e, d_c = gk.render_color_grads(scene, cam, cfg, 0, ct)
    assert torch.equal(d_e, ds.emission) and torch.equal(d_c, ds.color)

    leaves = {k: getattr(scene, k).clone().requires_grad_(True) for k in SCENE_FIELDS}
    cam_leaves = [x.clone().requires_grad_(True) for x in (cam.position, cam.yaw, cam.pitch)]
    img = port_grad.render_color(Scene(**leaves), Camera(*cam_leaves), cfg, 0)
    assert torch.equal(img.detach(), color)
    port_grad.l2_image_loss(img, target).backward()
    got = {k: v.grad.numpy() for k, v in leaves.items()}
    got.update(cam_position=cam_leaves[0].grad.numpy(), yaw=cam_leaves[1].grad.numpy(),
               pitch=cam_leaves[2].grad.numpy())
    for k in want:  # autograd rounds the loss's cotangent in another order
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-4 * np.abs(want[k]).max(), err_msg=k)


@pytest.mark.parametrize("name", ["glossy", "nee_glossy"])
def test_kernel_inverse_step_matches_autograd(state, name):
    """The inverse step's kernel route for glossy (two colour passes, two K4
    replays, the clip's subgradient by hand) gives the loss and gradients of
    autograd through ``render_color`` and ``clip01``, with albedos on the
    clip's edges and outside it."""
    _, _, scene, cam, target = state
    cfg = port_cfg(name)
    target = torch.from_numpy(target)
    color = scene.color.clone()
    color[0, 0], color[1, 1], color[2, 2], color[3, 0] = 1.0, 0.0, 1.25, -0.5
    start = Scene(scene.radius, scene.position, scene.emission, color)
    fields = ("emission", "color", "position", "radius")
    state_, step_fn, _ = port_inverse.make_inverse_step(start, cam, cfg, target, fields, 1e-3)
    _, loss = step_fn(state_)
    got = {k: p.grad for k, p in state_.params.items()}

    leaves = {k: getattr(start, k).clone().requires_grad_(True) for k in fields}
    s = port_inverse.apply_params(start, leaves)
    a = port_grad.render_color(s, cam, cfg, 0)
    b = port_grad.render_color(s, cam, cfg, 1)
    loss_ad = torch.mean((a - target) * (b - target))
    want = dict(zip(fields, torch.autograd.grad(loss_ad, [leaves[k] for k in fields])))
    torch.testing.assert_close(loss, loss_ad.detach(), rtol=1e-5, atol=0)
    for k in fields:
        torch.testing.assert_close(got[k], want[k], rtol=1e-4,
                                   atol=1e-4 * float(want[k].abs().max()), msg=k)
    assert bool(got["position"].any()) == cfg.nee
    # The edges carry half the unclipped gradient, the outside none.
    _, d = gk.cross_grads(port_inverse.apply_params(start, {"color": color}), cam, cfg, 0,
                          target)
    assert d["color"].any()
    assert torch.equal(got["color"][0, 0], 0.5 * d["color"][0, 0])
    assert torch.equal(got["color"][1, 1], 0.5 * d["color"][1, 1])
    assert got["color"][2, 2] == 0 and got["color"][3, 0] == 0


@pytest.mark.parametrize("bad", ["spheres", "bounces", "shape", "dtype", "device", "contiguous"])
def test_wrapper_rejects_bad_input(state, bad):
    _, _, scene, cam, _ = state
    cfg = port_cfg("glossy", width=8, height=8, spp=1)
    ct = torch.zeros(10, 8, 8)
    kw = dict(local_h=8, spp=1)
    sb = scene.packed()
    if bad == "spheres":  # 12 spheres: N + 5 rows do not fit the JAX package's 16-row block
        sb = torch.cat([sb, sb[:3]])
    elif bad == "bounces":
        cfg = dataclasses.replace(cfg, max_bounces=ak.MAX_BOUNCES + 1)
    elif bad == "shape":
        ct = torch.zeros(8, 8, 10)
    elif bad == "dtype":
        ct = ct.double()
    elif bad == "device":
        kw["device"] = "meta"
    elif bad == "contiguous":
        ct = torch.zeros(10, 8, 16)[..., ::2]
    with pytest.raises(ValueError, match="at most 11 spheres" if bad == "spheres" else None):
        ak.replay(sb, tk.camera_block(cam, cfg), tk.make_seed_block(cfg), cfg, ct, **kw)


def test_largest_scene_and_block_fit_shared_memory(state):
    """11 spheres at the largest block edge: 184 accumulator floats a thread
    x 256 threads x 4 bytes = 188,416, inside a block's 232,448."""
    _, _, scene, cam, _ = state
    cfg = port_cfg("glossy", width=8, height=8, spp=1, block=16)
    sb = torch.cat([scene.packed(), scene.packed()[:2]])
    assert 4 * nk.n_slots(11) * 16 * 16 == 188416 <= nk.MAX_SHARED_BYTES
    out = ak.replay(sb, tk.camera_block(cam, cfg), tk.make_seed_block(cfg), cfg,
                    torch.zeros(10, 8, 8), local_h=8, spp=1)
    assert out.shape == (126,) and not out.any()
