"""The kernels' scene, camera and seed blocks as device arrays.

K1-K5 take scene [N, 10], camera [5, 3] and seed [5] from device memory, as
the TPU kernels take them from SMEM; the entry points build the blocks where
the scene and camera live (``trace_kernel.device_blocks``) and the wrappers
move host ones to the launch device without a wait for the card
(``launch_operands``). Here, on the CPU:

- the seed block (``seed_array``) holds ``pathtrace_tpu.ops.pallas_trace.
  make_seed_array``'s values for several seeds, frames and offsets, a seed
  above 2**31 included;
- the camera block of a host camera is ``camera_block``'s to the bit, and
  JAX's ``cam_params`` (``pallas_trace.py:629-630``) within the camera
  tests' tolerance (rtol 1e-6, atol 1e-6);
- ``grads_from_block``, which contracts the camera basis' Jacobian on the
  block's device, equals the host autograd pullback it replaced (rtol 1e-6
  plus 1e-6 of the largest: one rounding order against another);
- making the blocks reads no value: driven with scene and camera on
  PyTorch's ``meta`` device, where any read raises, ``device_blocks`` and
  the staging give blocks of the right shapes and types;
- the wrappers take the seed as the five integers or as the tensor, and
  raise on blocks of the wrong type, shape or device.

The ``cuda`` tests need the card (they skip here): every main-path entry
point, with scene and camera on the host and on the card, runs under
``torch.cuda.set_sync_debug_mode("error")``, and each kernel captured in a
CUDA graph reads the new contents of its blocks when replayed. On the card:

    python -m pytest tests/test_torch_launch_blocks.py -m cuda --noconftest -o addopts="" -q
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box
from pathtrace_tpu_torch.ops import grad_kernel as gk
from pathtrace_tpu_torch.ops import nee_grad_kernel as nk
from pathtrace_tpu_torch.ops import trace_kernel as tk

SEEDS = (0, 42, 2**31 + 7, 2**32 + 5)
OFFSETS = ((0, 0, 0, 0), (3, 5, 16, 0), (987654, 1024, 256, 64))
POSES = (((50.0, 52.0, 295.6), -90.0, 0.0), ((40.0, 45.0, 250.0), -80.0, 7.5),
         ((60.0, 30.0, 200.0), -100.0, -12.0))


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the blocks ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("frame, sample_offset, row_offset, col_offset", OFFSETS)
def test_seed_block_is_jax_make_seed_array(seed, frame, sample_offset, row_offset, col_offset):
    from pathtrace_tpu import RenderConfig as JaxConfig
    from pathtrace_tpu.ops.pallas_trace import make_seed_array

    want = np.asarray(make_seed_array(JaxConfig(seed=seed), frame, sample_offset, row_offset,
                                      col_offset))
    block = tk.make_seed_block(RenderConfig(seed=seed), frame, sample_offset, row_offset,
                               col_offset)
    got = tk.seed_array(block)
    assert got.dtype == torch.int32 and tuple(got.shape) == (5,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == seed & 0x7FFFFFFF
    assert tk.seed_values(got) == block
    assert tk.seed_array(got) is got


def test_seed_words_wrap_to_32_bits():
    got = tk.seed_array((1, 2**32 - 1, 2**31, 2**32 + 3, 7))
    assert got.tolist() == [1, -1, -(2**31), 3, 7]
    assert tk.seed_values(got) == (1, 2**32 - 1, 2**31, 3, 7)


@pytest.mark.parametrize("pose", POSES)
@pytest.mark.parametrize("size", ((64, 48), (512, 512)))
def test_camera_block_of_a_host_camera(pose, size):
    import jax.numpy as jnp
    from pathtrace_tpu import Camera as JaxCamera

    width, height = size
    cfg = RenderConfig(width=width, height=height)
    cam = Camera.create(*pose)
    want = torch.cat([cam.position[None, :], cam.eye_ray_basis(width, height)]).to(torch.float32)
    sb, cb, dev = tk.device_blocks(cornell_box(), cam, cfg, "cpu")
    assert dev == torch.device("cpu")
    assert torch.equal(cb, tk.camera_block(cam, cfg)) and torch.equal(cb, want)
    assert torch.equal(sb, cornell_box().packed())
    jcam = JaxCamera.create(*pose)
    cam_params = jnp.concatenate([jcam.position[None, :], jcam.eye_ray_basis(width, height)],
                                 axis=0)
    np.testing.assert_allclose(cb.numpy(), np.asarray(cam_params), rtol=1e-6, atol=1e-6)


def test_making_the_blocks_reads_no_value():
    """On the meta device a tensor has no values: any read (``.item()``,
    ``.tolist()``, ``.cpu()``) raises. ``device_blocks`` runs there to the
    end, and so does the staging of host blocks for a launch."""
    meta = torch.device("meta")
    cfg = RenderConfig(width=32, height=16, spp=2)
    seed = tk.make_seed_block(cfg, 3, 1, 8)
    sb, cb, dev = tk.device_blocks(cornell_box(device=meta), Camera.create(device=meta), cfg,
                                   meta)
    assert dev == meta
    for t, shape in ((sb, (9, 10)), (cb, (5, 3))):
        assert t.device == meta and tuple(t.shape) == shape and t.dtype == torch.float32
    with pytest.raises(NotImplementedError):
        sb.tolist()
    # Host scene and camera and a seed: one buffer laid out as the kernels'
    # constant copy (the scene padded to MAX_SPHERES rows, camera, seed), so
    # that the launch copies it in one piece; the addresses are its words.
    host_sb, host_cb = cornell_box().packed(), tk.camera_block(Camera.create(), cfg)
    staged, *addr = tk.launch_operands(host_sb, host_cb, seed, meta)
    assert staged.device == meta and staged.numel() == 10 * tk.MAX_SPHERES + 15 + 5
    assert addr == [0, 4 * 160, 4 * 175]  # a meta tensor's address is 0
    # A block on the launch device stays; the others follow one another.
    staged, *addr = tk.launch_operands(sb, host_cb, seed, meta)
    assert staged.numel() == 15 + 5 and addr == [0, 0, 4 * 15]
    assert tk.launch_operands(sb, cb, tk.seed_array(seed, meta), meta)[0] is None
    # As tensors (a script's blocks staged once): views of one buffer.
    sb2, cb2, sd2 = tk.stage_blocks((host_sb, host_cb, tk.seed_array(seed)), meta)
    assert (sb2.storage_offset(), cb2.storage_offset(), sd2.storage_offset()) == (0, 160, 175)
    assert tuple(cb2.shape) == (5, 3) and sd2.dtype == torch.int32
    assert tk.seed_array(seed, meta).device == meta


def test_host_blocks_stay_where_they_are():
    cfg = RenderConfig(width=16, height=8)
    blocks = (cornell_box().packed(), tk.camera_block(Camera.create(), cfg),
              tk.seed_array((1, 2, 3, 4, 5)))
    assert all(a is b for a, b in zip(tk.stage_blocks(blocks, "cpu"), blocks))
    sb, cb, dev = tk.device_blocks(cornell_box(), Camera.create(), cfg, "cpu")
    assert torch.equal(sb, blocks[0]) and torch.equal(cb, blocks[1])


# -- the camera pullback --------------------------------------------------------------

def _host_autograd_pullback(cam, cfg, block, n):
    """The formulation ``grads_from_block`` replaced: autograd through
    ``eye_ray_basis`` on the host against the corner rays' cotangents."""
    leaves = [getattr(cam, k).detach().requires_grad_(True) for k in ("position", "yaw", "pitch")]
    with torch.enable_grad():
        basis = Camera(*leaves).eye_ray_basis(cfg.width, cfg.height)
        grads = torch.autograd.grad(basis, leaves, grad_outputs=block[n + 1: n + 5, 0:3],
                                    allow_unused=True)
    d_pos, d_yaw, d_pitch = (torch.zeros_like(x) if g is None else g
                             for x, g in zip(leaves, grads))
    return d_pos + block[n, 0:3], d_yaw, d_pitch


@pytest.mark.parametrize("pose", POSES)
@pytest.mark.parametrize("block_seed", (0, 1, 2))
def test_grads_from_block_equals_the_host_autograd_pullback(pose, block_seed):
    cfg = RenderConfig(width=64, height=48)
    scene, cam = cornell_box(), Camera.create(*pose)
    n = scene.num_objects
    block = torch.from_numpy(np.random.default_rng(block_seed).normal(
        size=(n + 5, nk.BLOCK_COLS)).astype(np.float32))
    d_scene, d_cam = nk.grads_from_block(scene, cam, cfg, block)
    want = _host_autograd_pullback(cam, cfg, block, n)
    got = (d_cam.position, d_cam.yaw, d_cam.pitch)
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-6 * scale)
    assert torch.equal(d_cam.position, block[n, 0:3])
    assert torch.equal(d_scene.position, block[:n, 1:4])


def test_basis_jacobian_is_the_basis_derivative():
    """Each row of the Jacobian is d basis / d angle: against a central
    difference in float64 (the angles in degrees, step 1e-3)."""
    cfg = RenderConfig(width=64, height=48)
    cam = Camera.create((40.0, 45.0, 250.0), -80.0, 7.5)
    jac = nk.basis_jacobian(cam, cfg)
    assert tuple(jac.shape) == (2, 12) and jac.dtype == torch.float32
    h = 1e-3
    for row, name in enumerate(("yaw", "pitch")):
        def basis(delta):
            pose = {k: getattr(cam, k).double() for k in ("position", "yaw", "pitch")}
            pose[name] = pose[name] + delta
            return Camera(**pose, dtype=torch.float64).eye_ray_basis(cfg.width, cfg.height)
        fd = ((basis(h) - basis(-h)) / (2 * h)).reshape(-1)
        np.testing.assert_allclose(jac[row].double().numpy(), fd.numpy(), rtol=1e-3,
                                   atol=1e-4 * float(fd.abs().max()))


# -- the wrappers ---------------------------------------------------------------------

def test_wrappers_take_the_seed_as_integers_or_tensor():
    cfg = RenderConfig(width=16, height=8, spp=2)
    sb, cb = cornell_box().packed(), tk.camera_block(Camera.create(), cfg)
    seed = tk.make_seed_block(cfg, 2, 1, 4)
    kw = dict(local_h=8, spp=2)
    a = tk.trace(sb, cb, seed, cfg, mode="partials", **kw)
    b = tk.trace(sb, cb, tk.seed_array(seed), cfg, mode="partials", **kw)
    assert torch.equal(a, b)
    for x, y in zip(gk.dump(sb, cb, seed, cfg, **kw), gk.dump(sb, cb, tk.seed_array(seed), cfg,
                                                               **kw)):
        assert torch.equal(x, y)


def test_wrappers_raise_on_bad_blocks():
    cfg = RenderConfig(width=16, height=8, spp=1)
    sb, cb = cornell_box().packed(), tk.camera_block(Camera.create(), cfg)
    kw = dict(local_h=8, spp=1, mode="color")
    good = tk.seed_array(tk.make_seed_block(cfg))
    for bad in (good.long(), good[:4], torch.stack([good, good], 1)[:, 0]):
        with pytest.raises(ValueError, match="seed block"):
            tk.trace(sb, cb, bad, cfg, **kw)
    with pytest.raises(ValueError, match="seed block"):
        tk.trace(sb, cb, good.to("meta"), cfg, **kw)
    # A CUDA launch takes blocks on its device or on the host, nothing else;
    # the check comes before anything touches a card.
    with pytest.raises(ValueError, match="scene block is on meta"):
        tk.launch_operands(sb.to("meta"), cb.to("meta"), good, torch.device("cuda", 0))
    with pytest.raises(ValueError, match="seed block is on meta"):
        tk.launch_operands(sb, cb, good.to("meta"), torch.device("cuda", 0))


def test_loss_and_grads_zeros_are_made_on_the_loss_device():
    """The diffuse route's geometry and camera zeros are made where the loss
    is, of the scene's and camera's shapes: nothing is copied to or from
    the card for them."""
    cfg = RenderConfig(width=16, height=8, spp=2, backend="cuda")
    target = torch.rand(8, 16, 3, generator=torch.Generator().manual_seed(0))
    loss, (d_scene, d_cam) = gk.loss_and_grads(cornell_box(), Camera.create(), cfg, 0, target,
                                               device="cpu")
    assert torch.equal(d_scene.radius, torch.zeros(9)) and d_scene.position.shape == (9, 3)
    assert torch.equal(d_cam.position, torch.zeros(3)) and d_cam.yaw.shape == ()
    assert bool(torch.isfinite(loss))


# -- on the card --------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("where", ("host", "card"))
def test_entry_points_never_wait_for_the_card(dev, where):
    cs = _chip_smoke()
    place = dev if where == "card" else None
    calls = cs.main_path_calls(dev, cornell_box(device=place), Camera.create(device=place),
                               size=64, spp=4, step_size=32)
    torch.cuda.synchronize()
    outs = {}
    torch.cuda.set_sync_debug_mode("error")
    try:
        for name, call in calls:
            outs[name] = call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for name, out in outs.items():
        tensors = cs._tensors(out)
        assert tensors and all(bool(torch.isfinite(t).all()) for t in tensors), name


@pytest.mark.cuda
def test_captured_launches_read_their_blocks_when_replayed(dev):
    """chip_smoke.py phase 25 (b) at a small size."""
    from pathtrace_tpu_torch.ops import ad_grad_kernel as ak

    cs = _chip_smoke()
    cs.GRAPH_SIZE, cs.GRAPH_SPP = 32, 2
    cs.graph_replay_checks(dev, tk, gk, nk, ak)


@pytest.mark.cuda
def test_a_refused_launch_raises(dev):
    cfg = RenderConfig(width=16, height=16, spp=4)
    sb, cb = cornell_box().packed(), tk.camera_block(Camera.create(), cfg)
    with pytest.raises(RuntimeError, match="launch failed"):
        tk.CUDA_KERNEL.launch(sb, cb, tk.make_seed_block(cfg), cfg, local_h=16, spp=4,
                              mode="color", device=dev, lanes=3)
