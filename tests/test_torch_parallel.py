"""The port's ("tiles", "samples") grid against the port on one device and
against the JAX package's mesh, on the CPU.

Each world of ranks (gloo, ``device="cpu"``) is started once, in a module
fixture: one of 4 ranks runs the grids (4, 1), (2, 2), (1, 4) and one of 2
ranks (2, 1), (1, 2); every case of this file runs in them, and the parent
compares. The JAX side runs ``pathtrace_tpu.parallel`` with ``backend=
"jnp"`` on the virtual CPU devices of tests/conftest.py. On the CPU the
port's ``backend="cuda"`` runs the kernels' plain versions (``trace_kernel.
trace`` and the gradient wrappers on CPU tensors), so the kernel route of
``parallel/shard.py`` is covered here too.

Tolerances:

- the grid against the port on one device, the JAX package's own for its
  mesh (tests/test_sharding.py): render means rtol/atol 1e-4, each variance
  channel scaled by its largest value to atol 2e-3 (the merges reassociate);
  loss rtol 1e-5, each gradient rtol 1e-3 plus 1e-4 of its block's largest
  entry;
- the grid against JAX's mesh, the port-against-JAX tolerances of ROADMAP
  C4 (0.02-0.2% of pixels take another path on the CPU): render under
  ``test_torch_trace_kernel.assert_channels_close``; loss rtol 2e-3 and
  every gradient rtol 2e-2 plus 2e-2 of its block's largest entry, the
  tolerance of this estimator across a flipped path (tests/test_pallas_grad.py,
  tests/test_torch_nee_grad.py): at 32x32x4, seed 2, one flip moves the
  diffuse loss by 9.8e-4 of itself in both routes of the port;
- every rank of a world returns the same frame, loss and gradients, bit
  for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtrace_tpu import Camera as JaxCamera
from pathtrace_tpu import RenderConfig as JaxConfig
from pathtrace_tpu import cornell_box as jax_cornell_box
from pathtrace_tpu.parallel import make_mesh as jax_make_mesh
from pathtrace_tpu.parallel.shard import render_channels_sharded as jax_render_sharded
from pathtrace_tpu.parallel.shard import sharded_loss_grads as jax_sharded_loss_grads

from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box
from pathtrace_tpu_torch import grad as port_grad
from pathtrace_tpu_torch.convert import grads_to_numpy
from pathtrace_tpu_torch.ops import ad_grad_kernel as ak
from pathtrace_tpu_torch.ops import grad_kernel as gk
from pathtrace_tpu_torch.ops import nee_grad_kernel as nk
from pathtrace_tpu_torch.ops import sweep
from pathtrace_tpu_torch.ops import trace_kernel as tk
from pathtrace_tpu_torch.parallel import make_mesh, render_channels_sharded
from pathtrace_tpu_torch.parallel.launch import choose_backend, launch
from pathtrace_tpu_torch.parallel.mesh import Mesh, grid_shape, initialize_multihost
from pathtrace_tpu_torch.parallel.selfcheck import run_cases
from pathtrace_tpu_torch.parallel.shard import sharded_loss_grads
from pathtrace_tpu_torch.render import render_channels

from test_torch_trace_kernel import assert_channels_close

GRIDS = {4: [(4, 1), (2, 2), (1, 4)], 2: [(2, 1), (1, 2)]}
ALL_GRIDS = GRIDS[4] + GRIDS[2]
RENDER = dict(width=64, height=64, spp=8, seed=2)
SPP2 = dict(width=32, height=16, spp=2, seed=4)
GRAD_CFGS = {
    "diffuse": dict(width=32, height=32, spp=4, seed=2),
    "nee": dict(width=128, height=16, spp=2, seed=2, max_bounces=2, nee=True),
    "glossy": dict(width=128, height=16, spp=2, seed=2, max_bounces=2, brdf="glossy"),
    "nee_glossy": dict(width=128, height=16, spp=2, seed=2, max_bounces=2, nee=True,
                       brdf="glossy"),
}
# (route, backend) of the gradient cases: the four kernel routes, and
# autograd through the wavefront.
GRAD_CASES = [(r, "cuda") for r in GRAD_CFGS] + [("diffuse", "torch")]
GRAD_GRIDS = {"diffuse": [(2, 2), (2, 1), (1, 2)]}  # the other routes: (2, 2)
FIELDS = ("radius", "position", "emission", "color", "cam_position", "yaw", "pitch")


def _target(cfg):
    return np.random.default_rng(0).uniform(size=(cfg["height"], cfg["width"], 3)).astype(
        np.float32)


def _grad_grids(route):
    return GRAD_GRIDS.get(route, [(2, 2)])


@pytest.fixture(scope="module")
def worlds():
    """Every case of the file on a world of 4 and a world of 2 ranks ->
    {(kind, grid, ...): [the result of each rank]}."""
    scene, cam = cornell_box(), Camera.create()
    out = {}
    for n, grids in GRIDS.items():
        keys, cases = [], []
        for grid in grids:
            for backend in ("cuda", "torch"):
                keys.append(("render", grid, backend))
                cases.append(dict(kind="render", grid=grid, scene=scene, cam=cam,
                                  cfg=RenderConfig(backend=backend, **RENDER)))
        for route, backend in GRAD_CASES:
            for grid in _grad_grids(route):
                if grid in grids:
                    keys.append(("grads", grid, route, backend))
                    cfg = GRAD_CFGS[route]
                    cases.append(dict(kind="grads", grid=grid, scene=scene, cam=cam,
                                      cfg=RenderConfig(backend=backend, **cfg),
                                      target=torch.from_numpy(_target(cfg))))
        if n == 4:
            for route, cfg in GRAD_CFGS.items():
                keys.append(("grad_slab", (2, 2), route))
                cases.append(dict(kind="grad_slab", grid=(2, 2), scene=scene, cam=cam,
                                  cfg=RenderConfig(backend="cuda", **cfg),
                                  target=torch.from_numpy(_target(cfg))))
        if n == 2:
            keys.append(("render_spp2", (1, 2)))
            cases.append(dict(kind="render", grid=(1, 2), scene=scene, cam=cam,
                              cfg=RenderConfig(backend="cuda", **SPP2)))
        keys.append(("mesh", n))
        cases.append(dict(kind="mesh"))
        by_rank = launch(run_cases, n, cases, device="cpu")
        for i, key in enumerate(keys):
            out[key] = [r[i] for r in by_rank]
    return out


@pytest.fixture(scope="module")
def jax_state():
    return jax_cornell_box(), JaxCamera.create()


def _jax_mesh(grid):
    return jax_make_mesh(tiles=grid[0], samples=grid[1],
                         devices=jax.devices()[: grid[0] * grid[1]])


@pytest.fixture(scope="module")
def jax_frames(jax_state):
    scene, cam = jax_state
    cfg = JaxConfig(backend="jnp", **RENDER)
    return {grid: np.asarray(jax_render_sharded(scene, cam, cfg, _jax_mesh(grid)))
            for grid in ALL_GRIDS}


_ONE_DEVICE = {}


def _one_device(key, fn):
    """The single-device reference of ``key``, computed once a module."""
    if key not in _ONE_DEVICE:
        _ONE_DEVICE[key] = fn()
    return _ONE_DEVICE[key]


def _assert_frames_close(out, ref):
    """tests/test_sharding.py's tolerances."""
    assert out.shape == ref.shape
    np.testing.assert_allclose(out[..., :10], ref[..., :10], rtol=1e-4, atol=1e-4)
    for c in range(10, 14):
        scale = max(np.abs(ref[..., c]).max(), 1e-3)
        np.testing.assert_allclose(out[..., c] / scale, ref[..., c] / scale, atol=2e-3)


def _same_on_every_rank(results):
    first = results[0]
    for r in results[1:]:
        if isinstance(first, dict):
            assert r["loss"] == first["loss"]
            for k in FIELDS:
                np.testing.assert_array_equal(r["grads"][k], first["grads"][k])
        else:
            np.testing.assert_array_equal(r.numpy(), first.numpy())


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("grid", ALL_GRIDS)
def test_grid_render_matches_one_device(worlds, grid, backend):
    results = worlds["render", grid, backend]
    _same_on_every_rank(results)
    cfg = RenderConfig(backend=backend, **RENDER)
    ref = _one_device(("render", backend), lambda: render_channels(
        cornell_box(), Camera.create(), cfg, device="cpu").numpy())
    _assert_frames_close(results[0].numpy(), ref)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("grid", ALL_GRIDS)
def test_grid_render_matches_jax_mesh(worlds, jax_frames, grid, backend):
    assert_channels_close(worlds["render", grid, backend][0].numpy(), jax_frames[grid])


def _assert_grads_close(got, want, loss_rtol, shading, geometry):
    """Each field within rtol plus a share of its block's largest |want|:
    ``shading`` (rtol, share) for emission and albedo, ``geometry`` for
    radius, position and the camera."""
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=loss_rtol)
    blocks = {"shading": ("emission", "color"),
              "geometry": ("radius", "position", "cam_position", "yaw", "pitch")}
    for block, (rtol, share) in (("shading", shading), ("geometry", geometry)):
        scale = max(float(np.abs(want["grads"][k]).max()) for k in blocks[block])
        for k in blocks[block]:
            np.testing.assert_allclose(got["grads"][k], want["grads"][k], rtol=rtol,
                                       atol=share * max(scale, 1e-12), err_msg=k)


@pytest.mark.parametrize("route,backend,grid",
                         [(r, b, g) for r, b in GRAD_CASES for g in _grad_grids(r)])
def test_grid_grads_match_one_device(worlds, route, backend, grid):
    results = worlds["grads", grid, route, backend]
    _same_on_every_rank(results)
    cfg = RenderConfig(backend=backend, **GRAD_CFGS[route])

    def reference():
        loss, grads = port_grad.render_loss_grads(cornell_box(), Camera.create(), cfg, 0,
                                                  _target(GRAD_CFGS[route]), device="cpu")
        return {"loss": float(loss), "grads": grads_to_numpy(*grads)}

    want = _one_device(("grads", route, backend), reference)
    _assert_grads_close(results[0], want, 1e-5, (1e-3, 1e-4), (1e-3, 1e-4))


@pytest.mark.parametrize("route,backend", GRAD_CASES)
def test_grid_grads_match_jax_mesh(worlds, jax_state, route, backend):
    scene, cam = jax_state
    cfg = JaxConfig(backend="jnp", **GRAD_CFGS[route])
    loss, (ds, dc) = jax_sharded_loss_grads(scene, cam, cfg, _jax_mesh((2, 2)),
                                            jnp.asarray(_target(GRAD_CFGS[route])))
    want = {"loss": float(loss), "grads": {
        k: np.asarray(getattr(ds, k)) for k in ("radius", "position", "emission", "color")}}
    want["grads"].update(cam_position=np.asarray(dc.position), yaw=np.asarray(dc.yaw),
                         pitch=np.asarray(dc.pitch))
    _assert_grads_close(worlds["grads", (2, 2), route, backend][0], want, 2e-3,
                        (2e-2, 2e-2), (2e-2, 2e-2))


@pytest.mark.parametrize("route", list(GRAD_CFGS))
def test_grad_slab_launches_are_their_plain_versions(worlds, route):
    """Each rank's backward launch on (2, 2), with the seed block it was
    given and the residual its cotangent was made of (what chip_smoke.py
    holds against the plain version on the card): on the CPU the wrapper runs the plain version, so
    the parent's plain call on those inputs gives the same bits; and the
    ranks' outputs compose into the grid's gradients (rtol 1e-5 plus 1e-7
    of the field's largest entry: the parent adds in another order than the
    all-reduce)."""
    cfg = RenderConfig(backend="cuda", **GRAD_CFGS[route])
    scene, cam = cornell_box(), Camera.create()
    sb, cb = scene.packed(), tk.camera_block(cam, cfg)
    results = worlds["grad_slab", (2, 2), route]
    target = torch.from_numpy(_target(GRAD_CFGS[route]))
    denom = cfg.height * cfg.width * 3
    h = cfg.height // 2
    g = 0.0
    for rank, r in enumerate(results):
        assert (r["route"], r["local_h"], r["spp"]) == (gk.route(cfg), h, cfg.spp // 2)
        kw = dict(local_h=h, spp=r["spp"], device="cpu")
        if route == "diffuse":
            color, acc = gk.dump_plain(sb, cb, r["seed"], cfg, **kw)
            assert torch.equal(r["color"], color) and torch.equal(r["acc"], acc)
            ti = rank // 2
            mine = results[2 * ti: 2 * ti + 2]
            diff = sum(x["color"] * x["scale"] for x in mine) - target[ti * h:(ti + 1) * h]
            d_e, d_c = gk.contract(2.0 * diff / denom * r["scale"], r["acc"])
            g = g + torch.cat([d_e, d_c], dim=1)
            continue
        # the cotangent of the mean colour, in the layout of the route's kernel
        ct = 2.0 * r["diff"] / denom
        if route == "nee":
            sums = nk.replay_plain(sb, cb, r["seed"], cfg, ct / cfg.spp, **kw)
        else:
            sums = ak.replay_plain(sb, cb, r["seed"], cfg,
                                   ak.pack_cotangents(cfg, ct, local_h=h), **kw)
        assert torch.equal(r["block"], sweep.block_from_sums(sums))
        g = g + r["block"]
    want = worlds["grads", (2, 2), route, "cuda"][0]["grads"]
    if route == "diffuse":
        got = {"emission": g[:, 0:3].numpy(), "color": g[:, 3:6].numpy()}
    else:
        got = grads_to_numpy(*sweep.grads_from_block(scene, cam, cfg, g))
    for k, x in got.items():
        np.testing.assert_allclose(x, want[k], rtol=1e-5,
                                   atol=1e-7 * max(float(np.abs(want[k]).max()), 1e-12),
                                   err_msg=k)


def test_diffuse_kernel_route_gives_exact_zero_geometry(worlds):
    grads = worlds["grads", (2, 2), "diffuse", "cuda"][0]["grads"]
    for k in ("radius", "position", "cam_position", "yaw", "pitch"):
        assert not np.any(grads[k]), k


@pytest.mark.parametrize("n", [4, 2])
def test_mesh_shapes_of_a_world(worlds, n):
    """make_mesh's defaults in a world: all ranks on "tiles"; samples=2 takes
    the rest; a shape that does not factor the world raises."""
    for r in worlds["mesh", n]:
        assert r["shapes"] == [{"tiles": n, "samples": 1}, {"tiles": n // 2, "samples": 2}]
        assert r["error"] == f"mesh 3x{n // 3} != {n} devices; pick divisors of {n}"


def test_mesh_without_a_world_is_one_rank():
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"tiles": 1, "samples": 1} and not mesh.distributed
    assert (mesh.ti, mesh.si, mesh.rank) == (0, 0, 0)
    assert grid_shape(8) == (8, 1) and grid_shape(8, samples=4) == (2, 4)
    with pytest.raises(ValueError, match="pick divisors"):
        make_mesh(tiles=3, device="cpu")
    with pytest.raises(ValueError, match="pick divisors"):
        grid_shape(8, tiles=3)
    assert initialize_multihost(num_processes=1) is False


def test_single_rank_grid_equals_one_device():
    """With no process group every collective is the identity: the grid of
    one rank is the single-device frame."""
    cfg = RenderConfig(width=32, height=16, spp=4, backend="cuda", seed=1)
    got = render_channels_sharded(cornell_box(), Camera.create(), cfg, make_mesh(device="cpu"))
    ref = render_channels(cornell_box(), Camera.create(), cfg, device="cpu")
    _assert_frames_close(got.numpy(), ref.numpy())


def _unjoined_mesh(tiles, samples):
    return Mesh({"tiles": tiles, "samples": samples}, 0, 0, 0, None, None, None,
                torch.device("cpu"))


def test_divisibility_errors():
    """tests/test_sharding.py:86-93 on the port: a height or spp that does not
    divide the grid raises before any launch."""
    scene, cam = cornell_box(), Camera.create()
    bad_h = RenderConfig(width=64, height=60, spp=8, backend="torch")
    with pytest.raises(ValueError, match="not divisible"):
        render_channels_sharded(scene, cam, bad_h, _unjoined_mesh(8, 1))
    bad_spp = RenderConfig(width=64, height=64, spp=6, backend="cuda")
    with pytest.raises(ValueError, match="not divisible"):
        render_channels_sharded(scene, cam, bad_spp, _unjoined_mesh(2, 4))
    with pytest.raises(ValueError, match="not divisible"):
        sharded_loss_grads(scene, cam, bad_h, _unjoined_mesh(8, 1), np.zeros((60, 64, 3)))


def test_launch_raises_with_the_rank_traceback():
    with pytest.raises(RuntimeError, match="rank 0 of 1 failed(.|\n)*unknown case kind"):
        launch(run_cases, 1, [dict(kind="nonsense", grid=(1, 1))], device="cpu")
    with pytest.raises(ValueError, match="importable module"):
        launch(lambda device=None: 0, 1, device="cpu")


def test_launch_kills_a_world_past_its_timeout():
    """A world not done within its timeout is killed and raises (a rank that
    starts takes seconds to import torch, far beyond 0.2 s)."""
    with pytest.raises(RuntimeError, match="not done within 0.2 s"):
        launch(run_cases, 2, [dict(kind="mesh")], device="cpu", timeout_s=0.2)


def test_backend_choice():
    assert choose_backend(4, "cpu") == "gloo"
    if not torch.cuda.is_available():
        assert choose_backend(1) == "gloo"


def test_one_sample_a_rank_keeps_the_global_jitter(worlds):
    """At 2 spp on (1, 2) each rank traces one sample: the ranks take the
    global cfg, whose jitter follows the global spp (a 1-spp render would
    not jitter), so the frame is still the single-device one."""
    cfg = RenderConfig(backend="cuda", **SPP2)
    ref = render_channels(cornell_box(), Camera.create(), cfg, device="cpu").numpy()
    _assert_frames_close(worlds["render_spp2", (1, 2)][0].numpy(), ref)
