"""The port's row-sharded denoisers against the whole frame's forward and
against the JAX package's sharded ones, on the CPU.

The nets are tests/test_spatial.py's: ``SimpleDenoiseCNN`` from
``create_simple_state(key(0))`` and the full-width ``DenoiseCNN`` from
``init_variables(key(2), 64, 64)`` with its BatchNorm statistics drawn from
a seed, carried across by ``convert.simple_state_dict_from_flax`` and
``denoise_state_dict_from_flax``. One world of 4 ranks (grids (4, 1) and
(2, 2)) and one of 2 ((2, 1)), gloo on the CPU, run every case in a module
fixture, and the parent compares. Tolerances:

- the sharded output against the port's whole-frame forward, the JAX
  package's for its own (tests/test_spatial.py): ``SimpleDenoiseCNN`` rtol
  1e-5 and atol 1e-5, ``DenoiseCNN`` rtol 1e-5 and atol 2e-5;
- against the JAX package's sharded output on the same grid: atol 1e-4,
  the port's forward against Flax's (tests/test_torch_model.py);
- a frame rendered on the grid (64x64, 2 spp), preprocessed and passed as
  slabs into both denoisers: the frame against the single-device frame
  (tests/test_sharding.py's tolerances), the preprocessed slabs against
  ``preprocess_channels`` of the gathered frame to the bit, the outputs
  against the whole-frame forwards on that input (above; the simple net's
  atol times its largest output, since the preprocessed colour of the
  light, whose albedo is 0, is 1 / 0.00316 times its radiance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtrace_tpu.models.denoise_cnn import init_variables
from pathtrace_tpu.models.fpn_spatial import denoise_fpn_sharded as jax_denoise_fpn_sharded
from pathtrace_tpu.models.simple_cnn import create_simple_state
from pathtrace_tpu.models.spatial import denoise_spatially_sharded as jax_denoise_spatially
from pathtrace_tpu.parallel import make_mesh as jax_make_mesh

from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box
from pathtrace_tpu_torch.convert import denoise_state_dict_from_flax, simple_state_dict_from_flax
from pathtrace_tpu_torch.models.fpn_spatial import denoise_fpn_sharded
from pathtrace_tpu_torch.models.preprocess import preprocess_channels
from pathtrace_tpu_torch.parallel.launch import launch
from pathtrace_tpu_torch.parallel.mesh import Mesh
from pathtrace_tpu_torch.parallel.selfcheck import build_model, run_cases
from pathtrace_tpu_torch.parallel.shard import shard_rows
from pathtrace_tpu_torch.render import render_channels

GRIDS = {4: [(4, 1), (2, 2)], 2: [(2, 1)]}
ALL_GRIDS = GRIDS[4] + GRIDS[2]
RENDER = RenderConfig(width=64, height=64, spp=2, seed=6, backend="cuda")


@pytest.fixture(scope="module")
def nets():
    """(JAX simple params, JAX FPN variables, the port's specs of both)."""
    _, params, _, _ = create_simple_state(jax.random.key(0), (32, 64, 14))
    _, variables = init_variables(jax.random.key(2), 64, 64)
    rng = np.random.default_rng(3)
    stats = jax.tree.map(lambda a: jnp.asarray(np.abs(rng.normal(1.0, 0.3, a.shape)) + 0.1,
                                               a.dtype), variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    np_tree = jax.tree.map(np.asarray, variables)
    simple = {"kind": "simple", "features": 64, "depth": 4,
              "state": simple_state_dict_from_flax(jax.tree.map(np.asarray, params))}
    fpn = {"kind": "fpn", "widths": (32, 64, 128, 256, 512, 1024),
           "state": denoise_state_dict_from_flax(np_tree)}
    return params, variables, simple, fpn


def _inputs():
    """tests/test_spatial.py's inputs: normal (seed 0) for the simple net,
    uniform (seed 4) for the FPN."""
    simple = np.random.default_rng(0).normal(size=(64, 64, 14)).astype(np.float32)
    fpn = np.random.default_rng(4).uniform(size=(64, 64, 14)).astype(np.float32)
    return simple, fpn


@pytest.fixture(scope="module")
def worlds(nets):
    _, _, simple, fpn = nets
    x_simple, x_fpn = _inputs()
    out = {}
    for n, grids in GRIDS.items():
        keys, cases = [], []
        for grid in grids:
            keys += [("simple", grid), ("fpn", grid)]
            cases += [dict(kind="simple", grid=grid, model=simple, channels=x_simple),
                      dict(kind="fpn", grid=grid, model=fpn, channels=x_fpn)]
        if n == 4:
            keys += [("oneshot", (4, 1)), ("render_denoise", (4, 1))]
            cases += [dict(kind="oneshot", grid=(4, 1), model=simple, channels=x_simple,
                           halo=5),
                      dict(kind="render_denoise", grid=(4, 1), scene=cornell_box(),
                           cam=Camera.create(), cfg=RENDER, simple=simple, fpn=[fpn])]
        by_rank = launch(run_cases, n, cases, device="cpu")
        for i, key in enumerate(keys):
            out[key] = [r[i] for r in by_rank]
    return out


def _full(spec, x):
    with torch.no_grad():
        return build_model(spec)(torch.as_tensor(x)[None])[0].numpy()


def _jax_mesh(grid):
    return jax_make_mesh(tiles=grid[0], samples=grid[1],
                         devices=jax.devices()[: grid[0] * grid[1]])


def _same_on_every_rank(results):
    for r in results[1:]:
        np.testing.assert_array_equal(r.numpy(), results[0].numpy())


@pytest.mark.parametrize("grid", ALL_GRIDS)
def test_simple_sharded_equals_full_frame(nets, worlds, grid):
    params, _, simple, _ = nets
    x, _ = _inputs()
    results = worlds["simple", grid]
    _same_on_every_rank(results)
    out = results[0].numpy()
    np.testing.assert_allclose(out, _full(simple, x), rtol=1e-5, atol=1e-5)
    from pathtrace_tpu.models.simple_cnn import SimpleDenoiseCNN

    ref = jax_denoise_spatially(jnp.asarray(x), _jax_mesh(grid), params=params,
                                model=SimpleDenoiseCNN())
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-4)


def test_one_shot_input_halo_would_diverge(nets, worlds):
    """The whole net applied once to a 5-row input halo differs from the
    whole frame at the slab boundaries: the exchange must be per layer."""
    _, _, simple, _ = nets
    x, _ = _inputs()
    out = worlds["oneshot", (4, 1)][0].numpy()
    assert not np.allclose(out, _full(simple, x), atol=1e-5)


def _unjoined_mesh(tiles):
    return Mesh({"tiles": tiles, "samples": 1}, 0, 0, 0, None, None, None, torch.device("cpu"))


def test_indivisible_height_raises():
    with pytest.raises(ValueError, match="not divisible"):
        shard_rows(torch.zeros((60, 64, 14)), _unjoined_mesh(8))


@pytest.mark.parametrize("grid", ALL_GRIDS)
def test_fpn_sharded_equals_full_frame(nets, worlds, grid):
    _, variables, _, fpn = nets
    _, x = _inputs()
    results = worlds["fpn", grid]
    _same_on_every_rank(results)
    out = results[0].numpy()
    np.testing.assert_allclose(out, _full(fpn, x), rtol=1e-5, atol=2e-5)
    ref = jax_denoise_fpn_sharded(jnp.asarray(x), _jax_mesh(grid), variables)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-4)


def test_fpn_constraint_raises(nets):
    """H must divide by 8 t, H and W by 64 (tests/test_spatial.py:94)."""
    _, _, _, fpn = nets
    model = build_model(fpn)
    with pytest.raises(ValueError, match="needs"):
        denoise_fpn_sharded(torch.zeros((6, 64, 14)), _unjoined_mesh(8), model)
    with pytest.raises(ValueError, match="needs"):
        denoise_fpn_sharded(torch.zeros((12, 48, 14)), _unjoined_mesh(4), model)


def test_rendered_slabs_into_both_denoisers(nets, worlds):
    """The frame goes from the grid's render through the preprocessing into
    both CNNs as slabs, never gathered on the way; each output is the whole
    frame's forward."""
    _, _, simple, fpn = nets
    results = worlds["render_denoise", (4, 1)]
    frame = results[0]["frame"].numpy()
    ref = render_channels(cornell_box(), Camera.create(), RENDER, device="cpu").numpy()
    np.testing.assert_allclose(frame[..., :10], ref[..., :10], rtol=1e-4, atol=1e-4)
    for c in range(10, 14):
        scale = max(np.abs(ref[..., c]).max(), 1e-3)
        np.testing.assert_allclose(frame[..., c] / scale, ref[..., c] / scale, atol=2e-3)
    for r in results[1:]:
        for k in ("frame", "input", "simple"):
            np.testing.assert_array_equal(r[k].numpy(), results[0][k].numpy())
        np.testing.assert_array_equal(r["fpn"][0].numpy(), results[0]["fpn"][0].numpy())
    x = preprocess_channels(torch.from_numpy(frame)).numpy()
    np.testing.assert_array_equal(results[0]["input"].numpy(), x)
    np.testing.assert_allclose(results[0]["fpn"][0].numpy(), _full(fpn, x), rtol=1e-5, atol=2e-5)
    # The preprocessed colour reaches 1 / 0.00316 where the albedo is 0 (the
    # light), so the simple net's outputs are not O(1) here: its atol is
    # scaled by the largest output. The FPN clips its output to [0, 1].
    ref = _full(simple, x)
    np.testing.assert_allclose(results[0]["simple"].numpy(), ref, rtol=1e-5,
                               atol=1e-5 * max(1.0, float(np.abs(ref).max())))
