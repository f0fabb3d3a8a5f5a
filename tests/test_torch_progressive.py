"""Progressive accumulation on the port, held to a monolithic render and to
the JAX package's ``ProgressiveRenderer`` on the same lattice.

Both routes of the port run here: ``"torch"`` (the wavefront) and
``"cuda"``, which on the CPU is the forward kernel's plain version in its
22-channel partials mode. Each is held to its own counterpart: the wavefront
to the JAX package's renderer (its ``"jnp"`` route), the kernel route to its
plain version's partials merged batch by batch, bit for bit, the check
chip_smoke.py makes on the card (the plain version is held to the Pallas
kernel in tests/test_torch_trace_kernel.py). Between the two routes a
sample's borderline hit decision can go either way: at 12 spp that moves
the colour of 0.6-1.0% of pixels by more than 1e-3 (measured at 24x24 and
64x64), so the routes are not held to each other here.

Tolerances: batched against monolithic rtol/atol 1e-3
(tests/test_progressive.py: float sums reassociate across batch splits); a
resumed renderer against an uninterrupted one rtol 1e-5; the port against
the JAX package the forward rules of tests/test_torch_trace_kernel.py
(albedo bit-equal, normals 2e-6 on 99% of pixels, depth rtol 5e-4, colour
and statistics 1e-3 on 99% of pixels).
"""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

from pathtrace_tpu import Camera as JaxCamera
from pathtrace_tpu import RenderConfig as JaxConfig
from pathtrace_tpu import cornell_box as jax_cornell_box
from pathtrace_tpu.progressive import ProgressiveRenderer as JaxProgressive
from pathtrace_tpu.progressive import render_high_spp as jax_render_high_spp

from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box
from pathtrace_tpu_torch.ops import trace_kernel as tk
from pathtrace_tpu_torch.progressive import (ProgressiveRenderer, merge_partials,
                                             render_high_spp)
from pathtrace_tpu_torch.render import finalize_aovs, pack_channels, render_aovs
from test_torch_trace_kernel import assert_channels_close

JAX_CFG = JaxConfig(width=24, height=24, spp=12, backend="jnp", seed=4)
BACKENDS = ("torch", "cuda")


def _cfg(backend):
    return RenderConfig(width=24, height=24, spp=12, seed=4, backend=backend)


def _packed(aovs):
    return pack_channels(aovs).numpy()


def _jax_packed(aovs):
    from pathtrace_tpu.render import pack_channels as jax_pack

    return np.asarray(jax_pack(aovs))


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's renderer on the splits the tests below use."""
    scene, cam = jax_cornell_box(), JaxCamera.create()
    split = JaxProgressive(scene, cam, JAX_CFG).accumulate(5).accumulate(4).accumulate(3)
    halves = JaxProgressive(scene, cam, JAX_CFG).accumulate(6).accumulate(6)
    high = jax_render_high_spp(scene, cam, JAX_CFG, total_spp=10, batch_spp=4)
    return {"5+4+3": _jax_packed(split.aovs()), "6+6": _jax_packed(halves.aovs()),
            "high": _jax_packed(high)}


@pytest.mark.parametrize("backend", BACKENDS)
def test_batched_equals_monolithic(backend, jax_refs):
    cfg = _cfg(backend)
    ref = render_aovs(cornell_box(), Camera.create(), cfg, device="cpu")
    prog = ProgressiveRenderer(cornell_box(), Camera.create(), cfg, device="cpu")
    prog.accumulate(5).accumulate(4).accumulate(3)
    out = prog.aovs()
    assert prog.samples_done == 12
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), ref[k].numpy(), rtol=1e-3, atol=1e-3,
                                   err_msg=k)
    if backend == "torch":
        assert_channels_close(_packed(out), jax_refs["5+4+3"])


def test_kernel_route_is_the_plain_partials_merged():
    """On ``"cuda"`` each batch is one partials launch at the batch's sample
    offset; on the CPU that launch is the plain version, so the renderer's
    output is the plain partials merged in batch order, to the bit."""
    cfg = _cfg("cuda")
    scene, cam = cornell_box(), Camera.create()
    prog = ProgressiveRenderer(scene, cam, cfg, frame=3, device="cpu")
    prog.accumulate(5).accumulate(4).accumulate(3)
    sb, cb = scene.packed(), tk.camera_block(cam, cfg)
    merged, offset = None, 0
    for spp in (5, 4, 3):
        part = tk.partials_from_block(tk.trace_plain(
            sb, cb, tk.make_seed_block(cfg, 3, offset), cfg, local_h=24, spp=spp,
            mode="partials", device="cpu"))
        merged = part if merged is None else merge_partials(*merged, *part)
        offset += spp
    want = finalize_aovs(*merged, 12)
    for k, v in prog.aovs().items():
        assert torch.equal(v, want[k]), k


@pytest.mark.parametrize("backend", BACKENDS)
def test_save_load_resume(tmp_path, backend, jax_refs):
    path = str(tmp_path / "prog.pkl")
    scene, cam = cornell_box(), Camera.create()
    a = ProgressiveRenderer(scene, cam, _cfg(backend), device="cpu")
    a.accumulate(6)
    a.save(path)
    b = ProgressiveRenderer.load(path, scene, cam, device="cpu")
    assert b.samples_done == 6 and b.cfg == a.cfg and b.frame == a.frame
    a.accumulate(6)
    b.accumulate(6)
    np.testing.assert_allclose(a.aovs()["color"].numpy(), b.aovs()["color"].numpy(), rtol=1e-5)
    if backend == "torch":
        assert_channels_close(_packed(b.aovs()), jax_refs["6+6"])
    with open(path, "rb") as f:
        state = pickle.load(f)
    assert set(state) == {"samples_done", "frame", "cfg", "sums", "moments"}


def test_a_jax_file_does_not_load(tmp_path):
    """The keys are shared, the configurations are not (tile_shape there,
    block here)."""
    path = str(tmp_path / "jax.pkl")
    JaxProgressive(jax_cornell_box(), JaxCamera.create(),
                   dataclasses.replace(JAX_CFG, width=8, height=8)).accumulate(1).save(path)
    with pytest.raises(TypeError, match="tile_shape"):
        ProgressiveRenderer.load(path, cornell_box(), Camera.create(), device="cpu")


@pytest.mark.parametrize("backend", BACKENDS)
def test_render_high_spp_with_checkpoint(tmp_path, backend, jax_refs):
    path = str(tmp_path / "gt.pkl")
    logs = []
    aovs = render_high_spp(cornell_box(), Camera.create(), _cfg(backend), total_spp=10,
                           batch_spp=4, checkpoint_path=path, logger=logs.append,
                           device="cpu")
    assert aovs["color"].shape == (24, 24, 3)
    assert logs == ["progressive: 4/10 spp", "progressive: 8/10 spp", "progressive: 10/10 spp"]
    if backend == "torch":
        assert_channels_close(_packed(aovs), jax_refs["high"])
    # Resume from a completed checkpoint: no extra work, same result.
    again = render_high_spp(cornell_box(), Camera.create(), _cfg(backend), total_spp=10,
                            batch_spp=4, checkpoint_path=path, device="cpu")
    np.testing.assert_array_equal(aovs["color"].numpy(), again["color"].numpy())


def test_no_samples_yet_raises():
    with pytest.raises(ValueError, match="no samples"):
        ProgressiveRenderer(cornell_box(), Camera.create(), _cfg("torch"), device="cpu").aovs()
