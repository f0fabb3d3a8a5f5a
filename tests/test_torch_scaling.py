"""The port's scaling harness and its JSON record, and the multi-device dry
run, on the CPU (tests/test_sharding.py:156-183 and ``__graft_entry__.
dryrun_multichip`` on the port).

Each world (gloo, ``device="cpu"``) is started once, in a module fixture.
The ranks of a CPU world share one device, so the harness is checked here,
not the hardware: a row of ranks that share a device carries no
efficiency, and the record's 80% gate is null with its reason, as on the
one H100 of the card's machine. The dry run's loss is held to the port's
single-device loss on the same frame (rtol 1e-5, tests/test_sharding.py's).
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box
from pathtrace_tpu_torch import grad as port_grad
from pathtrace_tpu_torch.parallel import scaling
from pathtrace_tpu_torch.parallel.dryrun import dryrun_multichip


@pytest.fixture(scope="module")
def record():
    """``python -m pathtrace_tpu_torch.parallel.scaling --json`` on a CPU world
    of 2 ranks -> its JSON record (the last line it prints)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert scaling.main(["--device", "cpu", "--ranks", "2", "--size", "32", "--spp", "4",
                             "--backend", "torch", "--iters", "1", "--json"]) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def dryruns():
    return {n: dryrun_multichip(n, device="cpu") for n in (2, 4)}


def test_scaling_cli_json_record(record):
    """The one-command efficiency record: parseable, one row a grid of the
    first 1 and 2 ranks, and the gate null with its reason on one device."""
    assert record["backend"] == "cpu" and record["world_backend"] == "gloo"
    assert record["num_ranks"] == 2 and record["num_devices"] == 1
    assert [r["ranks"] for r in record["results"]] == [1, 2]
    assert record["gate_80pct"] is None and "single device" in record["gate_reason"]


def test_scaling_harness_rows(record):
    """The rows of measure_scaling: the one-rank row has efficiency 1.0; the
    two ranks share the CPU, so theirs has none, and a note says why."""
    one, two = record["results"]
    assert one["efficiency"] == 1.0 and one["mesh"] == {"tiles": 1, "samples": 1}
    assert two["efficiency"] is None and two["note"] == scaling.SHARED_DEVICE_NOTE
    assert two["mesh"] == {"tiles": 2, "samples": 1}
    assert all(r["seconds"] > 0 and r["mrays"] > 0 for r in record["results"])


def test_measure_scaling_alone_is_one_row():
    """Without a world the harness times the one-rank grid."""
    cfg = RenderConfig(width=16, height=16, spp=2, backend="cuda", max_bounces=2)
    rows = scaling.measure_scaling(cornell_box(), Camera.create(), cfg, iters=1, device="cpu")
    assert len(rows) == 1 and rows[0]["ranks"] == 1 and rows[0]["efficiency"] == 1.0
    assert rows[0]["devices"] == scaling.distinct_devices(1, torch.device("cpu")) == 1


def test_scaling_main_needs_a_card_or_the_cpu():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device cpu"):
            scaling.main(["--json"])


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(dryruns, n):
    """One sharded render and one sharded loss+gradients step (diffuse and
    NEE) on a (n/2, 2) grid through the kernels' route (their plain
    versions on the CPU); every rank returns the same loss, which is the
    single-device loss of the same frame."""
    results = dryruns[n]
    tiles = n // 2
    assert [r["rank"] for r in results] == list(range(n))
    cfg = RenderConfig(width=32, height=8 * tiles, spp=4, backend="cuda", max_bounces=2)
    loss, (d_scene, _) = port_grad.render_loss_grads(cornell_box(), Camera.create(), cfg, 0,
                                                     device="cpu")
    for r in results:
        assert r["mesh"] == {"tiles": tiles, "samples": 2}
        assert r["frame_shape"] == (cfg.height, cfg.width, 14)
        assert r["loss"] == results[0]["loss"] and r["loss_nee"] == results[0]["loss_nee"]
        np.testing.assert_array_equal(r["d_color"].numpy(), results[0]["d_color"].numpy())
    np.testing.assert_allclose(results[0]["loss"], float(loss), rtol=1e-5)
    np.testing.assert_allclose(results[0]["d_color"].numpy(), d_scene.color.numpy(),
                               rtol=1e-3, atol=1e-4 * float(d_scene.color.abs().max()))

