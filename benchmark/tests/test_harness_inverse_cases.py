"""The glossy geometry cell and the albedo cell, on the CPU at a small size.

The glossy cell is in ``BENCHMARK.json``; the albedo cell's files are kept
outside it (its device time spread too widely for the bound, PERF.md §7) and
resolve all the same. In both a sound run reads ``correct`` true; a second window on
the run the first left one or two steps in (the harness's window for the
host's operations, with ``--trace 1``) keeps its checked steps; a step that leaves
the state unchanged, one that takes half the samples, and the bf16 control
(the reference in bf16 in the program's place) each read false; the box is
closed on the glossy cell's frames, so the segments its readers count are
the nominal W x H x spp x bounces.
"""

from __future__ import annotations

import dataclasses
import json
from types import SimpleNamespace

import pytest
import torch

from benchmark import common, harness
from benchmark.counts import ops
from benchmark.reference import camera as ref_camera
from benchmark.reference import glossy
from benchmark.tests.test_harness_faults import _inverse_plant

CPU = torch.device("cpu")
GLOSSY, ALBEDO = "cornell-glossy-nee.inverse_geometry", "cornell-diffuse.inverse_albedo"
SMALL = {GLOSSY: dict(width=16, height=16, spp=2), ALBEDO: dict(width=16, height=16, spp=2)}
SEED = 2**31 + 4242
SPEC = json.loads((common.ROOT / "BENCHMARK.json").read_text())


def run(cell, variant=None):
    return harness.run_cell(cell, SEED, 0.5, False, CPU, overrides=SMALL[cell], variant=variant)


def numbers(result):
    return {k: v["value"] for k, v in result["checks"].items()}


def test_glossy_cell_reports_the_inverse_metric():
    entry = next(w for w in SPEC["workloads"] if w["name"] == GLOSSY)
    assert entry["chips"] == 1
    config = next(c for c in SPEC["configs"] if c["name"] == entry["config"])
    assert config["reduced"] == []
    e2e, layer = harness.cell_metrics(SPEC, GLOSSY)
    assert {m["name"] for m in e2e} == {"inverse_device_ms", "setup_s"}
    assert {m["name"] for m in layer} == {"k4_roofline.glossy", "k1_roofline.glossy",
                                          "idle_share.glossy", "mfu.glossy",
                                          "host_step_ms.glossy"}
    assert all(m["moves"] == "inverse_device_ms" for m in layer)


@pytest.mark.parametrize("cell", [GLOSSY, ALBEDO])
def test_cell_resolves(cell):
    workload = common.load_json("workloads", cell)
    assert common.load_json("configs", workload["config"])["name"] == workload["config"]
    driver = harness.load_driver(workload["driver"])
    for fn in ("setup", "window", "end_to_end", "work", "check"):
        assert callable(getattr(driver, fn))
    assert all(v is not None for v in workload["limits"].values())
    if cell == ALBEDO:  # the readers a benchmark PR gives the cell
        for name in ("k2_roofline.albedo", "idle_share.albedo", "mfu.albedo",
                     "host_step_ms.albedo"):
            assert callable(harness.load_reader(name))


def test_glossy_cell_renders_glossy():
    config = common.load_json("configs", "cornell-glossy-nee")
    assert config["render"]["brdf"] == "glossy" and config["render"]["nee"]
    assert (config["render"]["width"], config["inverse"]["spp"]) == (512, 32)


@pytest.mark.parametrize("cell", [GLOSSY, ALBEDO])
def test_sound_run_is_correct(cell):
    r = run(cell)
    assert r["correct"], numbers(r)
    assert r["attempted"] >= 3 and r["failed"] == 0


@pytest.mark.parametrize("cell", [GLOSSY, ALBEDO])
def test_a_window_takes_a_run_one_or_two_steps_in(cell):
    workload = common.load_json("workloads", cell)
    driver = harness.load_driver(workload["driver"])
    ctx = SimpleNamespace(workload=workload, config=common.load_json("configs", workload["config"]),
                          traffic=workload["traffic"], seed=SEED, device=CPU, tmp=None,
                          overrides=SMALL[cell])
    state = driver.setup(ctx)
    for taken in (1, 2):
        st, step_fn, opt = state["start"]()
        for _ in range(taken):
            st, _ = step_fn(st)
        state["run"] = (st, step_fn, opt)
        record = driver.window(state, 0.0)
        assert record["kept"] is not None and len(record["kept"]["losses"]) == 3


@pytest.mark.parametrize("cell", [GLOSSY, ALBEDO])
def test_bf16_control_fails(cell):
    assert not run(cell, "bf16")["correct"]


def _broken(cell, monkeypatch, **plant):
    sound = run(cell)
    _inverse_plant(monkeypatch, **plant)
    bad = run(cell)
    monkeypatch.undo()
    assert not bad["correct"], numbers(bad)
    # the fault reads at least ten times what the sound run reads, in some number
    assert any(numbers(bad)[k] > 10 * max(numbers(sound)[k], 1e-9) for k in numbers(bad))


@pytest.mark.parametrize("cell", [GLOSSY, ALBEDO])
def test_state_unchanged_fails(cell, monkeypatch):
    taken = [0]

    def wrap_step(step_fn):
        def step(state):
            taken[0] += 1
            if taken[0] <= 3:  # set-up's warm-up
                return step_fn(state)
            new, loss = step_fn(state._replace(params={k: v.detach().clone().requires_grad_(True)
                                                       for k, v in state.params.items()}))
            return state._replace(step=new.step), loss
        return step

    _broken(cell, monkeypatch, wrap_step=wrap_step)


@pytest.mark.parametrize("cell", [GLOSSY, ALBEDO])
def test_half_the_samples_fails(cell, monkeypatch):
    def wrap_grads(real):
        def grads(scene, cam, cfg, step, target, device=None):
            return real(scene, cam, dataclasses.replace(cfg, spp=max(cfg.spp // 2, 1)), step,
                        target, device)
        return grads

    _broken(cell, monkeypatch, wrap_grads=wrap_grads)


@pytest.mark.parametrize("pose", [(50.0, 52.0, 295.6, -90.0, 0.0)])
def test_no_glossy_path_escapes_the_box(pose):
    """Every glossy path hits at every bounce, so the traced segments are the
    nominal ones the readers use."""
    c = common.load_json("configs", "cornell-glossy-nee")
    p = ref_camera.Pose(pose[:3], pose[3], pose[4])
    fr = glossy.Frame(common.spheres(c), p.position, p.corner_rays(24, 24), 24, 24, 7, 3,
                      range(24), light=c["render"]["light_index"])
    assert ops.segments(fr, 4) == ops.nominal_segments(24, 24, 4, c["render"]["max_bounces"])
