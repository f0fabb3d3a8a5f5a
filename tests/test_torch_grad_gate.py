"""The gradient gate's two phases on the port against the JAX package's, on
the CPU at Cornell 16x16 x 2 spp, NEE (``--fd-spp 2``).

A module fixture runs the JAX package's phase A (scripts/grad_oracle_cpu.py,
~70 s here) and the port's (scripts/torch_grad_oracle.py --device cpu). The
two files have the same keys and lattice stamp; on the JAX script's
decisions (``convert.decisions_from_npz``) the port's f64 blocks equal the
JAX script's within 1e-9 of each block's largest magnitude; the port's
phase B (scripts/torch_grad_gate.py --device cpu, the plain versions of
K2-K4) reads either oracle, refuses a mismatched stamp, and exits 0 only on
an overall PASS.
"""

import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box
from pathtrace_tpu_torch.convert import decisions_from_npz
from pathtrace_tpu_torch.ops import frozen

REPO = Path(__file__).resolve().parent.parent
SIZE, SPP = 16, 2
BLOCKS = ("d_radius", "d_position", "d_emission", "d_albedo", "d_cam_position", "d_cam_yaw",
          "d_cam_pitch")
STAMP = ("size", "spp", "fd_spp", "seed", "max_bounces", "brdf", "nee", "light_index",
         "spp_chunk", "n_chunks")
ROWS = ("d emission", "d albedo", "d position", "d radius", "d camera pos",
        "d camera yaw/pitch")


def load_script(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def oracles(tmp_path_factory):
    """{"jax": oracle.npz path, "port": oracle.npz path}, decisions.npz beside each."""
    root = tmp_path_factory.mktemp("oracles")
    size = ["--size", str(SIZE), "--spp", str(SPP), "--fd-spp", "2"]
    jax_out, port_out = root / "jax" / "oracle.npz", root / "port" / "oracle.npz"
    subprocess.run([sys.executable, str(REPO / "scripts" / "grad_oracle_cpu.py"), *size,
                    "--out", str(jax_out)], check=True, cwd=root, capture_output=True,
                   timeout=600)
    assert load_script("torch_grad_oracle").main([*size, "--out", str(port_out),
                                                  "--device", "cpu"]) == 0
    return {"jax": jax_out, "port": port_out}


def npz(path):
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def test_oracle_files_have_the_same_keys_and_stamp(oracles):
    for name in ("oracle.npz", "decisions.npz"):
        jax_files, port_files = (npz(oracles[k].parent / name) for k in ("jax", "port"))
        assert set(jax_files) == set(port_files), name
        for k, v in jax_files.items():
            assert port_files[k].dtype.kind == v.dtype.kind and port_files[k].shape == v.shape, k
            if k in STAMP:
                assert port_files[k].item() == v.item(), k
    recs, stamp = decisions_from_npz(oracles["port"].parent / "decisions.npz")
    assert stamp == {"size": SIZE, "spp": SPP, "seed": 0, "max_bounces": 5, "brdf": "diffuse",
                     "nee": True, "light_index": 8, "spp_chunk": 2}
    assert len(recs) == 1 and recs[0].idx.dtype == torch.int32


def test_port_f64_blocks_on_jax_decisions_match_jax(oracles):
    recs, stamp = decisions_from_npz(oracles["jax"].parent / "decisions.npz")
    cfg = RenderConfig(width=SIZE, height=SIZE, spp=SPP, backend="torch", nee=True,
                       spp_chunk=stamp["spp_chunk"])
    loss, (ds, dc) = frozen.replay_loss_grads(
        cornell_box(), Camera.create(), cfg, 0, recs, torch.zeros((SIZE, SIZE, 3)),
        dtype=torch.float64, device="cpu")
    want = npz(oracles["jax"])
    got = {"d_radius": ds.radius, "d_position": ds.position, "d_emission": ds.emission,
           "d_albedo": ds.color, "d_cam_position": dc.position, "d_cam_yaw": dc.yaw,
           "d_cam_pitch": dc.pitch}
    assert abs(float(loss) - float(want["loss_f64"])) <= 1e-9 * float(want["loss_f64"])
    for k in BLOCKS:
        ref = want[f"f64_{k}"]
        assert np.abs(got[k].double().numpy() - ref).max() <= 1e-9 * np.abs(ref).max(), k


def run_gate(oracle, out, capsys):
    """(exit code, report text, stdout) of the port's phase B on the CPU."""
    gate = load_script("torch_grad_gate")
    rc = gate.main(["--size", str(SIZE), "--spp", str(SPP), "--oracle", str(oracle),
                    "--out", str(out), "--device", "cpu"])
    return rc, out.read_text(), capsys.readouterr().out


@pytest.mark.parametrize("which", ["jax", "port"])
def test_gate_reads_either_oracle(oracles, which, tmp_path, capsys):
    rc, text, stdout = run_gate(oracles[which], tmp_path / "GATE.md", capsys)
    rows = [line for line in text.splitlines() if line.startswith("| d ")]
    for name in ROWS:
        row = [r for r in rows if r.startswith(f"| {name} |") and r.count("|") == 9]
        assert len(row) == 1, name
        assert row[0].endswith(("| PASS |", "| FAIL |"))
    assert "Record-point consistency:" in text and text in stdout
    verdict = "**Overall: PASS**" in text
    assert verdict != ("**Overall: FAIL**" in text)
    assert rc == (0 if verdict else 1)


def copy_oracle(oracle, dest, edit_file, **fields):
    """A copy of the oracle's two files with ``fields`` of ``edit_file`` replaced."""
    dest.mkdir()
    for name in ("oracle.npz", "decisions.npz"):
        shutil.copy(oracle.parent / name, dest / name)
    data = npz(dest / edit_file)
    data.update({k: np.array(v) for k, v in fields.items()})
    np.savez_compressed(dest / edit_file, **data)
    return dest / "oracle.npz"


@pytest.mark.parametrize("edit_file,fields", [
    ("oracle.npz", {"seed": 1}),
    ("oracle.npz", {"nee": False}),
    ("decisions.npz", {"seed": 7}),
    ("decisions.npz", {"spp_chunk": 1}),
], ids=["oracle-seed", "oracle-nee", "decisions-seed", "decisions-spp_chunk"])
def test_gate_refuses_a_mismatched_stamp(oracles, tmp_path, capsys, edit_file, fields):
    oracle = copy_oracle(oracles["port"], tmp_path / "o", edit_file, **fields)
    with pytest.raises(SystemExit) as exc:
        run_gate(oracle, tmp_path / "GATE.md", capsys)
    assert exc.value.code not in (0, None)
    assert list(fields)[0] in str(exc.value.code)
    assert not (tmp_path / "GATE.md").exists()


def test_gate_exit_code_follows_the_verdict(oracles, tmp_path, capsys):
    """A row that fails (an FD probe's gross error of 1) makes the overall
    verdict FAIL and the exit code 1."""
    gross = npz(oracles["port"])["fd_gross"].copy()
    gross[1] = 1.0
    oracle = copy_oracle(oracles["port"], tmp_path / "o", "oracle.npz", fd_gross=gross)
    rc, text, _ = run_gate(oracle, tmp_path / "GATE.md", capsys)
    assert rc == 1 and "**Overall: FAIL**" in text
    assert [line for line in text.splitlines() if line.startswith("| sphere6_pos_z |")][0] \
        .endswith("| FAIL |")
