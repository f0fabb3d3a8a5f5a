"""The port's CLI: flags, the single-frame render on the CPU, the denoised
frame (``-d``), the interactive frame writer (``-i``), and that the port
never imports JAX. The denoised colour is held to the port's
``denoise_channels`` on the raw frame's channels within 1e-5 (both are f32
forwards of one model on one buffer; the EXR stores f32)."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pathtrace_tpu import cli as jax_cli
from pathtrace_tpu.io.exr import load_aovs_exr, read_exr
from pathtrace_tpu_torch import cli
from pathtrace_tpu_torch.io.bmp import read_bmp
from pathtrace_tpu_torch.models import init_model
from pathtrace_tpu_torch.models.infer import denoise_channels
from pathtrace_tpu_torch.train import save_checkpoint
from test_torch_trace_kernel import assert_channels_close

REPO = Path(__file__).resolve().parents[1]


def _pack(aovs):
    return np.concatenate(
        [aovs["color"], aovs["normal"], aovs["albedo"]]
        + [aovs[k][..., None] for k in
           ("depth", "color_var", "normal_var", "albedo_var", "depth_var")],
        axis=-1,
    )


def test_defaults_match_reference():
    args = cli.build_parser().parse_args([])
    assert args.size == 512
    assert args.samples == 4
    assert args.threads_per_block == 8
    assert args.device == 0
    assert args.output == "output/out"
    assert (args.camera_x, args.camera_y, args.camera_z) == (50.0, 52.0, 295.6)
    assert (args.camera_yaw, args.camera_pitch) == (-90.0, 0.0)
    assert not args.denoising and not args.interactive and not args.nobitmap
    assert cli.build_parser().parse_args(["--device", "cpu"]).device == "cpu"


def test_single_frame_on_cpu_matches_jax_cli(tmp_path, capsys):
    out, ref = tmp_path / "port", tmp_path / "jax"
    flags = ["--size", "32", "-s", "2", "--nobitmap"]
    assert cli.main(flags + ["--device", "cpu", "-o", str(out)]) == 0
    assert "Render completed in" in capsys.readouterr().out
    assert jax_cli.main(flags + ["--backend", "jnp", "-o", str(ref)]) == 0
    got_raw, ref_raw = read_exr(str(out) + ".exr"), read_exr(str(ref) + ".exr")
    assert sorted(got_raw) == sorted(ref_raw)
    got, want = load_aovs_exr(str(out) + ".exr"), load_aovs_exr(str(ref) + ".exr")
    assert got["color"].shape == (32, 32, 3)
    assert_channels_close(_pack(got), _pack(want))
    assert not list(tmp_path.glob("*.bmp"))


def test_single_frame_writes_bitmaps(tmp_path):
    assert cli.main(["--size", "16", "-s", "1", "--device", "cpu", "-o",
                     str(tmp_path / "bm")]) == 0
    names = ("color", "normal", "albedo", "depth", "color_var", "normal_var",
             "albedo_var", "depth_var")
    for n in names:
        img = read_bmp(tmp_path / f"bm_{n}.bmp")
        assert img.shape == (16, 16, 3) and img.dtype == np.uint8
    assert read_bmp(tmp_path / "bm_albedo.bmp").max() > 0


def test_new_flags_match_the_jax_cli():
    args = cli.build_parser().parse_args([])
    want = jax_cli.build_parser().parse_args([])
    for flag in ("checkpoint", "frames", "viewer", "viewer_port", "metrics"):
        assert getattr(args, flag) == getattr(want, flag), flag
    assert args.checkpoint == "denoise_cnn_ckpt" and args.viewer_port == 8764


@pytest.mark.parametrize("mode", [[], ["-i", "--frames", "1"]], ids=["frame", "interactive"])
def test_denoise_without_a_checkpoint_exits_1(tmp_path, mode, capsys):
    rc = cli.main(["-d", *mode, "--size", "8", "-s", "1", "--device", "cpu", "--checkpoint",
                   str(tmp_path / "missing"), "-o", str(tmp_path / "out" / "x")])
    assert rc == 1
    err = capsys.readouterr().err
    assert err.startswith("ERROR: no denoiser checkpoint") and err.count("\n") == 1
    assert not (tmp_path / "out").exists()


def test_denoised_frame_on_cpu(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, init_model(torch.Generator().manual_seed(0), widths=(8, 16)))
    flags = ["--size", "24", "-s", "2", "--device", "cpu", "--nobitmap"]
    assert cli.main(flags + ["-o", str(tmp_path / "raw")]) == 0
    assert cli.main(flags + ["-d", "--checkpoint", ckpt, "-o", str(tmp_path / "den")]) == 0
    assert "Denoise completed in" in capsys.readouterr().out
    raw = load_aovs_exr(str(tmp_path / "raw.exr"))
    den = load_aovs_exr(str(tmp_path / "den.exr"))
    for k in raw:
        if k != "color":
            np.testing.assert_array_equal(den[k], raw[k])
    want = denoise_channels(torch.from_numpy(_pack(raw)), ckpt).numpy()
    np.testing.assert_allclose(den["color"], want, rtol=0, atol=1e-5)
    assert not np.allclose(den["color"], raw["color"], atol=1e-3)


def test_interactive_frames_on_cpu(tmp_path, capsys):
    metrics = tmp_path / "m.jsonl"
    assert cli.main(["-i", "--frames", "2", "--size", "16", "-s", "1", "--device", "cpu",
                     "-o", str(tmp_path / "run" / "out"), "--metrics", str(metrics)]) == 0
    frames = sorted((tmp_path / "run" / "frames").iterdir())
    assert [f.name for f in frames] == ["frame_00000.bmp", "frame_00001.bmp"]
    assert read_bmp(frames[0]).shape == (16, 16, 3)
    out = capsys.readouterr().out
    assert "Running in interactive mode: denoising is off" in out and "fps" in out
    assert len(metrics.read_text().splitlines()) == 2


@pytest.mark.parametrize("block", ["0", "17", "32"])
def test_block_edge_outside_the_kernels_bounds_is_refused(block, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.build_parser().parse_args(["-t", block])
    assert exc.value.code != 0
    assert "block edge must be 1..16" in capsys.readouterr().err


def test_no_cuda_without_device_cpu_exits_nonzero(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["--size", "8", "-o", str(tmp_path / "x")]) != 0
    assert "--device cpu" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import pathtrace_tpu_torch, pathtrace_tpu_torch.cli, pathtrace_tpu_torch.ops.trace_kernel\n"
        "import pathtrace_tpu_torch.convert, pathtrace_tpu_torch.utils.timing\n"
        "import pathtrace_tpu_torch.grad, pathtrace_tpu_torch.inverse, pathtrace_tpu_torch.train\n"
        "import pathtrace_tpu_torch.models, pathtrace_tpu_torch.models.infer\n"
        "import pathtrace_tpu_torch.progressive, pathtrace_tpu_torch.interactive\n"
        "import pathtrace_tpu_torch.viewer, pathtrace_tpu_torch.utils.debug\n"
        "import pathtrace_tpu_torch.utils.metrics, pathtrace_tpu_torch.io\n"
        "import pathtrace_tpu_torch.data, pathtrace_tpu_torch.data.loader\n"
        "import pathtrace_tpu_torch.data.collect, pathtrace_tpu_torch.data.patches\n"
        "import pathtrace_tpu_torch.io.native, pathtrace_tpu_torch.models.simple_cnn\n"
        "import pathtrace_tpu_torch.parallel, pathtrace_tpu_torch.parallel.mesh\n"
        "import pathtrace_tpu_torch.parallel.shard, pathtrace_tpu_torch.parallel.launch\n"
        "import pathtrace_tpu_torch.parallel.scaling, pathtrace_tpu_torch.parallel.selfcheck\n"
        "import pathtrace_tpu_torch.parallel.dryrun, pathtrace_tpu_torch.models.spatial\n"
        "import pathtrace_tpu_torch.models.fpn_spatial, pathtrace_tpu_torch.io.png\n"
        "import pathtrace_tpu_torch.bench\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'pathtrace_tpu.')) or m == 'pathtrace_tpu')\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    banned = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|pathtrace_tpu)(\.|\s|$)", re.M)
    # The port's scripts too, but the converter, which reads a JAX checkpoint
    # where JAX is installed.
    scripts = [p for p in (REPO / "scripts").glob("torch_*.py")
               if p.name != "torch_convert_checkpoint.py"]
    for path in [*(REPO / "pathtrace_tpu_torch").rglob("*.py"), *scripts]:
        assert not banned.search(path.read_text()), path
