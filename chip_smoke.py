"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device, builds the trace kernel from
``pathtrace_tpu_torch/csrc/trace_kernel.cu`` with nvcc, and runs five
phases, each printing its own lines; any failure raises and exits non-zero.

1. Environment: the card's name and power limit, torch's CUDA version, nvcc
   and Triton versions.
2. A clean build of the kernel library, timed.
3. The kernel against its plain PyTorch version on the card, at 128x64 and
   4 spp with row and sample offsets, for diffuse, NEE and glossy in the 14-,
   22- and 3-channel modes. Every channel is held to the rules of
   ``trace_kernel.agreement``: albedo equal on >= 99.9% of pixels; colour
   (1e-3), normal (2e-6), depth (rtol 5e-4) and each variance or Welford
   (n, mean, M2) channel (1e-3 of its range) out of tolerance on <= 1%.
4. The main path: the CLI renders the default frame (512x512, 4 spp, 5
   bounces) on cuda:0 through the kernel; the EXR and 8 bitmaps are read
   back and all 14 channels are held against the plain version, same rules.
5. Timing: median of 10 CUDA-event-timed runs after warm-up, kernel and
   plain version, at 512x512x4 spp and 512x512x32 spp.

The line before the last two is a JSON summary of the kernels, the next the
``nvidia-smi`` name and power limit, and the last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

CASES = {"diffuse": {}, "nee": {"nee": True}, "glossy": {"brdf": "glossy"}}
MODES = ("channels", "partials", "color")
TIMING_ITERS = 10


def run(cmd):
    """stdout of a command that must succeed."""
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed ({proc.returncode}): {proc.stderr.strip()}")
    return proc.stdout.strip()


def phase(n, title):
    print(f"== phase {n}: {title}", flush=True)


def compare(label, got, ref, mode, spp):
    """Hold ``got`` against ``ref`` on every channel and print one line per
    check; raise if any share is above its ceiling. -> max |got - ref|."""
    from pathtrace_tpu_torch.ops.trace_kernel import agreement

    checks, max_err = agreement(got, ref, mode, spp)
    for name, share, ceiling, ok in checks:
        print(f"  {label}: {name:14s} off on {share:.5f} of pixels (<= {ceiling}) "
              f"{'ok' if ok else 'FAIL'}")
    print(f"  {label}: max |diff| over all {got.shape[-1]} channels {max_err:.6g}")
    failed = [name for name, _, _, ok in checks if not ok]
    if failed:
        raise RuntimeError(f"kernel disagrees with the plain version: {label}: {failed}")
    return max_err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box
    from pathtrace_tpu_torch import cli
    from pathtrace_tpu_torch.io.exr import load_aovs_exr
    from pathtrace_tpu_torch.ops import trace_kernel as tk
    from pathtrace_tpu_torch.render import pack_channels
    from pathtrace_tpu_torch.utils.timing import mrays_per_sec, time_fn

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase(1, "environment")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    smi = smi.splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    print("nvcc: " + run([tk.find_nvcc(), "--version"]).splitlines()[-1])
    try:
        import triton

        print(f"triton {triton.__version__}")
    except ImportError:
        print("triton: not installed")

    phase(2, "build")
    for old in tk.BUILD_DIR.glob("libtrace_kernel-*.so"):
        old.unlink()
    t0 = time.perf_counter()
    lib = tk.build_library()
    build_s = time.perf_counter() - t0
    print(f"built {lib.name} in {build_s:.1f} s (flags: {' '.join(tk.NVCC_FLAGS)})")

    phase(3, "kernel vs plain on the card (128x64, 4 spp, row offset 16, sample offset 5)")
    # Scene and camera blocks on the host, as the render entry points build them.
    scene, cam = cornell_box(), Camera.create()
    sb = scene.packed()
    worst_err = 0.0
    for case, extra in CASES.items():
        cfg = RenderConfig(width=128, height=96, spp=4, **extra)
        cb = tk.camera_block(cam, cfg)
        seed = tk.make_seed_block(cfg, 0, 5, 16)
        for mode in MODES:
            kw = dict(local_h=64, spp=4, mode=mode, device=dev)
            before = tk.CUDA_KERNEL.launches
            got = tk.trace(sb, cb, seed, cfg, **kw)
            torch.cuda.synchronize()
            if tk.CUDA_KERNEL.launches != before + 1:
                raise RuntimeError("the launch counter did not move")
            ref = tk.trace_plain(sb, cb, seed, cfg, **kw)
            print(f"{case} {mode} ({tk.MODES[mode]} channels):")
            worst_err = max(worst_err, compare(f"{case}/{mode}", got, ref, mode, 4))

    phase(4, "main path: CLI single frame 512x512, 4 spp on cuda:0")
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        prefix = os.path.join(out_dir, "frame")
        tk.CUDA_KERNEL.launches = 0
        rc = cli.main(["--size", "512", "-s", "4", "--device", "0", "-o", prefix])
        launches = tk.CUDA_KERNEL.launches
        if rc != 0:
            raise RuntimeError(f"CLI exited {rc}")
        print(f"kernel launches on the main path: {launches}")
        if launches < 1:
            raise RuntimeError("the main path did not launch the kernel")
        aovs = load_aovs_exr(prefix + ".exr")
        n_ch = sum(v.shape[-1] if v.ndim == 3 else 1 for v in aovs.values())
        if n_ch != 14 or not all(np.isfinite(v).all() for v in aovs.values()):
            raise RuntimeError(f"EXR holds {n_ch} channels or non-finite values")
        bmps = [f for f in os.listdir(out_dir) if f.endswith(".bmp")]
        if len(bmps) != 8:
            raise RuntimeError(f"expected 8 bitmaps, found {sorted(bmps)}")
        print(f"EXR: 14 finite channels, 8 bitmaps; mean colour "
              f"{aovs['color'].mean():.4f}")
        cfg = RenderConfig(width=512, height=512, spp=4)
        ref = tk.trace_plain(sb, tk.camera_block(cam, cfg), tk.make_seed_block(cfg, 1), cfg,
                             local_h=512, spp=4, mode="channels", device=dev)
        got = pack_channels({k: torch.from_numpy(np.ascontiguousarray(v))
                             for k, v in aovs.items()})
        print("CLI frame (EXR) vs plain version:")
        worst_err = max(worst_err, compare("cli/channels", got, ref, "channels", 4))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    phase(5, f"timing (median of {TIMING_ITERS} CUDA-event-timed runs after warm-up)")
    times = {}
    for spp in (4, 32):
        cfg = RenderConfig(width=512, height=512, spp=spp)
        cb = tk.camera_block(cam, cfg)
        seed = tk.make_seed_block(cfg)
        for name, fn in (("plain", tk.trace_plain), ("kernel", tk.trace),
                         ("kernel", tk.trace), ("plain", tk.trace_plain)):
            # time_fn's device= is the timing device; the trace device is bound here.
            ms, _ = time_fn(functools.partial(fn, device=dev), sb, cb, seed, cfg, local_h=512,
                            spp=spp, mode="channels", warmup=2, iters=TIMING_ITERS, device=dev)
            times.setdefault((name, spp), []).extend(ms)
        for name in ("kernel", "plain"):
            med = statistics.median(times[name, spp])
            print(f"{name:6s} 512x512x{spp} spp x5: {med:.4f} ms/frame, "
                  f"{mrays_per_sec(512, 512, spp, 5, med / 1e3):.1f} Mrays/s "
                  f"(runs {min(times[name, spp]):.4f}..{max(times[name, spp]):.4f} ms)")

    print(json.dumps({"kernels": [{
        "name": "pathtrace_kernel",
        "route": "cuda",
        "source": "pathtrace_tpu_torch/csrc/trace_kernel.cu",
        "replaces": "pathtrace_tpu/ops/pallas_trace.py:361",
        "launches": launches,
        "max_abs_err": worst_err,
        "ms": statistics.median(times["kernel", 4]),
        "plain_ms": statistics.median(times["plain", 4]),
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        import pathtrace_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        sys.exit(1)
    sys.exit(main())
