"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device, builds the kernels from
``pathtrace_tpu_torch/csrc/`` with nvcc (one nvcc a source, all at once),
and runs eight phases, each printing its own lines; any failure raises and
exits non-zero.

1. Environment: the card's name and power limit, torch's CUDA version, nvcc
   and Triton versions.
2. A clean build of the kernel libraries (trace and grad), timed.
3. The trace kernel against its plain PyTorch version on the card, at
   128x64 and 4 spp with row and sample offsets, for diffuse, NEE and glossy
   in the 14-, 22- and 3-channel modes. Every channel is held to the rules
   of ``trace_kernel.agreement``: albedo equal on >= 99.9% of pixels;
   colour (1e-3), normal (2e-6), depth (rtol 5e-4) and each variance or
   Welford (n, mean, M2) channel (1e-3 of its range) out of tolerance on
   <= 1%.
4. The render path: the CLI renders the default frame (512x512, 4 spp, 5
   bounces) on cuda:0 through the kernel; the EXR and 8 bitmaps are read
   back and all 14 channels are held against the plain version, same rules.
5. Timing: median of 10 CUDA-event-timed runs after warm-up, kernel and
   plain version, at 512x512x4 spp and 512x512x32 spp.
6. The grad kernel's three modes against their plain versions on the card
   at 128x64 and 4 spp (the dump also at row offset 16 and sample offset
   5), under ``grad_kernel.agreement``: gradient sums and loss within rtol
   1e-4 plus 1e-8 of the largest; mean colour under the colour rule above;
   accumulators off by more than 1e-3 of their channel's range on <= 1% of
   pixels. Then the modes against each other (fused = dump + contraction =
   replay, same rule as the sums), and two fused launches that must give
   the same bits.
7. The gradient paths at full size, each with every launch count set to 0
   just before and read just after: (a) the albedo recovery of
   scripts/inverse_demo.py (256x256, 8 spp a step, target at 64 spp, 400
   Adam steps at lr 2e-2, all 9 albedos corrupted) through
   ``inverse.make_inverse_step`` as that script drives it, which must launch
   the dump kernel twice a step, keep every loss finite and end with the mean albedo error below
   half the corrupted one; (b) ``grad.render_loss_grads`` at 512x512x32
   spp through the fused kernel, whose loss must equal the mean squared
   error of the trace kernel's colour (rtol 1e-4); (c)
   ``grad_kernel.render_color_grads`` at the same frame, against the MSE
   cotangent, whose gradients must equal (b)'s under the sums rule.
8. Timing of the gradient kernels against their plain versions: fused at
   512x512x32 and 512x512x4 spp and replay at 512x512x32 (the kernel: median
   of 20 CUDA-event-timed runs after warm-up, in two turns; the plain
   versions, which take ~1 s a call at 32 spp: median of 2), the dump and
   the cross-estimator loss and gradients of one inverse step
   (``grad_kernel.cross_grads``, the step's own path) at 256x256x8, and the
   whole inverse step (kernel only). The last kernel output of each line is
   held against the last plain one under phase 6's rules (fused: sums and
   colour; replay: sums; dump: colour and accumulators; cross-estimator:
   loss and gradients as sums), so the kernels are also checked at the main
   paths' shapes, where the second pass sums thousands of block partials.
   The kernels line's max_abs_err is the largest of phases 6 and 8.

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
PLAIN_ITERS = 1  # per block of the plain/kernel/kernel/plain turns
INVERSE_STEPS = 400


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


# (mode, name in the kernels line, the TPU kernel it replaces)
GRAD_KERNELS = (
    ("fused", "grad_kernel[fused]", "pathtrace_tpu/ops/pallas_grad.py:326"),
    ("dump", "grad_kernel[dump]", "pathtrace_tpu/ops/pallas_grad.py:326"),
    ("replay", "grad_kernel[replay]", "pathtrace_tpu/ops/pallas_grad.py:70"),
)


def grad_compare(label, got, ref, kind):
    """Hold ``got`` against ``ref`` under ``grad_kernel.agreement``, print one
    line per check and raise on a breach. -> max |got - ref|."""
    from pathtrace_tpu_torch.ops.grad_kernel import agreement

    checks, max_err = agreement(got, ref, kind)
    for name, share, ceiling, ok in checks:
        print(f"  {label}: {name:6s} off on {share:.5f} (<= {ceiling}) {'ok' if ok else 'FAIL'}")
    print(f"  {label}: max |diff| {max_err:.6g}")
    failed = [name for name, _, _, ok in checks if not ok]
    if failed:
        raise RuntimeError(f"disagreement: {label}: {failed}")
    return max_err


def flat_grads(d_e, d_c):
    """(d emission [N, 3], d albedo [N, 3]) -> [6N] in the kernel's layout."""
    import torch

    return torch.cat([d_e, d_c], dim=1).reshape(-1)


def grad_phase_6(dev, scene, cam, gk, tk):
    """The grad kernel's modes against their plain versions and each other."""
    import torch
    from pathtrace_tpu_torch import RenderConfig

    phase(6, "grad kernel vs plain on the card (128x64, 4 spp; the dump also at row "
             "offset 16, sample offset 5)")
    sb = scene.packed()
    cfg = RenderConfig(width=128, height=64, spp=4)
    cb = tk.camera_block(cam, cfg)
    seed = tk.make_seed_block(cfg, 3)
    kw = dict(local_h=64, spp=4, device=dev)
    target = torch.from_numpy(
        np.random.default_rng(0).uniform(size=(64, 128, 3)).astype(np.float32)).to(dev)
    err = {}

    before = gk.CUDA_KERNEL.launches["fused"]
    sums_f, color_f = gk.fused(sb, cb, seed, cfg, target, **kw)
    torch.cuda.synchronize()
    if gk.CUDA_KERNEL.launches["fused"] != before + 1:
        raise RuntimeError("the fused launch counter did not move")
    ref_sums, ref_color = gk.fused_plain(sb, cb, seed, cfg, target, **kw)
    err["fused"] = max(grad_compare("fused/sums", sums_f, ref_sums, "sums"),
                       grad_compare("fused/colour", color_f, ref_color, "color"))
    again, _ = gk.fused(sb, cb, seed, cfg, target, **kw)
    torch.cuda.synchronize()
    if not torch.equal(again, sums_f):
        raise RuntimeError("two fused launches gave different bits")
    print("  fused, launched twice: identical bits")

    cfg_d = RenderConfig(width=128, height=96, spp=4)
    cb_d = tk.camera_block(cam, cfg_d)
    seed_d = tk.make_seed_block(cfg_d, 0, 5, 16)
    color_d, acc_d = gk.dump(sb, cb_d, seed_d, cfg_d, **kw)
    torch.cuda.synchronize()
    ref_color_d, ref_acc_d = gk.dump_plain(sb, cb_d, seed_d, cfg_d, **kw)
    err["dump"] = max(grad_compare("dump/colour", color_d, ref_color_d, "color"),
                      grad_compare("dump/acc", acc_d, ref_acc_d, "acc"))

    # Replay against the MSE cotangent of the fused frame (1/spp folded in).
    ct = (2.0 * (color_f - target) / cfg.spp).contiguous()
    sums_r = gk.replay(sb, cb, seed, cfg, ct, **kw)
    torch.cuda.synchronize()
    ref_r = gk.replay_plain(sb, cb, seed, cfg, ct, **kw)
    err["replay"] = grad_compare("replay/sums", sums_r, ref_r, "sums")

    # The modes against each other on one frame: the same gradient sums.
    color_0, acc_0 = gk.dump(sb, cb, seed, cfg, **kw)
    contracted = flat_grads(*gk.contract(2.0 * (color_0 - target), acc_0))
    grad_compare("dump+contraction vs fused", contracted, sums_f[:-1], "sums")
    grad_compare("replay vs fused", sums_r[:-1], sums_f[:-1], "sums")
    return err


def grad_phase_7(dev, scene, cam, gk, tk):
    """The gradient paths at full size through the user entry points."""
    import dataclasses

    import torch
    from pathtrace_tpu_torch import RenderConfig, grad, inverse, render_aovs
    from pathtrace_tpu_torch.scene import Scene

    def zero_counts():
        tk.CUDA_KERNEL.launches = 0
        for mode in gk.MODES:
            gk.CUDA_KERNEL.launches[mode] = 0

    phase(7, f"gradient paths at full size on cuda:0: (a) albedo recovery 256x256, 8 spp, "
             f"{INVERSE_STEPS} Adam steps; (b) fused loss+grads and (c) replay at 512x512x32")
    true_color = scene.color.numpy()
    bad = np.clip(true_color + np.random.default_rng(0).uniform(-0.35, 0.35, (9, 3)),
                  0.05, 0.95).astype(np.float32)
    corrupted = Scene(scene.radius, scene.position, scene.emission, bad)
    launches = {}

    cfg = RenderConfig(width=256, height=256, spp=8)
    zero_counts()
    t0 = time.perf_counter()
    target = render_aovs(scene, cam, dataclasses.replace(cfg, spp=64), frame=987654,
                         device=dev)["color"]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    # The first optimizer a process builds imports torch._dynamo (seconds).
    state, step_fn, _ = inverse.make_inverse_step(corrupted, cam, cfg, target, ("color",),
                                                  2e-2, device=dev)
    t2 = time.perf_counter()
    losses, step_ms = [], []
    for i in range(INVERSE_STEPS):
        before = gk.CUDA_KERNEL.launches["dump"]
        t_step = time.perf_counter()
        state, loss = step_fn(state)
        losses.append(float(loss))  # waits for the step
        step_ms.append(1e3 * (time.perf_counter() - t_step))
        if gk.CUDA_KERNEL.launches["dump"] != before + 2:
            raise RuntimeError(f"inverse step {i} launched the dump kernel "
                               f"{gk.CUDA_KERNEL.launches['dump'] - before} times, not 2")
    recovered = inverse.apply_params(corrupted.to(dev), state.params).color.detach().cpu()
    wall = time.perf_counter() - t0
    launches["dump"] = gk.CUDA_KERNEL.launches["dump"]
    err_before = float(np.abs(bad - true_color).mean())
    err_after = float(np.abs(recovered.numpy() - true_color).mean())
    print(f"(a) launches: dump {launches['dump']}, trace {tk.CUDA_KERNEL.launches}, "
          f"fused {gk.CUDA_KERNEL.launches['fused']}, replay {gk.CUDA_KERNEL.launches['replay']}")
    print(f"(a) loss {losses[0]:.6f} (step 1) -> {losses[-1]:.6f} (step {INVERSE_STEPS}); "
          f"mean |albedo error| {err_before:.4f} -> {err_after:.4f}")
    print(f"(a) wall {wall:.2f} s: target render {1e3 * (t1 - t0):.1f} ms, make_inverse_step "
          f"{1e3 * (t2 - t1):.1f} ms, {INVERSE_STEPS} steps {sum(step_ms):.1f} ms; host-clock "
          f"step: first {step_ms[0]:.3f} ms, median {statistics.median(step_ms):.3f} ms, "
          f"max after the first {max(step_ms[1:]):.3f} ms")
    if not np.all(np.isfinite(losses)):
        raise RuntimeError("an inverse step gave a non-finite loss")
    if not err_after < 0.5 * err_before:
        raise RuntimeError(f"albedo error {err_after:.4f} is not below half of {err_before:.4f}")

    cfg = RenderConfig(width=512, height=512, spp=32)
    target = render_aovs(scene, cam, dataclasses.replace(cfg, spp=64), frame=987654,
                         device=dev)["color"]
    zero_counts()
    loss, (d_scene, d_cam) = grad.render_loss_grads(corrupted, cam, cfg, 0, target, device=dev)
    torch.cuda.synchronize()
    launches["fused"] = gk.CUDA_KERNEL.launches["fused"]
    print(f"(b) launches: fused {launches['fused']}, dump {gk.CUDA_KERNEL.launches['dump']}, "
          f"replay {gk.CUDA_KERNEL.launches['replay']}, trace {tk.CUDA_KERNEL.launches}")
    color = tk.render_color_sums(corrupted, cam, cfg, 0, device=dev) / cfg.spp
    mse = torch.mean((color - target) ** 2)
    print(f"(b) loss {float(loss):.8f}, MSE of the trace kernel's colour {float(mse):.8f}")
    grads = flat_grads(d_scene.emission, d_scene.color)
    zeros = [d_scene.position, d_scene.radius, d_cam.position, d_cam.yaw, d_cam.pitch]
    if not (torch.isfinite(grads).all() and float(grads.abs().max()) > 0):
        raise RuntimeError("fused gradients are not finite or all zero")
    if any(bool(z.any()) for z in zeros):
        raise RuntimeError("geometry or camera gradients are not exactly zero")
    if abs(float(loss) - float(mse)) > 1e-4 * abs(float(mse)):
        raise RuntimeError("the fused loss is not the MSE of the rendered colour")

    zero_counts()
    denom = cfg.height * cfg.width * 3
    d_e, d_c = gk.render_color_grads(corrupted, cam, cfg, 0, 2.0 * (color - target) / denom,
                                     device=dev)
    torch.cuda.synchronize()
    launches["replay"] = gk.CUDA_KERNEL.launches["replay"]
    print(f"(c) launches: replay {launches['replay']}, fused {gk.CUDA_KERNEL.launches['fused']}, "
          f"dump {gk.CUDA_KERNEL.launches['dump']}")
    grad_compare("(c) replay vs (b) fused", flat_grads(d_e, d_c), grads, "sums")
    for mode, n in launches.items():
        if n < 1:
            raise RuntimeError(f"the {mode} path did not launch its kernel")
    return launches


def plain_cross_grads(gk, tk, scene, cam, cfg, step, target, device):
    """``grad_kernel.cross_grads`` with the dump's plain version."""
    sb, cb, _ = tk.host_blocks(scene, cam, cfg, device)
    kw = dict(local_h=cfg.height, spp=cfg.spp, device=device)
    a, acc_a = gk.dump_plain(sb, cb, tk.make_seed_block(cfg, 2 * step), cfg, **kw)
    b, acc_b = gk.dump_plain(sb, cb, tk.make_seed_block(cfg, 2 * step + 1), cfg, **kw)
    return gk.cross_contract(a, acc_a, b, acc_b, target)


def grad_phase_8(dev, scene, cam, gk, tk):
    """Kernel and plain times of the gradient kernels at the paths' shapes,
    and the last output of each held against the last of its plain version.
    -> ({(mode, "kernel" or "plain"): ms}, {mode: max |kernel - plain|})."""
    import torch
    from pathtrace_tpu_torch import RenderConfig, inverse
    from pathtrace_tpu_torch.utils.timing import time_fn

    phase(8, f"grad timing (kernel: median of {2 * TIMING_ITERS} CUDA-event-timed runs; "
             f"plain: median of {2 * PLAIN_ITERS}; turns plain, kernel, kernel, plain), and "
             f"each kernel's last output against its plain version's")
    sb = scene.packed()
    out, err = {}, {}

    def turns(label, kernel_fn, plain_fn):
        ms = {"kernel": [], "plain": []}
        last = {}
        for name in ("plain", "kernel", "kernel", "plain"):
            fn = kernel_fn if name == "kernel" else plain_fn
            iters = TIMING_ITERS if name == "kernel" else PLAIN_ITERS
            t, last[name] = time_fn(fn, warmup=2 if name == "kernel" else 1, iters=iters,
                                    device=dev)
            ms[name].extend(t)
        med = {k: statistics.median(v) for k, v in ms.items()}
        print(f"{label}: kernel {med['kernel']:.4f} ms (runs {min(ms['kernel']):.4f}.."
              f"{max(ms['kernel']):.4f}), plain {med['plain']:.4f} ms (runs "
              f"{min(ms['plain']):.4f}..{max(ms['plain']):.4f}), plain/kernel "
              f"{med['plain'] / med['kernel']:.1f}")
        return med, last["kernel"], last["plain"]

    def held(mode, *errs):
        err[mode] = max(err.get(mode, 0.0), *errs)

    for spp in (32, 4):
        cfg = RenderConfig(width=512, height=512, spp=spp)
        cb = tk.camera_block(cam, cfg)
        seed = tk.make_seed_block(cfg)
        target = torch.full((512, 512, 3), 0.25, device=dev)
        kw = dict(local_h=512, spp=spp, device=dev)
        label = f"fused 512x512x{spp} spp x5"
        med, got, ref = turns(label, lambda: gk.fused(sb, cb, seed, cfg, target, **kw),
                              lambda: gk.fused_plain(sb, cb, seed, cfg, target, **kw))
        held("fused", grad_compare(f"{label}/sums", got[0], ref[0], "sums"),
             grad_compare(f"{label}/colour", got[1], ref[1], "color"))
        if spp == 32:
            out["fused", "kernel"], out["fused", "plain"] = med["kernel"], med["plain"]
            ct = torch.full((512, 512, 3), 1e-6, device=dev)
            label = "replay 512x512x32 spp x5"
            med, got, ref = turns(label, lambda: gk.replay(sb, cb, seed, cfg, ct, **kw),
                                  lambda: gk.replay_plain(sb, cb, seed, cfg, ct, **kw))
            held("replay", grad_compare(f"{label}/sums", got, ref, "sums"))
            out["replay", "kernel"], out["replay", "plain"] = med["kernel"], med["plain"]

    cfg = RenderConfig(width=256, height=256, spp=8)
    cb = tk.camera_block(cam, cfg)
    seed = tk.make_seed_block(cfg)
    kw = dict(local_h=256, spp=8, device=dev)
    label = "dump 256x256x8 spp x5"
    med, got, ref = turns(label, lambda: gk.dump(sb, cb, seed, cfg, **kw),
                          lambda: gk.dump_plain(sb, cb, seed, cfg, **kw))
    held("dump", grad_compare(f"{label}/colour", got[0], ref[0], "color"),
         grad_compare(f"{label}/acc", got[1], ref[1], "acc"))
    out["dump", "kernel"], out["dump", "plain"] = med["kernel"], med["plain"]
    target = torch.full((256, 256, 3), 0.25, device=dev)
    label = "cross-estimator loss+grads of one inverse step 256x256x8"
    _, got, ref = turns(label, lambda: gk.cross_grads(scene, cam, cfg, 0, target, device=dev),
                        lambda: plain_cross_grads(gk, tk, scene, cam, cfg, 0, target, dev))
    held("dump", grad_compare(f"{label}/loss+grads",
                              torch.cat([got[0][None], flat_grads(*got[1].values())]),
                              torch.cat([ref[0][None], flat_grads(*ref[1].values())]), "sums"))
    state, step_fn, _ = inverse.make_inverse_step(scene, cam, cfg, target, device=dev)
    ms, _ = time_fn(step_fn, state, warmup=2, iters=2 * TIMING_ITERS, device=dev)
    print(f"inverse step 256x256x8 (kernel path, Adam included): "
          f"{statistics.median(ms):.4f} ms (runs {min(ms):.4f}..{max(ms):.4f})")
    return out, err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box
    from pathtrace_tpu_torch import cli
    from pathtrace_tpu_torch.io.exr import load_aovs_exr
    from pathtrace_tpu_torch.ops import build
    from pathtrace_tpu_torch.ops import grad_kernel as gk
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
    print("nvcc: " + run([build.find_nvcc(), "--version"]).splitlines()[-1])
    try:
        import triton

        print(f"triton {triton.__version__}")
    except ImportError:
        print("triton: not installed")

    phase(2, "build")
    sources = (tk.SOURCE, gk.SOURCE)
    for src in sources:
        for old in build.BUILD_DIR.glob(f"lib{src.stem}-*.so"):
            old.unlink()
    t0 = time.perf_counter()
    libs = build.build_all(sources)
    build_s = time.perf_counter() - t0
    print(f"built {', '.join(lib.name for lib in libs.values())} in {build_s:.1f} s, "
          f"in parallel (flags: {' '.join(build.NVCC_FLAGS)})")

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

    grad_err = grad_phase_6(dev, scene, cam, gk, tk)
    grad_launches = grad_phase_7(dev, scene, cam, gk, tk)
    grad_times, grad_err_8 = grad_phase_8(dev, scene, cam, gk, tk)

    kernels = [{
        "name": "pathtrace_kernel",
        "route": "cuda",
        "source": "pathtrace_tpu_torch/csrc/trace_kernel.cu",
        "replaces": "pathtrace_tpu/ops/pallas_trace.py:361",
        "launches": launches,
        "max_abs_err": worst_err,
        "ms": statistics.median(times["kernel", 4]),
        "plain_ms": statistics.median(times["plain", 4]),
    }]
    for mode, name, replaces in GRAD_KERNELS:
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "pathtrace_tpu_torch/csrc/grad_kernel.cu",
            "replaces": replaces,
            "launches": grad_launches[mode],
            "max_abs_err": max(grad_err[mode], grad_err_8[mode]),
            "ms": grad_times[mode, "kernel"],
            "plain_ms": grad_times[mode, "plain"],
        })
    print(json.dumps({"kernels": kernels}))
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
