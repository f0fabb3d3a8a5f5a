"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device, builds the kernels from
``pathtrace_tpu_torch/csrc/`` with nvcc (one nvcc a source, all at once),
and runs fifteen phases, each printing its own lines; any failure raises and
exits non-zero.

1. Environment: the card's name and power limit, torch's CUDA version, nvcc
   and Triton versions.
2. A clean build of the five kernel libraries (trace, grad, NEE grad, the
   all-parameter backward and the f32 probes), timed.
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
9. The NEE grad kernel against its plain versions on the card at 128x64 and
   4 spp, also at row offset 16 and sample offset 5, under
   ``nee_grad_kernel.agreement``: every gradient sum within rtol 1e-4 plus
   1e-6 of the largest of its kind, colour under the colour rule. Then:
   the replay against the MSE cotangent equals fused (rtol 1e-4 plus 1e-4
   of the largest of the kind: another order of operations on sums that
   cancel); two fused launches give the same bits; the fused colour equals
   the trace kernel's NEE colour bit for bit; and a 32-spp replay, 160
   Kahan-compensated adds a geometry slot, must equal its plain version to
   the bit: the compiler kept the compensation as written.
10. The NEE gradient path at full size, launch counts set to 0 before each
   part and read after: (a) ``grad.render_loss_grads`` at 512x512x32 spp
   with NEE: exactly one fused launch, loss equal to the MSE of the trace
   kernel's colour (rtol 1e-4), non-zero position, radius and camera
   gradients; (b) the geometry recovery of scripts/inverse_demo.py through
   ``inverse.make_inverse_step``: 256x256, 16 spp, NEE, 400 Adam steps,
   sphere 6 displaced by (6, -4, 8) and shrunk 20%, learning rates 0.5 and
   0.1 decaying to x0.02, gradients masked to sphere 6, target at 64 spp;
   every step must launch the trace kernel twice and the NEE replay twice.
   The case's target, radius and whole position error both below 70% of
   their start, is printed as MET or NOT MET and does not stop the run:
   along the view axis (z) this estimator, whose silhouette terms are
   zero, does not pull the sphere back, on the kernel route and on
   autograd through the wavefront alike (PERF.md). What stops the run: the
   radius error or the position error across the view (x, y) not below
   70% of its start, a masked sphere that moved, a non-finite loss, or a
   whole position error more than a quarter above its start (a recovery
   that diverges).
11. The probe kernel's two probes against their plain versions: all six
   modes at 1 chain and FMA and multiply at 8 chains on varied inputs for
   64 steps, then at the shapes of the readings: FMA and multiply at 8
   chains on 16.8 M elements for 8,192 steps, ``fma`` at 1 chain on 8,192
   elements for 1,048,576 steps (the other five modes there for 2,048
   steps); within 1e-6 of the largest value. The plain runs at full depth
   are timed: the kernels line's ``plain_ms`` is for the kernel's own
   work. Then the card's readings through ``roofline.measure_f32_peak``
   and ``roofline.latency_probe``, then one line a kernel: time, launches
   on its main path, bound and share of it. A bound is traced segments
   (``roofline.count_segments``) x counted operations a segment (a
   multiply and an add count as two) over the card's published f32 peak,
   67 TFLOP/s with a fused multiply-add as two, or bytes over 3.35 TB/s,
   whichever gives more. ``bound_ms_unfused_measured`` is the same count
   over the multiply-only rate the probe measured in this run: the least
   time for a build without FMA contraction, which these kernels are.
12. Timing of the NEE grad kernel (fused and replay at 512x512x32, the
   cross-estimator and the whole NEE inverse step at 256x256x16) against
   the plain versions, each last kernel output held against the last plain
   one under phase 9's rules; the trace kernel's NEE colour pass beside
   them; and ``torch.profiler`` device times by kernel over 20 NEE inverse
   steps.

13. The all-parameter backward kernel (K4) against its plain version on the
   card at 128x64 and 4 spp, under ``nee_grad_kernel.agreement`` (every sum
   within rtol 1e-4 plus 1e-6 of the largest of its kind): diffuse and
   glossy, with and without NEE, against a colour cotangent, against
   cotangents in all ten channels (normal, albedo and depth included), and
   at row offset 16 and sample offset 2; two launches must give the same
   bits; one 32-spp launch; without NEE and colour-only the geometry and
   camera sums must be exactly 0; and on NEE diffuse with a colour-only
   cotangent K4 must equal the NEE kernel's replay bit for bit.
14. The glossy gradient paths at full width through the user entry points,
   launch counts set to 0 before each part and read after: (a)
   ``grad.render_loss_grads`` at 512x512x32 spp for glossy and for NEE
   glossy: exactly one colour-sum launch of the trace kernel and one K4
   launch each, loss and all gradients held against the plain route
   (``trace_plain`` colour, ``replay_plain``); (b)
   ``ad_grad_kernel.ad_loss_and_grads`` on the NEE diffuse frame of phase
   10 (a) beside the NEE kernel's fused mode: the same gradients within
   1e-4 of the largest of their kind; (c) the albedo recovery of phase 7
   (a) under the glossy BRDF for 100 Adam steps through
   ``inverse.make_inverse_step``: two trace and two K4 launches every step,
   the first three steps' losses (rtol 1e-2: the wavefront and the kernel
   send a few near-mirror paths different ways, and the cross-estimator is
   a small difference of products; 2.6e-3 was measured at step 1) and
   albedo gradients (rtol 2e-2 plus 2e-2 of the largest) equal to the
   autograd route's, every loss finite, and the mean albedo error lower at
   the end than at the start.
15. Timing of K4 (median of 20 CUDA-event-timed runs, the plain version
   twice) at 512x512x32 for glossy, NEE glossy and NEE diffuse (the NEE
   kernel's replay beside it) and at 256x256x8, each last output held
   against the plain version's; the glossy inverse step, with
   ``torch.profiler`` device times by kernel over 20 steps.

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


_T0 = time.perf_counter()


def phase(n, title):
    print(f"== phase {n} (at {time.perf_counter() - _T0:.0f} s): {title}", flush=True)


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


# ---- the NEE gradient path (phases 9, 10, 12) and the probes (phase 11) ------------

PUBLISHED_F32_FLOPS = 67e12  # NVIDIA H100 SXM data sheet, FMA counted as 2
PUBLISHED_BYTES_PER_S = 3.35e12
NEE_INVERSE_STEPS = 400


def nee_compare(label, got, ref, kind, cross=False):
    """Hold ``got`` against ``ref`` under ``nee_grad_kernel.agreement`` (its
    looser ``CROSS_ATOL`` where two orders of operations meet), print one
    line per check and raise on a breach. -> max |diff|."""
    from pathtrace_tpu_torch.ops import nee_grad_kernel as nk

    checks, max_err = nk.agreement(got, ref, kind, nk.CROSS_ATOL if cross else nk.SUMS_ATOL)
    line = ", ".join(f"{name} {share:.4f}" for name, share, _, _ in checks)
    print(f"  {label}: shares out of tolerance: {line}; max |diff| {max_err:.6g}")
    failed = [name for name, _, _, ok in checks if not ok]
    if failed:
        raise RuntimeError(f"disagreement: {label}: {failed}")
    return max_err


def nee_phase_9(dev, scene, cam, nk, tk):
    """The NEE grad kernel against its plain versions and its modes against
    each other. -> {mode: max |kernel - plain|}."""
    import torch
    from pathtrace_tpu_torch import RenderConfig

    phase(9, "NEE grad kernel vs plain on the card (128x64, 4 spp; also at row offset 16, "
             "sample offset 5; replay at 32 spp to the bit)")
    sb = scene.packed()
    target = torch.from_numpy(
        np.random.default_rng(0).uniform(size=(64, 128, 3)).astype(np.float32)).to(dev)
    err = {"fused": 0.0, "replay": 0.0}
    for height, seed_args in ((64, (3,)), (96, (0, 5, 16))):
        cfg = RenderConfig(width=128, height=height, spp=4, nee=True)
        cb = tk.camera_block(cam, cfg)
        seed = tk.make_seed_block(cfg, *seed_args)
        kw = dict(local_h=64, spp=4, device=dev)
        tag = "" if height == 64 else " @offsets"
        before = nk.CUDA_KERNEL.launches["fused"]
        fused_sums, color = nk.fused(sb, cb, seed, cfg, target, **kw)
        torch.cuda.synchronize()
        if nk.CUDA_KERNEL.launches["fused"] != before + 1:
            raise RuntimeError("the NEE fused launch counter did not move")
        ref, ref_color = nk.fused_plain(sb, cb, seed, cfg, target, **kw)
        err["fused"] = max(err["fused"],
                           nee_compare(f"fused{tag}/sums", fused_sums, ref, "sums"),
                           nee_compare(f"fused{tag}/colour", color, ref_color, "color"))
        ct = (2.0 * (color - target) / cfg.spp).contiguous()
        replayed = nk.replay(sb, cb, seed, cfg, ct, **kw)
        torch.cuda.synchronize()
        err["replay"] = max(err["replay"], nee_compare(
            f"replay{tag}/sums", replayed, nk.replay_plain(sb, cb, seed, cfg, ct, **kw), "sums"))
        nee_compare(f"replay (MSE cotangent) vs fused{tag}",
                    torch.cat([replayed[:-1], fused_sums[-1:]]), fused_sums, "sums", cross=True)
        if height == 64:
            k1 = tk.trace(sb, cb, seed, cfg, mode="color", **kw)
            if not torch.equal(color, k1 * tk._f32(1.0 / cfg.spp)):
                raise RuntimeError("the fused colour is not the trace kernel's")
            print("  fused colour == trace kernel's NEE colour sums / spp: identical bits")
            again, _ = nk.fused(sb, cb, seed, cfg, target, **kw)
            if not torch.equal(again, fused_sums):
                raise RuntimeError("two NEE fused launches gave different bits")
            print("  fused, launched twice: identical bits")

    cfg = RenderConfig(width=128, height=64, spp=32, nee=True)
    cb = tk.camera_block(cam, cfg)
    seed = tk.make_seed_block(cfg, 3)
    kw = dict(local_h=64, spp=32, device=dev)
    ct = ((target - 0.5) / 32).contiguous()
    got = nk.replay(sb, cb, seed, cfg, ct, **kw)
    ref = nk.replay_plain(sb, cb, seed, cfg, ct, **kw)
    err["replay"] = max(err["replay"], nee_compare("replay 32 spp/sums", got, ref, "sums"))
    if not torch.equal(got, ref):
        raise RuntimeError("the 32-spp replay is not its plain version to the bit: was the "
                           "Kahan compensation compiled away?")
    print("  replay 32 spp == plain version: identical bits (the compensation survived)")
    return err


def nee_phase_10(dev, scene, cam, gk, nk, tk):
    """The NEE gradient path at full size through the user entry points.
    -> ({mode: launches}, geometry errors)."""
    import dataclasses

    import torch
    from pathtrace_tpu_torch import RenderConfig, grad, inverse, render_aovs
    from pathtrace_tpu_torch.scene import Scene

    def zero_counts():
        tk.CUDA_KERNEL.launches = 0
        for k in (gk, nk):
            for mode in k.MODES:
                k.CUDA_KERNEL.launches[mode] = 0

    phase(10, f"NEE gradient path at full size on cuda:0: (a) fused loss+grads 512x512x32; "
              f"(b) geometry recovery 256x256, 16 spp, {NEE_INVERSE_STEPS} Adam steps")
    pos_true, rad_true = scene.position.numpy(), scene.radius.numpy()
    bad_pos, bad_rad = pos_true.copy(), rad_true.copy()
    bad_pos[6] += np.array([6.0, -4.0, 8.0], np.float32)
    bad_rad[6] *= 0.8
    corrupted = Scene(bad_rad, bad_pos, scene.emission, scene.color)
    launches = {}

    cfg = RenderConfig(width=512, height=512, spp=32, nee=True)
    target = render_aovs(scene, cam, dataclasses.replace(cfg, spp=64), frame=987654,
                         device=dev)["color"]
    zero_counts()
    loss, (d_scene, d_cam) = grad.render_loss_grads(corrupted, cam, cfg, 0, target, device=dev)
    torch.cuda.synchronize()
    launches["fused"] = nk.CUDA_KERNEL.launches["fused"]
    print(f"(a) launches: NEE fused {launches['fused']}, NEE replay "
          f"{nk.CUDA_KERNEL.launches['replay']}, trace {tk.CUDA_KERNEL.launches}, "
          f"product-chain {sum(gk.CUDA_KERNEL.launches.values())}")
    if (launches["fused"], nk.CUDA_KERNEL.launches["replay"], tk.CUDA_KERNEL.launches,
            sum(gk.CUDA_KERNEL.launches.values())) != (1, 0, 0, 0):
        raise RuntimeError("render_loss_grads under NEE is not exactly one fused launch")
    color = tk.render_color_sums(corrupted, cam, cfg, 0, device=dev) / cfg.spp
    mse = torch.mean((color - target) ** 2)
    print(f"(a) loss {float(loss):.8f}, MSE of the trace kernel's colour {float(mse):.8f}")
    if abs(float(loss) - float(mse)) > 1e-4 * abs(float(mse)):
        raise RuntimeError("the NEE fused loss is not the MSE of the rendered colour")
    for name, g in (("d position", d_scene.position), ("d radius", d_scene.radius),
                    ("d emission", d_scene.emission), ("d albedo", d_scene.color),
                    ("d eye", d_cam.position), ("d yaw", d_cam.yaw), ("d pitch", d_cam.pitch)):
        print(f"(a) {name}: max |g| {float(g.abs().max()):.6g}")
        if g.device != dev or not torch.isfinite(g).all() or not float(g.abs().max()) > 0:
            raise RuntimeError(f"{name} is not finite and non-zero on {dev}")

    cfg = RenderConfig(width=256, height=256, spp=16, nee=True)
    zero_counts()
    target = render_aovs(scene, cam, dataclasses.replace(cfg, spp=64), frame=987654,
                         device=dev)["color"]
    torch.cuda.synchronize()
    tk.CUDA_KERNEL.launches = 0
    pos_mask = torch.zeros(9, 1)
    pos_mask[6] = 1.0
    rad_mask = torch.zeros(9)
    rad_mask[6] = 1.0
    rates = {"position": inverse.exponential_decay(0.5, NEE_INVERSE_STEPS, 0.02),
             "radius": inverse.exponential_decay(0.1, NEE_INVERSE_STEPS, 0.02)}
    state, step_fn, _ = inverse.make_inverse_step(
        corrupted, cam, cfg, target, ("position", "radius"), rates,
        grad_mask={"position": pos_mask, "radius": rad_mask}, device=dev)
    losses, step_ms = [], []
    for i in range(NEE_INVERSE_STEPS):
        before = (tk.CUDA_KERNEL.launches, nk.CUDA_KERNEL.launches["replay"])
        t_step = time.perf_counter()
        state, loss = step_fn(state)
        losses.append(float(loss))  # waits for the step
        step_ms.append(1e3 * (time.perf_counter() - t_step))
        after = (tk.CUDA_KERNEL.launches, nk.CUDA_KERNEL.launches["replay"])
        if (after[0] - before[0], after[1] - before[1]) != (2, 2):
            raise RuntimeError(f"NEE inverse step {i} launched trace {after[0] - before[0]} and "
                               f"replay {after[1] - before[1]} times, not 2 and 2")
    launches["replay"] = nk.CUDA_KERNEL.launches["replay"]
    launches["trace"] = tk.CUDA_KERNEL.launches
    others = nk.CUDA_KERNEL.launches["fused"] + sum(gk.CUDA_KERNEL.launches.values())
    print(f"(b) launches: trace {launches['trace']}, NEE replay {launches['replay']}, "
          f"others {others}")
    if others:
        raise RuntimeError("the NEE inverse step launched another gradient kernel")
    rec = inverse.apply_params(corrupted.to(dev), state.params)
    pos_rec, rad_rec = rec.position.detach().cpu().numpy(), rec.radius.detach().cpu().numpy()
    off_start, off_end = bad_pos[6] - pos_true[6], pos_rec[6] - pos_true[6]
    errs = {"position": (float(np.linalg.norm(off_start)), float(np.linalg.norm(off_end))),
            "position across the view (x, y)": (float(np.linalg.norm(off_start[:2])),
                                                float(np.linalg.norm(off_end[:2]))),
            "radius": (float(abs(bad_rad[6] - rad_true[6])),
                       float(abs(rad_rec[6] - rad_true[6])))}
    frozen = np.arange(9) != 6
    if not (np.array_equal(pos_rec[frozen], pos_true[frozen])
            and np.array_equal(rad_rec[frozen], rad_true[frozen])):
        raise RuntimeError("a masked sphere moved")
    print(f"(b) loss {losses[0]:.6f} (step 1) -> {losses[-1]:.6f} (step {NEE_INVERSE_STEPS}); "
          f"sphere 6 position error {errs['position'][0]:.3f} -> {errs['position'][1]:.3f} "
          f"(offset {np.round(off_start, 2).tolist()} -> {np.round(off_end, 2).tolist()}), "
          f"radius error {errs['radius'][0]:.3f} -> {errs['radius'][1]:.3f}")
    print(f"(b) host-clock step: first {step_ms[0]:.3f} ms, median "
          f"{statistics.median(step_ms):.3f} ms, {NEE_INVERSE_STEPS} steps "
          f"{sum(step_ms):.1f} ms")
    if not np.all(np.isfinite(losses)):
        raise RuntimeError("an NEE inverse step gave a non-finite loss")
    met = all(errs[k][1] < 0.7 * errs[k][0] for k in ("position", "radius"))
    print(f"(b) the case's target (position and radius errors both below x0.7 of their start): "
          f"{'MET' if met else 'NOT MET'}: position "
          f"x{errs['position'][1] / errs['position'][0]:.3f}, radius "
          f"x{errs['radius'][1] / errs['radius'][0]:.3f}; offset along the view axis "
          f"{off_start[2]:.2f} -> {off_end[2]:.2f}")
    for name, (start, end) in errs.items():
        limit = 1.25 if name == "position" else 0.7
        print(f"(b) {name} error: {end:.3f} against {start:.3f}, x{end / start:.3f} "
              f"(the run stops at x{limit})")
        if not end < limit * start:
            raise RuntimeError(f"{name} error {end:.3f} is not below {limit} x {start:.3f}")
    return launches, errs


def probe_phase_11(dev, rf):
    """The probe kernel against its plain version, then the card's readings.
    -> (peaks, latencies, {probe: record})."""
    import torch
    from pathtrace_tpu_torch.utils.timing import time_fn

    phase(11, "f32 probes vs plain on the card, then the readings")
    rng = np.random.default_rng(0)
    x = torch.from_numpy((1.0 + 0.1 * rng.uniform(size=(64, 128))).astype(np.float32)).to(dev)
    a = torch.from_numpy((0.9999 + 1e-4 * rng.uniform(size=(64, 128))).astype(np.float32)).to(dev)
    err = {"peak": 0.0, "latency": 0.0}

    def held(probe, label, got, ref):
        d = float((got - ref).abs().max())
        tol = 1e-6 * float(ref.abs().max())
        print(f"  {label}: max |diff| {d:.3g} (<= {tol:.3g}) {'ok' if d <= tol else 'FAIL'}")
        if not d <= tol:
            raise RuntimeError(f"probe kernel disagrees with its plain version: {label}")
        err[probe] = max(err[probe], d)

    for mode in rf.LATENCY_MODES:
        held("latency", f"latency[{mode}] 1 chain, 64 steps, varied inputs",
             rf.latency_chain(x, a, mode, 2), rf.chain_plain(x, a, mode, 2, 1))
    for fma in (True, False):
        held("peak", f"peak[{'fma' if fma else 'mul'}] 8 chains, 64 steps, varied inputs",
             rf.peak_chain(x, a, fma, 2),
             rf.chain_plain(x, a, "fma" if fma else "mul", 2, rf.PEAK_CHAINS))

    # At the shapes of the readings, on their inputs: the kernel (median of 3
    # timed launches) and the plain version of the same work (one timed run).
    def at_depth(probe, mode, xs, as_, iters, chains):
        if probe == "peak":
            kernel_fn = lambda: rf.peak_chain(xs, as_, mode == "fma", iters)  # noqa: E731
        else:
            kernel_fn = lambda: rf.latency_chain(xs, as_, mode, iters)  # noqa: E731
        ms, got = time_fn(kernel_fn, warmup=1, iters=3, device=dev)
        pms, ref = time_fn(lambda: rf.chain_plain(xs, as_, mode, iters, chains), warmup=0,
                           iters=1, device=dev)
        held(probe, f"{probe}[{mode}] {chains} chain(s), {xs.numel()} elements, "
                    f"{iters * rf.INNER} steps (kernel {statistics.median(ms):.4f} ms, plain "
                    f"{pms[0]:.1f} ms)", got, ref)
        return statistics.median(ms), pms[0]

    rec = {}
    xs, as_ = rf.probe_inputs(rf.PEAK_GRID * 64, dev)
    for mode in ("fma", "mul"):
        ms, pms = at_depth("peak", mode, xs, as_, rf.PEAK_ITERS, rf.PEAK_CHAINS)
        if mode == "fma":
            flops = 2.0 * xs.numel() * rf.PEAK_ITERS * rf.INNER * rf.PEAK_CHAINS
            rec["peak"] = dict(ms=ms, plain_ms=pms, ops_ms=1e3 * flops / PUBLISHED_F32_FLOPS,
                               bytes_ms=1e3 * 12.0 * xs.numel() / PUBLISHED_BYTES_PER_S)
    xs, as_ = rf.probe_inputs(rf.LATENCY_GRID * 8, dev)
    for mode in rf.LATENCY_MODES:
        full = mode == "fma"  # the timed row; a plain run at full depth takes a minute
        ms, pms = at_depth("latency", mode, xs, as_, rf.LATENCY_ITERS if full else 64, 1)
        if full:
            flops = 2.0 * xs.numel() * rf.LATENCY_ITERS * rf.INNER
            rec["latency"] = dict(ms=ms, plain_ms=pms, ops_ms=1e3 * flops / PUBLISHED_F32_FLOPS,
                                  bytes_ms=1e3 * 12.0 * xs.numel() / PUBLISHED_BYTES_PER_S)

    for k in rf.CUDA_KERNEL.launches:
        rf.CUDA_KERNEL.launches[k] = 0
    peaks = rf.measure_f32_peak(device=dev)
    lat = rf.latency_probe(device=dev)
    launches = dict(rf.CUDA_KERNEL.launches)
    print(f"f32 peak: FMA {peaks['peak_fma_flops'] / 1e12:.3f} TFLOP/s (2 a step), multiply "
          f"only {peaks['peak_mul_flops'] / 1e12:.3f} T operations/s; published "
          f"{PUBLISHED_F32_FLOPS / 1e12:.0f} TFLOP/s")
    print("dependent-chain latency, ns a step: "
          + ", ".join(f"{m} {lat[m]:.3f}" for m in rf.LATENCY_MODES))
    print(f"launches: {launches}")
    for probe, v in rec.items():
        v.update(launches=launches[probe], err=err[probe])
        if v["launches"] < 1:
            raise RuntimeError("a probe's entry point did not launch its kernel")
    return peaks, lat, rec


def single_plain_turns(dev, label, kernel_fn, plain_fn):
    """Times in turns plain, kernel, kernel, plain: the kernel 2 x TIMING_ITERS
    CUDA-event-timed runs after warm-up, the plain version two single runs.
    -> (medians, the kernel's last output, the plain version's)."""
    from pathtrace_tpu_torch.utils.timing import time_fn

    ms = {"kernel": [], "plain": []}
    last = {}
    for name in ("plain", "kernel", "kernel", "plain"):
        if name == "kernel":
            t, last[name] = time_fn(kernel_fn, warmup=2, iters=TIMING_ITERS, device=dev)
        else:
            t, last[name] = time_fn(plain_fn, warmup=0, iters=1, device=dev)
        ms[name].extend(t)
    med = {k: statistics.median(v) for k, v in ms.items()}
    print(f"{label}: kernel {med['kernel']:.4f} ms (runs {min(ms['kernel']):.4f}.."
          f"{max(ms['kernel']):.4f}), plain {med['plain']:.1f} ms, plain/kernel "
          f"{med['plain'] / med['kernel']:.1f}")
    return med, last["kernel"], last["plain"]


def profile_steps(label, step_fn, state, step_ms, steps=20):
    """``torch.profiler`` device times by kernel over ``steps`` inverse steps,
    and the device's idle share against ``step_ms``, the step's time without
    the profiler. A profiler that sees no device time fails the run, since
    PERF.md's breakdown of the step reads this."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = step_fn(state)
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / steps
    rows = [(e.key, e.self_device_time_total / 1e3 / steps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "#" not in e.key]  # no annotations
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    if not device_ms > 0:
        raise RuntimeError("torch.profiler recorded no device time")
    print(f"torch.profiler over {steps} {label} steps: host wall {wall:.4f} ms a step "
          f"(under the profiler), device {device_ms:.4f} ms a step; against the step's "
          f"{step_ms:.4f} ms without the profiler the device is idle "
          f"{1.0 - device_ms / step_ms:.3f} of a step")
    for key, ms_ in rows[:6]:
        print(f"  {ms_:.4f} ms a step  {key[:90]}")


def plain_nee_cross_grads(nk, tk, scene, cam, cfg, step, target, device):
    """``grad_kernel.cross_grads`` under NEE with the plain versions."""
    import torch

    sb, cb, _ = tk.host_blocks(scene, cam, cfg, device)
    kw = dict(local_h=cfg.height, spp=cfg.spp, device=device)
    seeds = [tk.make_seed_block(cfg, 2 * step + k) for k in (0, 1)]
    a, b = (tk.trace_plain(sb, cb, sd, cfg, mode="color", **kw) / cfg.spp for sd in seeds)
    ra, rb = a - target, b - target
    denom = a.numel()
    sums = (nk.replay_plain(sb, cb, seeds[0], cfg, (rb / denom / cfg.spp).contiguous(), **kw)
            + nk.replay_plain(sb, cb, seeds[1], cfg, (ra / denom / cfg.spp).contiguous(), **kw))
    return torch.cat([sums[:-1], (torch.sum(ra * rb) / denom)[None]])


def nee_phase_12(dev, scene, cam, gk, nk, tk):
    """Kernel and plain times of the NEE grad kernel at the path's shapes,
    each last output held against its plain version's. -> (times, errors)."""
    import torch
    from pathtrace_tpu_torch import RenderConfig, inverse
    from pathtrace_tpu_torch.utils.timing import time_fn

    phase(12, f"NEE grad timing (kernel: median of {2 * TIMING_ITERS} CUDA-event-timed runs; "
              f"plain: 2 single runs; turns plain, kernel, kernel, plain)")
    sb = scene.packed()
    out, err = {}, {"fused": 0.0, "replay": 0.0}

    turns = functools.partial(single_plain_turns, dev)

    cfg = RenderConfig(width=512, height=512, spp=32, nee=True)
    cb = tk.camera_block(cam, cfg)
    seed = tk.make_seed_block(cfg)
    target = torch.full((512, 512, 3), 0.25, device=dev)
    ct = torch.full((512, 512, 3), 1e-6, device=dev)
    kw = dict(local_h=512, spp=32, device=dev)
    ms, _ = time_fn(lambda: tk.trace(sb, cb, seed, cfg, mode="color", **kw), warmup=2,
                    iters=2 * TIMING_ITERS, device=dev)
    out["color_nee", "kernel"] = statistics.median(ms)
    print(f"trace kernel, NEE colour sums 512x512x32 spp x5: {out['color_nee', 'kernel']:.4f} ms "
          f"(runs {min(ms):.4f}..{max(ms):.4f})")
    label = "NEE fused 512x512x32 spp x5"
    med, got, ref = turns(label, lambda: nk.fused(sb, cb, seed, cfg, target, **kw),
                          lambda: nk.fused_plain(sb, cb, seed, cfg, target, **kw))
    err["fused"] = max(err["fused"], nee_compare(f"{label}/sums", got[0], ref[0], "sums"),
                       nee_compare(f"{label}/colour", got[1], ref[1], "color"))
    out["fused", "kernel"], out["fused", "plain"] = med["kernel"], med["plain"]
    label = "NEE replay 512x512x32 spp x5"
    med, got, ref = turns(label, lambda: nk.replay(sb, cb, seed, cfg, ct, **kw),
                          lambda: nk.replay_plain(sb, cb, seed, cfg, ct, **kw))
    err["replay"] = max(err["replay"], nee_compare(f"{label}/sums", got, ref, "sums"))
    out["replay", "kernel"], out["replay", "plain"] = med["kernel"], med["plain"]
    print(f"the trace kernel's colour pass plus one replay launch: "
          f"{out['color_nee', 'kernel'] + out['replay', 'kernel']:.4f} ms")

    cfg = RenderConfig(width=256, height=256, spp=16, nee=True)
    target = torch.full((256, 256, 3), 0.25, device=dev)

    def kernel_cross():
        loss, d = gk.cross_grads(scene, cam, cfg, 0, target, device=dev)
        return loss, d

    label = "NEE cross-estimator loss+grads of one inverse step 256x256x16"
    med, got, ref = turns(label, kernel_cross,
                          lambda: plain_nee_cross_grads(nk, tk, scene, cam, cfg, 0, target, dev))
    loss, d = got
    n = scene.num_objects
    flat = torch.cat([torch.cat([d["radius"][:, None], d["position"], d["emission"], d["color"]],
                                dim=1).reshape(-1), ref[10 * n: 10 * n + 15], loss[None]])
    err["replay"] = max(err["replay"], nee_compare(f"{label}/loss+grads", flat, ref, "sums"))
    out["cross", "kernel"], out["cross", "plain"] = med["kernel"], med["plain"]
    rates = {"position": inverse.exponential_decay(0.5, 400, 0.02),
             "radius": inverse.exponential_decay(0.1, 400, 0.02)}
    state, step_fn, _ = inverse.make_inverse_step(scene, cam, cfg, target,
                                                  ("position", "radius"), rates, device=dev)
    ms, _ = time_fn(step_fn, state, warmup=2, iters=2 * TIMING_ITERS, device=dev)
    out["step", "kernel"] = statistics.median(ms)
    print(f"NEE inverse step 256x256x16 (kernel path, Adam included): "
          f"{out['step', 'kernel']:.4f} ms (runs {min(ms):.4f}..{max(ms):.4f})")

    profile_steps("NEE inverse", step_fn, state, out["step", "kernel"])
    return out, err


# ---- the all-parameter backward (K4) and the glossy paths (phases 13, 14, 15) --------

AD_CONFIGS = (("diffuse", False), ("diffuse", True), ("glossy", False), ("glossy", True))
GLOSSY_INVERSE_STEPS = 100


def ad_name(brdf, nee):
    return ("nee_" if nee else "") + brdf


def ad_phase_13(dev, scene, cam, ak, nk, tk):
    """K4 against its plain version on the card. -> max |kernel - plain|."""
    import torch
    from pathtrace_tpu_torch import RenderConfig

    phase(13, "all-parameter backward (K4) vs plain on the card (128x64, 4 spp; also at row "
              "offset 16, sample offset 2; one 32-spp launch)")
    sb = scene.packed()
    rng = np.random.default_rng(0)
    full = rng.normal(size=(ak.NUM_CT, 64, 128)).astype(np.float32)
    full[9] *= 1e-4  # depth is ~1e4 in these units
    full = torch.from_numpy(full).to(dev)
    colour = full.clone()
    colour[3:] = 0.0
    worst = 0.0
    for brdf, nee in AD_CONFIGS:
        name = ad_name(brdf, nee)
        cfg = RenderConfig(width=128, height=64, spp=4, brdf=brdf, nee=nee)
        cb = tk.camera_block(cam, cfg)
        seed = tk.make_seed_block(cfg, 3)
        kw = dict(local_h=64, spp=4, device=dev)
        before = ak.CUDA_KERNEL.launches
        got = ak.replay(sb, cb, seed, cfg, colour, **kw)
        torch.cuda.synchronize()
        if ak.CUDA_KERNEL.launches != before + 1:
            raise RuntimeError("the K4 launch counter did not move")
        worst = max(worst, nee_compare(f"{name}/colour cotangent", got,
                                       ak.replay_plain(sb, cb, seed, cfg, colour, **kw), "sums"))
        if not torch.equal(ak.replay(sb, cb, seed, cfg, colour, **kw), got):
            raise RuntimeError(f"two K4 launches gave different bits ({name})")
        block = ak.block_from_sums(got)
        n = scene.num_objects
        geometry = max(float(block[:n, :4].abs().max()), float(block[n:, :3].abs().max()))
        print(f"  {name}: launched twice: identical bits; largest |geometry or camera sum| "
              f"{geometry:.6g}")
        if not nee and geometry != 0.0:
            raise RuntimeError(f"{name}: geometry and camera sums of a colour-only cotangent "
                               f"are not exactly 0")
        if nee and not geometry > 0.0:
            raise RuntimeError(f"{name}: no geometry gradient under NEE")
        if nee and brdf == "diffuse":
            k3 = nk.replay(sb, cb, seed, cfg, colour[:3].permute(1, 2, 0).contiguous(), **kw)
            if not torch.equal(got, k3):
                raise RuntimeError("K4 on NEE diffuse is not the NEE kernel's replay to the bit")
            print("  nee_diffuse: K4 == NEE kernel's replay: identical bits")
        got = ak.replay(sb, cb, seed, cfg, full, **kw)
        worst = max(worst, nee_compare(f"{name}/colour + normal + albedo + depth cotangents",
                                       got, ak.replay_plain(sb, cb, seed, cfg, full, **kw),
                                       "sums"))
        cfg_o = RenderConfig(width=128, height=96, spp=4, brdf=brdf, nee=nee)
        cb_o = tk.camera_block(cam, cfg_o)
        seed_o = tk.make_seed_block(cfg_o, 0, 2, 16)
        kw_o = dict(local_h=64, spp=2, device=dev)
        worst = max(worst, nee_compare(f"{name} @offsets",
                                       ak.replay(sb, cb_o, seed_o, cfg_o, full, **kw_o),
                                       ak.replay_plain(sb, cb_o, seed_o, cfg_o, full, **kw_o),
                                       "sums"))
    cfg = RenderConfig(width=128, height=64, spp=32, brdf="glossy", nee=True)
    cb = tk.camera_block(cam, cfg)
    seed = tk.make_seed_block(cfg, 3)
    kw = dict(local_h=64, spp=32, device=dev)
    got = ak.replay(sb, cb, seed, cfg, full, **kw)
    ref = ak.replay_plain(sb, cb, seed, cfg, full, **kw)
    worst = max(worst, nee_compare("nee_glossy 32 spp", got, ref, "sums"))
    print(f"  nee_glossy 32 spp == plain version to the bit: {bool(torch.equal(got, ref))}")
    return worst


def flat_scene_grads(d_scene):
    """Scene gradients -> [10N + 16] in the kernels' layout, zeros in the
    camera and loss slots (which ``agreement`` then passes)."""
    import torch

    rows = torch.cat([d_scene.radius[:, None], d_scene.position, d_scene.emission,
                      d_scene.color], dim=1).reshape(-1)
    return torch.cat([rows, rows.new_zeros(16)])


def camera_compare(label, d_cam, ref_cam, atol):
    """Camera gradients within rtol 1e-4 plus ``atol`` of the largest |ref|."""
    import torch

    got = torch.cat([d_cam.position, d_cam.yaw[None], d_cam.pitch[None]]).double().cpu()
    ref = torch.cat([ref_cam.position, ref_cam.yaw[None], ref_cam.pitch[None]]).double().cpu()
    diff = (got - ref).abs()
    ok = bool((diff <= 1e-4 * ref.abs() + atol * ref.abs().max()).all())
    print(f"  {label}: camera gradients max |diff| {float(diff.max()):.6g} (largest |ref| "
          f"{float(ref.abs().max()):.6g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"disagreement: {label}: camera gradients")
    return float(diff.max())


def ad_phase_14(dev, scene, cam, gk, nk, ak, tk):
    """The glossy gradient paths at full width through the user entry points.
    -> (K4 launches on these paths, max |kernel - plain| of the sums)."""
    import dataclasses

    import torch
    from pathtrace_tpu_torch import RenderConfig, grad, inverse, render_aovs
    from pathtrace_tpu_torch.scene import Scene

    def zero_counts():
        tk.CUDA_KERNEL.launches = 0
        ak.CUDA_KERNEL.launches = 0
        for k in (gk, nk):
            for mode in k.MODES:
                k.CUDA_KERNEL.launches[mode] = 0

    def counts():
        return (tk.CUDA_KERNEL.launches, ak.CUDA_KERNEL.launches,
                sum(nk.CUDA_KERNEL.launches.values()) + sum(gk.CUDA_KERNEL.launches.values()))

    phase(14, f"glossy gradient paths at full width on cuda:0: (a) render_loss_grads 512x512x32 "
              f"glossy and NEE glossy; (b) ad_loss_and_grads beside the NEE kernel on NEE "
              f"diffuse; (c) glossy albedo recovery 256x256, 8 spp, {GLOSSY_INVERSE_STEPS} steps")
    true_color = scene.color.numpy()
    bad = np.clip(true_color + np.random.default_rng(0).uniform(-0.35, 0.35, (9, 3)),
                  0.05, 0.95).astype(np.float32)
    corrupted = Scene(scene.radius, scene.position, scene.emission, bad)
    n = scene.num_objects
    launches, worst = 0, 0.0

    for nee in (False, True):
        name = ad_name("glossy", nee)
        cfg = RenderConfig(width=512, height=512, spp=32, brdf="glossy", nee=nee)
        target = render_aovs(scene, cam, dataclasses.replace(cfg, spp=64), frame=987654,
                             device=dev)["color"]
        zero_counts()
        loss, (d_scene, d_cam) = grad.render_loss_grads(corrupted, cam, cfg, 0, target,
                                                        device=dev)
        torch.cuda.synchronize()
        seen = counts()
        launches += seen[1]
        print(f"(a) {name}: launches: trace {seen[0]}, K4 {seen[1]}, other gradient kernels "
              f"{seen[2]}")
        if seen != (1, 1, 0):
            raise RuntimeError(f"render_loss_grads for {name} is not one colour-sum launch and "
                               f"one K4 launch")
        # The plain route: trace_plain's colour, the loss's cotangent, replay_plain.
        sb, cb, _ = tk.host_blocks(corrupted, cam, cfg, dev)
        seed = tk.make_seed_block(cfg, 0)
        kw = dict(local_h=512, spp=32, device=dev)
        diff = tk.trace_plain(sb, cb, seed, cfg, mode="color", **kw) / cfg.spp - target
        denom = diff.numel()
        ct = ak.pack_cotangents(cfg, 2.0 * diff / denom, device=dev)
        ref_block = ak.block_from_sums(ak.replay_plain(sb, cb, seed, cfg, ct, **kw))
        ref_scene, ref_cam = ak.grads_from_block(corrupted, cam, cfg, ref_block)
        ref_loss = torch.sum(diff * diff) / denom
        print(f"(a) {name}: loss {float(loss):.8f}, plain route {float(ref_loss):.8f}")
        if abs(float(loss) - float(ref_loss)) > 1e-4 * abs(float(ref_loss)):
            raise RuntimeError(f"{name}: the loss is not the plain route's")
        worst = max(worst, nee_compare(f"(a) {name}: scene gradients vs the plain route",
                                       flat_scene_grads(d_scene), flat_scene_grads(ref_scene),
                                       "sums"))
        camera_compare(f"(a) {name}", d_cam, ref_cam, 1e-6)
        for label, g in (("d albedo", d_scene.color), ("d emission", d_scene.emission),
                         ("d position", d_scene.position), ("d eye", d_cam.position)):
            print(f"(a) {name}: {label}: max |g| {float(g.abs().max()):.6g}")
            if g.device != dev or not torch.isfinite(g).all():
                raise RuntimeError(f"{name}: {label} is not finite on {dev}")
        if not float(d_scene.color.abs().max()) > 0:
            raise RuntimeError(f"{name}: the albedo gradient is all zero")
        if bool(d_scene.position.any()) != nee or bool(d_cam.position.any()) != nee:
            raise RuntimeError(f"{name}: geometry gradients must be non-zero under NEE and "
                               f"exactly zero without")

    cfg = RenderConfig(width=512, height=512, spp=32, nee=True)
    target = render_aovs(scene, cam, dataclasses.replace(cfg, spp=64), frame=987654,
                         device=dev)["color"]
    zero_counts()
    loss, (d_scene, d_cam) = ak.ad_loss_and_grads(corrupted, cam, cfg, 0, target, device=dev)
    torch.cuda.synchronize()
    seen = counts()
    launches += seen[1]
    loss_3, (d_scene_3, d_cam_3) = nk.nee_loss_and_grads(corrupted, cam, cfg, 0, target,
                                                         device=dev)
    print(f"(b) nee_diffuse: launches: trace {seen[0]}, K4 {seen[1]}, others {seen[2]}; loss "
          f"{float(loss):.8f}, the NEE kernel's fused mode {float(loss_3):.8f}")
    if seen != (1, 1, 0):
        raise RuntimeError("ad_loss_and_grads is not one colour-sum launch and one K4 launch")
    if abs(float(loss) - float(loss_3)) > 1e-4 * abs(float(loss_3)):
        raise RuntimeError("ad_loss_and_grads' loss is not the NEE kernel's")
    nee_compare("(b) K4 route vs the NEE kernel's fused mode: scene gradients",
                flat_scene_grads(d_scene), flat_scene_grads(d_scene_3), "sums", cross=True)
    camera_compare("(b) K4 route vs the NEE kernel's fused mode", d_cam, d_cam_3, 1e-4)

    cfg = RenderConfig(width=256, height=256, spp=8, brdf="glossy")
    target = render_aovs(scene, cam, dataclasses.replace(cfg, spp=64), frame=987654,
                         device=dev)["color"]
    # The first three steps on the autograd route, from the same start.
    state_t, step_t, _ = inverse.make_inverse_step(
        corrupted, cam, dataclasses.replace(cfg, backend="torch"), target, ("color",), 2e-2,
        device=dev)
    want = []
    for _ in range(3):
        state_t, loss_t = step_t(state_t)
        want.append((float(loss_t), state_t.params["color"].grad.detach().clone()))
    zero_counts()
    state, step_fn, _ = inverse.make_inverse_step(corrupted, cam, cfg, target, ("color",), 2e-2,
                                                  device=dev)
    losses, step_ms = [], []
    for i in range(GLOSSY_INVERSE_STEPS):
        before = counts()
        t_step = time.perf_counter()
        state, loss = step_fn(state)
        losses.append(float(loss))  # waits for the step
        step_ms.append(1e3 * (time.perf_counter() - t_step))
        after = counts()
        if tuple(a - b for a, b in zip(after, before)) != (2, 2, 0):
            raise RuntimeError(f"glossy inverse step {i} launched trace, K4, others "
                               f"{tuple(a - b for a, b in zip(after, before))}, not 2, 2, 0")
        if i < 3:
            g, (loss_t, g_t) = state.params["color"].grad, want[i]
            d = float((g - g_t).abs().max())
            tol = 2e-2 * g_t.abs() + 2e-2 * g_t.abs().max()
            ok = (abs(losses[i] - loss_t) <= 1e-2 * abs(loss_t)
                  and bool(((g - g_t).abs() <= tol).all()))
            print(f"(c) step {i + 1}: loss {losses[i]:.8f}, autograd route {loss_t:.8f}; albedo "
                  f"gradient max |diff| {d:.3g} of largest {float(g_t.abs().max()):.3g} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"glossy inverse step {i + 1} is not the autograd route's")
    launches += counts()[1]
    recovered = inverse.apply_params(corrupted.to(dev), state.params).color.detach().cpu().numpy()
    err_before, err_after = np.abs(bad - true_color), np.abs(recovered - true_color)
    print(f"(c) launches: trace {counts()[0]}, K4 {counts()[1]}, others {counts()[2]}")
    print(f"(c) loss {losses[0]:.6f} (step 1) -> {losses[-1]:.6f} (step {GLOSSY_INVERSE_STEPS}); "
          f"mean |albedo error| {err_before.mean():.4f} -> {err_after.mean():.4f}; by sphere "
          f"{[round(float(x), 3) for x in err_before.mean(axis=1)]} -> "
          f"{[round(float(x), 3) for x in err_after.mean(axis=1)]}")
    print(f"(c) host-clock step: first {step_ms[0]:.3f} ms, median "
          f"{statistics.median(step_ms):.3f} ms, {GLOSSY_INVERSE_STEPS} steps "
          f"{sum(step_ms):.1f} ms")
    if not np.all(np.isfinite(losses)):
        raise RuntimeError("a glossy inverse step gave a non-finite loss")
    if not err_after.mean() < err_before.mean():
        raise RuntimeError(f"mean albedo error {err_after.mean():.4f} is not below its start "
                           f"{err_before.mean():.4f}")
    return launches, worst


def ad_phase_15(dev, scene, cam, ak, nk, tk):
    """Kernel and plain times of K4 at the paths' shapes, each last output
    held against its plain version's. -> ({(name, "kernel" or "plain"): ms},
    max |kernel - plain|)."""
    import torch
    from pathtrace_tpu_torch import RenderConfig, inverse
    from pathtrace_tpu_torch.utils.timing import time_fn

    phase(15, f"K4 timing (kernel: median of {2 * TIMING_ITERS} CUDA-event-timed runs; plain: "
              f"2 single runs; turns plain, kernel, kernel, plain)")
    sb = scene.packed()
    out, worst = {}, 0.0

    def turns(label, kernel_fn, plain_fn):
        med, got, ref = single_plain_turns(dev, label, kernel_fn, plain_fn)
        return med, nee_compare(f"{label}/sums", got, ref, "sums")

    for size, spp, configs in ((512, 32, AD_CONFIGS[1:]), (256, 8, AD_CONFIGS[2:3])):
        ct = torch.zeros((ak.NUM_CT, size, size), device=dev)
        ct[:3] = 1e-6
        kw = dict(local_h=size, spp=spp, device=dev)
        for brdf, nee in configs:
            name = ad_name(brdf, nee)
            cfg = RenderConfig(width=size, height=size, spp=spp, brdf=brdf, nee=nee)
            cb = tk.camera_block(cam, cfg)
            seed = tk.make_seed_block(cfg)
            med, err = turns(f"K4 {name} {size}x{size}x{spp} spp x5",
                             lambda: ak.replay(sb, cb, seed, cfg, ct, **kw),
                             lambda: ak.replay_plain(sb, cb, seed, cfg, ct, **kw))
            worst = max(worst, err)
            out[name, size, "kernel"], out[name, size, "plain"] = med["kernel"], med["plain"]
            if size == 512 and name == "nee_diffuse":
                ct3 = ct[:3].permute(1, 2, 0).contiguous()
                ms, got = time_fn(lambda: nk.replay(sb, cb, seed, cfg, ct3, **kw), warmup=2,
                                  iters=2 * TIMING_ITERS, device=dev)
                print(f"the NEE kernel's replay beside it: {statistics.median(ms):.4f} ms (runs "
                      f"{min(ms):.4f}..{max(ms):.4f}); the same bits as K4: "
                      f"{bool(torch.equal(got, ak.replay(sb, cb, seed, cfg, ct, **kw)))}")
            if size == 512:
                ms, _ = time_fn(lambda: tk.trace(sb, cb, seed, cfg, mode="color", **kw),
                                warmup=2, iters=2 * TIMING_ITERS, device=dev)
                out[name, size, "color"] = statistics.median(ms)
                print(f"the trace kernel's colour sums for {name}: {out[name, size, 'color']:.4f} "
                      f"ms; colour pass plus one K4 launch (render_loss_grads): "
                      f"{out[name, size, 'color'] + med['kernel']:.4f} ms")

    cfg = RenderConfig(width=256, height=256, spp=8, brdf="glossy")
    target = torch.full((256, 256, 3), 0.25, device=dev)
    state, step_fn, _ = inverse.make_inverse_step(scene, cam, cfg, target, device=dev)
    ms, _ = time_fn(step_fn, state, warmup=2, iters=2 * TIMING_ITERS, device=dev)
    out["step"] = statistics.median(ms)
    print(f"glossy inverse step 256x256x8 (kernel path, Adam included): {out['step']:.4f} ms "
          f"(runs {min(ms):.4f}..{max(ms):.4f})")
    profile_steps("glossy inverse", step_fn, state, out["step"])
    return out, worst


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box
    from pathtrace_tpu_torch import cli
    from pathtrace_tpu_torch.io.exr import load_aovs_exr
    from pathtrace_tpu_torch.ops import ad_grad_kernel as ak
    from pathtrace_tpu_torch.ops import build
    from pathtrace_tpu_torch.ops import grad_kernel as gk
    from pathtrace_tpu_torch.ops import nee_grad_kernel as nk
    from pathtrace_tpu_torch.ops import trace_kernel as tk
    from pathtrace_tpu_torch.render import pack_channels
    from pathtrace_tpu_torch.utils import roofline as rf
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
    sources = (tk.SOURCE, gk.SOURCE, nk.SOURCE, ak.SOURCE, rf.SOURCE)
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

    nee_err = nee_phase_9(dev, scene, cam, nk, tk)
    nee_launches, _ = nee_phase_10(dev, scene, cam, gk, nk, tk)
    peaks, _, probes = probe_phase_11(dev, rf)
    nee_times, nee_err_12 = nee_phase_12(dev, scene, cam, gk, nk, tk)
    ad_err_13 = ad_phase_13(dev, scene, cam, ak, nk, tk)
    ad_launches, ad_err_14 = ad_phase_14(dev, scene, cam, gk, nk, ak, tk)
    ad_times, ad_err_15 = ad_phase_15(dev, scene, cam, ak, nk, tk)

    # One line a kernel: its time at its main shape beside its bounds.
    def frame_segments(width, spp, **extra):
        return rf.count_segments(scene, cam, RenderConfig(width=width, height=width, spp=spp,
                                                          **extra), 0, dev)

    seg = {"512x4": frame_segments(512, 4), "512x32": frame_segments(512, 32),
           "256x8": frame_segments(256, 8), "512x32 nee": frame_segments(512, 32, nee=True),
           "512x32 glossy": frame_segments(512, 32, brdf="glossy"),
           "512x32 nee glossy": frame_segments(512, 32, nee=True, brdf="glossy")}
    for name, n_seg in seg.items():
        print(f"traced segments, {name}: {n_seg}")
    ops = rf.OPS_PER_SEGMENT
    px512, px256 = 512 * 512, 256 * 256
    # (name, source, replaces, launches, max err, ms, plain ms, segments,
    #  operations a segment, bytes in + out)
    rows = [
        ("pathtrace_kernel", "trace_kernel.cu", "pathtrace_tpu/ops/pallas_trace.py:361",
         launches, worst_err, statistics.median(times["kernel", 4]),
         statistics.median(times["plain", 4]), seg["512x4"], ops["forward_diffuse"],
         px512 * 14 * 4),
    ]
    grad_bytes = {"fused": px512 * 6 * 4, "dump": px256 * (3 + 54) * 4, "replay": px512 * 3 * 4}
    for mode, name, replaces in GRAD_KERNELS:
        rows.append((name, "grad_kernel.cu", replaces, grad_launches[mode],
                     max(grad_err[mode], grad_err_8[mode]), grad_times[mode, "kernel"],
                     grad_times[mode, "plain"], seg["256x8" if mode == "dump" else "512x32"],
                     ops["forward_diffuse"], grad_bytes[mode]))
    rows += [
        ("nee_grad_kernel[fused]", "nee_grad_kernel.cu",
         "pathtrace_tpu/ops/pallas_nee_grad.py:98", nee_launches["fused"],
         max(nee_err["fused"], nee_err_12["fused"]), nee_times["fused", "kernel"],
         nee_times["fused", "plain"], seg["512x32 nee"], ops["nee_grad_fused"],
         px512 * 6 * 4),
        ("nee_grad_kernel[replay]", "nee_grad_kernel.cu",
         "pathtrace_tpu/ops/pallas_nee_grad.py:98", nee_launches["replay"],
         max(nee_err["replay"], nee_err_12["replay"]), nee_times["replay", "kernel"],
         nee_times["replay", "plain"], seg["512x32 nee"], ops["ad_nee"], px512 * 3 * 4),
        ("ad_grad_kernel", "ad_grad_kernel.cu", "pathtrace_tpu/ops/pallas_ad.py:64",
         ad_launches, max(ad_err_13, ad_err_14, ad_err_15), ad_times["glossy", 512, "kernel"],
         ad_times["glossy", 512, "plain"], seg["512x32 glossy"], ops["ad_glossy"],
         px512 * 10 * 4),
    ]
    kernels = []
    for (name, source, replaces, n_launch, max_err, ms, plain_ms, n_seg, ops_seg,
         n_bytes) in rows:
        ops_ms = rf.bound_ms(n_seg, ops_seg, PUBLISHED_F32_FLOPS)
        bytes_ms = 1e3 * n_bytes / PUBLISHED_BYTES_PER_S
        kernels.append({
            "name": name, "route": "cuda", "source": f"pathtrace_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": n_launch, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "library_ms": None,
            "bound_ms_unfused_measured": rf.bound_ms(n_seg, ops_seg, peaks["peak_mul_flops"]),
        })
    for probe, replaces in (("peak", "pathtrace_tpu/utils/roofline.py:386"),
                            ("latency", "scripts/fma_probe.py:115")):
        r = probes[probe]
        kernels.append({
            "name": f"probe_kernel[{probe}]", "route": "cuda",
            "source": "pathtrace_tpu_torch/csrc/probe_kernel.cu", "replaces": replaces,
            "launches": r["launches"], "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": max(r["ops_ms"], r["bytes_ms"]),
            "bound_by": "operations" if r["ops_ms"] >= r["bytes_ms"] else "bytes",
            "library_ms": None, "bound_ms_unfused_measured": None,
        })
    print(f"card: {smi}; bound = segments x operations a segment / the published "
          f"{PUBLISHED_F32_FLOPS / 1e12:.0f} TFLOP/s (measured here: FMA "
          f"{peaks['peak_fma_flops'] / 1e12:.3f} TFLOP/s); unfused = the same over the measured "
          f"multiply-only rate {peaks['peak_mul_flops'] / 1e12:.3f} T/s")
    for k in kernels:
        unfused = k["bound_ms_unfused_measured"]
        print(f"  {k['name']:26s} {k['ms']:10.4f} ms  launches {k['launches']:4d}  bound "
              f"{k['bound_ms']:.4f} ms by {k['bound_by']}  share of bound "
              f"{k['bound_ms'] / k['ms']:.3f}"
              + ("" if unfused is None else f"  (unfused {unfused:.4f} ms, share "
                                            f"{unfused / k['ms']:.3f})"))
    # K4's other configurations at 512x512x32 beside their bounds (the kernels
    # line carries glossy, the configuration of the main path).
    for name, key, n_seg in (("nee_glossy", "ad_nee_glossy", seg["512x32 nee glossy"]),
                             ("nee_diffuse", "ad_nee", seg["512x32 nee"])):
        ms, b = ad_times[name, 512, "kernel"], rf.bound_ms(n_seg, ops[key], PUBLISHED_F32_FLOPS)
        print(f"  ad_grad_kernel, {name:12s} {ms:10.4f} ms  bound {b:.4f} ms by operations  share "
              f"of bound {b / ms:.3f}  (plain {ad_times[name, 512, 'plain']:.1f} ms)")
    b = rf.bound_ms(seg["512x32 nee"], ops["ad_replay_nee_jaxpr"], PUBLISHED_F32_FLOPS)
    print(f"  ad_grad_kernel, nee_diffuse against the count of the TPU kernel's generated "
          f"replay ({ops['ad_replay_nee_jaxpr']} a segment): bound {b:.4f} ms, share "
          f"{b / ad_times['nee_diffuse', 512, 'kernel']:.3f}")
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
