"""Gradient gate, phase B, on the PyTorch port: the kernels against the f64 oracle.

The port of scripts/grad_gate.py. It reads an oracle written by
scripts/torch_grad_oracle.py or scripts/grad_oracle_cpu.py (``oracle.npz``
and ``decisions.npz`` beside it, either script's), refuses files whose
lattice stamp differs from this gate's configuration, and writes ``--out``
(default docs/GRAD_GATE_H100.md; docs/GRAD_GATE.md is the JAX package's
TPU record and is never written here). It runs on the card unless given
``--device cpu``, where the kernel routes run their plain versions.

1. K2 fused (``ops/grad_kernel.loss_and_grads``, diffuse MSE) against the
   port's f32 autograd on the ``"torch"`` backend on the same lattice: loss,
   d emission, d albedo, threshold 5e-3.
2. All parameters under NEE against the f64 oracle: per block, the max
   relative error of the f32 replay floor from the file, the f32 replay of
   the oracle's own decisions on this device, torch autograd in f32 on this
   device, "K1 colour + K4" (``ops/ad_grad_kernel.ad_loss_and_grads``) and
   "K3 fused" (``ops/nee_grad_kernel.nee_loss_and_grads``). Gate, the JAX
   gate's rule: each kernel error <= max(min(e_torch, ceil), 2 x floor,
   5e-3), ceil = max(10 x max(floor, replay here), 2e-2), and a torch-AD
   error above ceil fails the block. Then the record-point line: the share
   of pixels where K1's NEE colour sums / spp differ from the oracle's
   recorded colour by more than 1e-4 and by more than 1e-2.
3. Finite differences: a central FD of K2's loss for two shading
   parameters (threshold 2e-2), then the oracle's per-pixel f64 table of
   four geometry and camera parameters (gross < 2e-2 and p90 < 2e-2).

The exit code is 0 only on an overall PASS.

Usage, from the root of a checkout:

    python scripts/torch_grad_gate.py [--size 512] [--spp 32]
        [--oracle results/grad_oracle_torch/oracle.npz] [--out docs/GRAD_GATE_H100.md]
        [--device cpu|0]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box, grad  # noqa: E402
from pathtrace_tpu_torch.convert import decisions_from_npz  # noqa: E402
from pathtrace_tpu_torch.ops import ad_grad_kernel, build, frozen  # noqa: E402
from pathtrace_tpu_torch.ops import grad_kernel, nee_grad_kernel, trace_kernel  # noqa: E402
from pathtrace_tpu_torch.render import resolve_device  # noqa: E402
from pathtrace_tpu_torch.utils.timing import device_name  # noqa: E402

SHADING_TOL = 5e-3
FD_TOL = 2e-2


def rel_err(a, b, eps=1e-12):
    """max |a - b| over the larger of the two blocks' largest magnitudes."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(a).max(), np.abs(b).max(), eps)
    return float(np.abs(a - b).max() / scale)


def numpy_blocks(d_scene, d_cam) -> dict:
    """Gradients -> the oracle files' block names (yaw and pitch as one)."""
    def f64(x):
        return x.detach().to("cpu", torch.float64).numpy()

    return {"d_emission": f64(d_scene.emission), "d_albedo": f64(d_scene.color),
            "d_position": f64(d_scene.position), "d_radius": f64(d_scene.radius),
            "d_cam_position": f64(d_cam.position),
            "d_cam_yaw_pitch": np.array([float(d_cam.yaw), float(d_cam.pitch)])}


def check_stamp(what, got: dict, want: dict):
    """Refuse a file whose lattice stamp differs from the gate's."""
    for k, v in want.items():
        if k not in got:
            raise SystemExit(f"{what} has no {k!r} in its stamp: re-run the oracle script")
        if got[k] != v:
            raise SystemExit(f"{what} {k}={got[k]!r} != gate config {v!r}: re-run the oracle "
                             "script for this configuration")


def card_line(dev) -> str:
    """The card as nvidia-smi names it, with torch's and nvcc's versions."""
    if dev.type != "cuda":
        card = "no card: device cpu, the kernels' plain versions"
    else:
        card = device_name(dev)
    try:
        nvcc = subprocess.run([build.find_nvcc(), "--version"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[-1]
    except (RuntimeError, OSError, IndexError):
        nvcc = "nvcc not found"
    return f"{card}; torch {torch.__version__} (CUDA {torch.version.cuda}); {nvcc}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--oracle", type=str, default="results/grad_oracle_torch/oracle.npz")
    ap.add_argument("--out", type=str, default="docs/GRAD_GATE_H100.md")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    dev = resolve_device(None if args.device is None else
                         (int(args.device) if args.device.isdigit() else args.device))
    on_card = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    scene, cam = cornell_box(), Camera.create()
    S, SPP = args.size, args.spp
    cfg_k = RenderConfig(width=S, height=S, spp=SPP, backend="cuda", spp_chunk=8)
    cfg_t = dataclasses.replace(cfg_k, backend="torch")
    cfg_kn = dataclasses.replace(cfg_k, nee=True)
    cfg_tn = dataclasses.replace(cfg_t, nee=True)
    target = torch.zeros((S, S, 3), dtype=torch.float32, device=dev)

    want = {"size": S, "spp": SPP, "seed": cfg_tn.seed, "max_bounces": cfg_tn.max_bounces,
            "brdf": cfg_tn.brdf, "nee": cfg_tn.nee, "light_index": cfg_tn.light_index}
    with np.load(args.oracle, allow_pickle=False) as f:
        orc = {k: f[k] for k in f.files}
    check_stamp(f"oracle {args.oracle}", {k: orc[k].item() for k in want if k in orc}, want)
    if "spp_chunk" not in orc:
        raise SystemExit(f"oracle {args.oracle} has no 'spp_chunk': re-run the oracle script")
    # spp_chunk is the LAYOUT of the decisions, not the lattice: the replay
    # below zips with the oracle's own chunking.
    oracle_chunk = int(orc["spp_chunk"])
    dec_path = os.path.join(os.path.dirname(args.oracle) or ".", "decisions.npz")
    recs, dec_stamp = decisions_from_npz(dec_path)
    check_stamp(f"decisions {dec_path}", dec_stamp, {**want, "spp_chunk": oracle_chunk})

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    lines = [
        "# GRAD GATE (H100 port) — device-scale gradient validation",
        "",
        f"Device: **{card_line(dev)}** · config: Cornell {S}^2 x {SPP} spp x "
        f"{cfg_k.max_bounces} bounces · generated by `scripts/torch_grad_gate.py` on "
        + time.strftime("%Y-%m-%d"),
        "",
        "Oracle: the frozen-decision replay of this sample lattice (seed "
        f"{cfg_k.seed}, NEE, decisions in chunks of {oracle_chunk} spp), differentiated",
        "in **float64** by scripts/torch_grad_oracle.py (on a card) or",
        "scripts/grad_oracle_cpu.py (the JAX package, on a CPU), whichever wrote the",
        "`--oracle` file. Its gradient is the detached-decision estimator that the",
        "renderer computes, with ~1e-16 accumulation error instead of f32's noise on",
        "the geometry sums that cancel heavily.",
        "",
        "## 1. K2 fused against torch autograd (diffuse MSE loss)",
        "",
        "Shading gradients, f32 against f32 on the same lattice (threshold "
        f"{SHADING_TOL:g}):",
        "",
        "| quantity | max rel err | pass |",
        "|---|---|---|",
    ]
    ok = True

    t0 = time.perf_counter()
    loss_t, (ds_t, _) = grad.render_loss_grads(scene, cam, cfg_t, 0, target, device=dev)
    loss_k, (ds_k, _) = grad_kernel.loss_and_grads(scene, cam, cfg_k, 0, target, device=dev)
    sync()
    print(f"[B1] torch autograd and K2 fused, diffuse, in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name, e in (("loss", rel_err(loss_k.item(), loss_t.item())),
                    ("d emission", rel_err(ds_k.emission.cpu(), ds_t.emission.cpu())),
                    ("d albedo", rel_err(ds_k.color.cpu(), ds_t.color.cpu()))):
        good = e < SHADING_TOL
        ok &= good
        lines.append(f"| {name} | {e:.2e} | {'PASS' if good else 'FAIL'} |")

    t0 = time.perf_counter()
    _, g_torch = grad.render_loss_grads(scene, cam, cfg_tn, 0, target, device=dev)
    _, g_ad = ad_grad_kernel.ad_loss_and_grads(scene, cam, cfg_kn, 0, target, device=dev)
    _, g_k3 = nee_grad_kernel.nee_loss_and_grads(scene, cam, cfg_kn, 0, target, device=dev)
    _, g_rep = frozen.replay_loss_grads(scene, cam,
                                        dataclasses.replace(cfg_tn, spp_chunk=oracle_chunk), 0,
                                        recs, target, device=dev)
    sync()
    print(f"[B2] torch autograd, K1 colour + K4, K3 fused and the f32 replay, NEE, in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    routes = {k: numpy_blocks(*g) for k, g in
              (("torch", g_torch), ("ad", g_ad), ("k3", g_k3), ("rep", g_rep))}
    oracle = {f"{p}{k}": orc[f"{p}{k}"] for p in ("f64_", "f32_") for k in
              ("d_emission", "d_albedo", "d_position", "d_radius", "d_cam_position")}
    for p in ("f64_", "f32_"):
        oracle[f"{p}d_cam_yaw_pitch"] = np.array([float(orc[f"{p}d_cam_yaw"]),
                                                  float(orc[f"{p}d_cam_pitch"])])
    lines += [
        "",
        "## 2. All parameters under NEE against the f64 oracle",
        "",
        "Per parameter block, the max rel error against the f64 oracle of: the f32",
        "replay of the oracle's own decisions where the oracle ran (the file's",
        "f32 floor), the same f32 replay on this device (arithmetic drift alone,",
        "decision flips excluded), torch autograd in f32 on this device",
        "(arithmetic drift plus borderline decision flips), K1's colour pass + K4",
        "(the all-parameter backward) and K3 fused (the hand-derived NEE",
        "backward).",
        "",
        "Gate: each kernel's error <= max(min(torch AD error, ceil), 2 x floor,",
        "5e-3), where ceil = max(10 x max(floor, replay here), 2e-2): a torch-AD",
        "error above ceil FAILs the block, so a fault in the shared autograd path",
        "cannot widen its own gate.",
        "",
        "| block | f32 floor (file) | f32 replay (here) | torch AD (here) | K1 colour + K4 "
        "| K3 fused | gate | pass |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for name, key in (("d emission", "d_emission"), ("d albedo", "d_albedo"),
                      ("d position", "d_position"), ("d radius", "d_radius"),
                      ("d camera pos", "d_cam_position"),
                      ("d camera yaw/pitch", "d_cam_yaw_pitch")):
        ref = oracle[f"f64_{key}"]
        e_floor = rel_err(oracle[f"f32_{key}"], ref)
        e = {route: rel_err(blocks[key], ref) for route, blocks in routes.items()}
        ceil = max(10.0 * max(e_floor, e["rep"]), 2e-2)
        gate = max(min(e["torch"], ceil), 2.0 * e_floor, 5e-3)
        good = e["ad"] <= gate and e["k3"] <= gate and e["torch"] <= ceil
        ok &= good
        lines.append(f"| {name} | {e_floor:.2e} | {e['rep']:.2e} | {e['torch']:.2e} "
                     f"(≤{ceil:.1e}) | {e['ad']:.2e} | {e['k3']:.2e} | {gate:.2e} | "
                     f"{'PASS' if good else 'FAIL'} |")

    color_k1 = (trace_kernel.render_color_sums(scene, cam, cfg_kn, 0, device=dev) / SPP).cpu()
    adiff = np.abs(color_k1.numpy() - orc["record_color"])
    drift = float(np.mean(np.any(adiff > 1e-4, axis=-1)))
    flips = float(np.mean(np.any(adiff > 1e-2, axis=-1)))
    lines += [
        "",
        f"Record-point consistency: {drift * 100:.2f}% of pixels differ by > 1e-4 between",
        "K1's NEE colour (this device) and the oracle's recorded f32 colour, and",
        f"{flips * 100:.2f}% by > 1e-2 (the likely borderline-lane decision flips).",
        "",
        "## 3. Finite differences",
        "",
        "Shading parameters: central FD of K2's MSE loss (linear paths, no",
        f"discrete sensitivity; eps 1e-3, threshold {FD_TOL:g}).",
        "",
        "| parameter | analytic (K2) | FD | rel err | pass |",
        "|---|---|---|---|---|",
    ]

    def k2_loss(scene_):
        return grad_kernel.loss_and_grads(scene_, cam, cfg_k, 0, target, device=dev)[0].item()

    eps = 1e-3
    for label, field, index, g in (("sphere[0].color.r", "color", (0, 0), ds_k.color[0, 0]),
                                   ("sphere[8].emission.r", "emission", (8, 0),
                                    ds_k.emission[8, 0])):
        def moved(h):
            x = getattr(scene, field).clone()
            x[index] += h
            return scene.replace(**{field: x})

        g = g.item()
        fd = (k2_loss(moved(eps)) - k2_loss(moved(-eps))) / (2 * eps)
        e = abs(g - fd) / max(abs(g), abs(fd), 1e-12)
        good = e < FD_TOL
        ok &= good
        lines.append(f"| {label} | {g:.6e} | {fd:.6e} | {e:.2e} | {'PASS' if good else 'FAIL'} |")

    lines += [
        "",
        "Geometry and camera parameters: the oracle's PER-PIXEL forward derivative",
        "(jvp) against a central FD of the frozen replay's colour image, f64,",
        f"{S}^2 x {int(orc['fd_spp'])} spp of the same lattice. Decisions cannot flip",
        "inside the FD bracket; gate: the gross-normalised error",
        f"|J-D|_1/(|J|_1+|D|_1) < {FD_TOL:g} and p90 of the per-pixel error (active",
        f"pixels) < {FD_TOL:g}.",
        "",
        "| parameter | eps | gross rel err | p50 | p90 | p99.9 | active px | net jvp | net FD "
        "| pass |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for i, name in enumerate(orc["fd_names"]):
        gross, p90 = float(orc["fd_gross"][i]), float(orc["fd_p90"][i])
        good = gross < FD_TOL and p90 < FD_TOL
        ok &= good
        lines.append(
            f"| {name} | {float(orc['fd_eps'][i]):g} | {gross:.2e} | {float(orc['fd_p50'][i]):.2e} "
            f"| {p90:.2e} | {float(orc['fd_p999'][i]):.2e} | {float(orc['fd_active'][i]) * 100:.1f}% "
            f"| {float(orc['fd_netJ'][i]):.4e} | {float(orc['fd_netD'][i]):.4e} "
            f"| {'PASS' if good else 'FAIL'} |")

    lines += ["", f"**Overall: {'PASS' if ok else 'FAIL'}**", ""]
    text = "\n".join(lines)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text)
    print(text)
    mem = (f", peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB allocated"
           if on_card else "")
    print(f"[done] wrote {args.out} in {time.perf_counter() - t_start:.2f} s{mem}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
