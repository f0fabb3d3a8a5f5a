"""Gradient gate, phase A, on the PyTorch port: the f64 frozen-decision oracle.

The port of scripts/grad_oracle_cpu.py, through
``pathtrace_tpu_torch.ops.frozen``; it runs on the card unless given
``--device cpu``. It writes ``--out`` (``oracle.npz``) and, beside it,
``decisions.npz``, with the keys, dtypes and lattice stamp of the JAX
script's files, so that either script's files feed either gate
(scripts/grad_gate.py, scripts/torch_grad_gate.py):

1. [A1] Records the frozen-decision trace of Cornell ``--size``² x
   ``--spp`` spp x 5 bounces, NEE, seed 0, in spp chunks of 2, with the f32
   arithmetic of the port's ``"torch"`` renderer (``ops/trace.py``, the same
   colour bits), and writes the decisions.
2. [A2] f32 gradients of the frozen replay: the detached-decision estimator
   on exactly these decisions, so that |f32 - f64| is f32 accumulation
   error alone (the floor).
3. [A3] f64 gradients of the same replay: the oracle. As in the JAX script
   the scene and camera are given in f32 and the chain runs in f64, so the
   gradients come back rounded once to f32.
4. [A4] Per-pixel finite differences of four geometry and camera scalars
   at ``--fd-spp``: the forward-mode derivative (``torch.func.jvp``) of the
   replayed colour image against its central FD, both f64, summarised by
   the gross-normalised error |J-D|_1 / (|J|_1 + |D|_1) and per-pixel
   quantiles (the JAX script's docstring says why per pixel).

Each phase prints its seconds and, on a card, ``torch.cuda.max_memory_allocated``.

Usage, from the root of a checkout:

    python scripts/torch_grad_oracle.py [--size 512] [--spp 32] [--fd-spp 8]
        [--out results/grad_oracle_torch/oracle.npz] [--device cpu|0]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box  # noqa: E402
from pathtrace_tpu_torch.convert import decisions_to_npz  # noqa: E402
from pathtrace_tpu_torch.ops import frozen  # noqa: E402
from pathtrace_tpu_torch.render import resolve_device  # noqa: E402

# (name, eps): the step on each parameter's FD plateau, the JAX script's.
FD_PROBES = (("sphere6_radius", 2e-5), ("sphere6_pos_z", 2e-4), ("camera_pos_z", 2e-3),
             ("camera_yaw", 5e-5))


def tree_to_flat(ds, dc):
    """The seven gradient blocks under the oracle files' names, f64."""
    blocks = {
        "d_radius": ds.radius, "d_position": ds.position, "d_emission": ds.emission,
        "d_albedo": ds.color, "d_cam_position": dc.position, "d_cam_yaw": dc.yaw,
        "d_cam_pitch": dc.pitch,
    }
    return {k: v.detach().to("cpu", torch.float64).numpy() for k, v in blocks.items()}


def perturbation(name, scene64, cam64):
    """h -> (scene, camera) with probe ``name``'s parameter moved by h."""

    def unit(shape, index):
        e = torch.zeros(shape, dtype=torch.float64, device=scene64.device)
        e[index] = 1.0
        return e

    if name == "sphere6_radius":
        e = unit(scene64.radius.shape, 6)
        return lambda h: (scene64.replace(radius=scene64.radius + h * e), cam64)
    if name == "sphere6_pos_z":
        e = unit(scene64.position.shape, (6, 2))
        return lambda h: (scene64.replace(position=scene64.position + h * e), cam64)
    if name == "camera_pos_z":
        e = unit((3,), 2)
        return lambda h: (scene64, Camera(cam64.position + h * e, cam64.yaw, cam64.pitch,
                                          dtype=torch.float64))
    if name == "camera_yaw":
        return lambda h: (scene64, Camera(cam64.position, cam64.yaw + h, cam64.pitch,
                                          dtype=torch.float64))
    raise ValueError(name)


def fd_row(J, D):
    """(gross, p50, p90, p99, p99.9, active share, net J, net D) of a
    per-pixel jvp J against the central FD D."""
    mag = np.abs(J) + np.abs(D)
    gross = float(np.abs(J - D).sum() / max(mag.sum(), 1e-300))
    sel = mag > 1e-3 * mag.max()
    err = np.abs(J - D) / np.maximum(mag, 1e-300)
    q = np.quantile(err[sel], [0.5, 0.9, 0.99, 0.999])
    return (gross, *map(float, q), float(sel.mean()), float(J.sum()), float(D.sum()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--fd-spp", type=int, default=8)
    ap.add_argument("--out", type=str, default="results/grad_oracle_torch/oracle.npz")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    dev = resolve_device(None if args.device is None else
                         (int(args.device) if args.device.isdigit() else args.device))
    on_card = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False

    def phase_done(tag, what, t0):
        mem = ""
        if on_card:
            torch.cuda.synchronize(dev)
            mem = f", peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB allocated"
        print(f"[{tag}] {what} in {time.perf_counter() - t0:.2f} s{mem}", flush=True)

    scene, cam = cornell_box(), Camera.create()
    S, SPP = args.size, args.spp
    cfg = RenderConfig(width=S, height=S, spp=SPP, backend="torch", spp_chunk=2, nee=True)
    # The FD probes replay a prefix of the chunks: whole chunks only.
    if args.fd_spp <= 0 or args.fd_spp % cfg.spp_chunk or args.fd_spp > SPP:
        ap.error(f"--fd-spp {args.fd_spp} must be a positive multiple of spp_chunk="
                 f"{cfg.spp_chunk}, at most --spp")
    target = torch.zeros((S, S, 3), dtype=torch.float32, device=dev)
    stamp = {"size": S, "spp": SPP, "seed": cfg.seed, "max_bounces": cfg.max_bounces,
             "brdf": np.array(cfg.brdf), "nee": cfg.nee, "light_index": cfg.light_index,
             "spp_chunk": cfg.spp_chunk}
    out = {"fd_spp": args.fd_spp, **stamp}
    print(f"device {dev}" + (f" ({torch.cuda.get_device_name(dev)})" if on_card else "")
          + f", torch {torch.__version__}; Cornell {S}^2 x {SPP} spp x {cfg.max_bounces}, NEE, "
          f"chunks of {cfg.spp_chunk}", flush=True)

    t0 = time.perf_counter()
    color, recs = frozen.record_frame(scene, cam, cfg, device=dev)
    out["record_color"] = color.to("cpu").numpy().astype(np.float32)
    phase_done("A1", f"recorded {S}^2 x {SPP} spp ({len(recs)} chunks)", t0)

    dec_path = os.path.join(os.path.dirname(args.out) or ".", "decisions.npz")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    decisions_to_npz(dec_path, recs, stamp)
    print(f"[A1] wrote {dec_path}", flush=True)

    for tag, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        t0 = time.perf_counter()
        loss, (ds, dc) = frozen.replay_loss_grads(scene, cam, cfg, 0, recs, target, dtype=dtype,
                                                  device=dev)
        out[f"loss_{tag}"] = float(loss)
        for k, v in tree_to_flat(ds, dc).items():
            out[f"{tag}_{k}"] = v
        phase_done("A2" if tag == "f32" else "A3", f"{tag} replay loss and gradients", t0)

    cfg_fd = dataclasses.replace(cfg, spp=args.fd_spp)
    recs_fd = recs[: args.fd_spp // cfg.spp_chunk]
    scene64 = scene.to(dev).astype(torch.float64)
    cam64 = cam.to(dev).astype(torch.float64)
    rows = []
    for name, eps in FD_PROBES:
        t0 = time.perf_counter()
        J, D = frozen.pixel_jvp_fd(perturbation(name, scene64, cam64), cfg_fd, 0, recs_fd, eps,
                                   device=dev)
        row = fd_row(J, D)
        rows.append((name, eps, *row))
        gross, p50, p90, p99, p999, active, net_j, net_d = row
        print(f"[A4] {name}: gross={gross:.2e} p50={p50:.2e} p90={p90:.2e} p99={p99:.2e} "
              f"p99.9={p999:.2e} active={active * 100:.1f}% netJ={net_j:.4e} netD={net_d:.4e} "
              f"eps={eps:g}", flush=True)
        phase_done("A4", f"{name} at {S}^2 x {args.fd_spp} spp", t0)
    out["fd_names"] = np.array([r[0] for r in rows])
    for i, k in enumerate(["eps", "gross", "p50", "p90", "p99", "p999", "active", "netJ",
                           "netD"], start=1):
        out[f"fd_{k}"] = np.array([r[i] for r in rows], np.float64)

    np.savez_compressed(args.out, **out)
    print(f"[done] wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
