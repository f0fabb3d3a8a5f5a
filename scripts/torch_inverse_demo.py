"""Inverse rendering on the PyTorch port: the albedo, geometry and glossy recoveries.

The port of scripts/inverse_demo.py, through
``pathtrace_tpu_torch.inverse.recover_scene``. Each case starts from a
deliberately corrupted Cornell box, renders a 64-spp target (frame 987654)
from the true one, and runs Adam on the cross-estimator:

1. **albedo** (diffuse): all 9 albedos perturbed by U(-0.35, 0.35) (seed
   0), clipped to [0.05, 0.95]; --spp samples a step, lr 2e-2. On the card,
   two dump launches of the product-chain kernel a step.
2. **geometry** (NEE, 16 samples a step): sphere 6 displaced by (6, -4, 8)
   and shrunk 20%; its position and radius at rates 0.5 and 0.1 decaying
   to x0.02 over the run, gradients masked to sphere 6. On the card, two
   colour passes of the trace kernel and two NEE replays a step.
3. **glossy**: case 1 under the glossy BRDF. On the card, two colour
   passes and two launches of the all-parameter backward a step.

Writes under --out (no default): ``INVERSE.md`` (the errors before and
after, the first and last loss), ``losses.json`` and, for each case,
``inverse_{case}_{before,after,target}.png`` (--preview-spp renders of
the corrupted, recovered and true scenes). ``docs/INVERSE.md`` is the JAX
package's record and is not written here.

Usage, from the root of a checkout:

    python scripts/torch_inverse_demo.py --out DIR [--size 256] [--spp 8] [--steps 400]
        [--preview-spp 256] [--backend auto|cuda|torch] [--device cpu|0]

``--backend cuda`` on the CPU runs the kernels' plain versions; ``auto`` is
the kernels on a card and autograd through the wavefront on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CASES = ("albedo", "geometry", "glossy")
TARGET_SPP = 64
PREVIEW_FRAME = 123456


def corrupted_albedo(scene):
    bad = np.clip(scene.color.numpy() + np.random.default_rng(0).uniform(-0.35, 0.35, (9, 3)),
                  0.05, 0.95).astype(np.float32)
    return scene.replace(color=bad)


def corrupted_geometry(scene):
    pos, rad = scene.position.numpy().copy(), scene.radius.numpy().copy()
    pos[6] += np.array([6.0, -4.0, 8.0], np.float32)
    rad[6] *= 0.8
    return scene.replace(position=pos, radius=rad)


def run_case(name, args, device):
    """One recovery -> (markdown rows, losses, {before, after, target} scenes)."""
    import torch
    from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box, inverse

    scene, cam = cornell_box(), Camera.create()
    extra = {"geometry": {"nee": True}, "glossy": {"brdf": "glossy"}}.get(name, {})
    spp = 16 if name == "geometry" else args.spp
    cfg = RenderConfig(width=args.size, height=args.size, spp=spp, backend=args.backend, **extra)
    if name == "geometry":
        bad = corrupted_geometry(scene)
        mask_pos, mask_rad = torch.zeros(9, 1), torch.zeros(9)
        mask_pos[6] = mask_rad[6] = 1.0
        kw = dict(optimize=("position", "radius"),
                  learning_rate={"position": inverse.exponential_decay(0.5, args.steps, 0.02),
                                 "radius": inverse.exponential_decay(0.1, args.steps, 0.02)},
                  grad_mask={"position": mask_pos, "radius": mask_rad})
    else:
        bad = corrupted_albedo(scene)
        kw = dict(optimize=("color",), learning_rate=2e-2)
    t0 = time.perf_counter()
    rec, losses = inverse.recover_scene(scene, bad, cam, cfg, steps=args.steps,
                                        target_spp=TARGET_SPP, device=device, **kw)
    rec = rec.to("cpu")
    print(f"[{name}] {args.steps} steps in {time.perf_counter() - t0:.1f} s, loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}", flush=True)
    if name == "geometry":
        rows = [("sphere[6] position (L2 dist)",
                 float(torch.linalg.norm(bad.position[6] - scene.position[6])),
                 float(torch.linalg.norm(rec.position[6] - scene.position[6]))),
                ("sphere[6] radius (abs err)", float(abs(bad.radius[6] - scene.radius[6])),
                 float(abs(rec.radius[6] - scene.radius[6])))]
    else:
        rows = [(f"{name} albedo (9 spheres x RGB, mean abs err)",
                 float((bad.color - scene.color).abs().mean()),
                 float((rec.color - scene.color).abs().mean()))]
    return rows, losses, {"before": bad, "after": rec, "target": scene}, cfg


def main(argv=None) -> int:
    import torch
    from pathtrace_tpu_torch import Camera, render_aovs
    from pathtrace_tpu_torch.cli import device_arg, resolve_device_arg
    from pathtrace_tpu_torch.io.png import write_png

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="Directory for INVERSE.md and the PNGs")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--spp", type=int, default=8, help="Samples a step (albedo, glossy)")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--preview-spp", type=int, default=256)
    ap.add_argument("--backend", choices=["auto", "cuda", "torch"], default="auto")
    ap.add_argument("--device", type=device_arg, default=0,
                    help="CUDA device index to run on, or 'cpu'")
    args = ap.parse_args(argv)
    device, err = resolve_device_arg(args.device)
    if err:
        print(f"ERROR: {err}", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)

    cam = Camera.create()
    table, curves = [], {}
    for name in CASES:
        rows, losses, scenes, cfg = run_case(name, args, device)
        table += rows
        curves[name] = losses
        pcfg = dataclasses.replace(cfg, spp=args.preview_spp, spp_chunk=8)
        for kind, scene in scenes.items():
            color = render_aovs(scene, cam, pcfg, frame=PREVIEW_FRAME, device=device)["color"]
            write_png(os.path.join(args.out, f"inverse_{name}_{kind}.png"), color.cpu().numpy())
    with open(os.path.join(args.out, "losses.json"), "w") as f:
        json.dump(curves, f)

    md = ["# Inverse rendering on the PyTorch port", "",
          f"Generated by `scripts/torch_inverse_demo.py` on {time.strftime('%Y-%m-%d')}: "
          f"Cornell box {args.size}^2, {args.steps} Adam steps a case, backend "
          f"`{args.backend}` on {torch.device(device)}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
          + f", targets at {TARGET_SPP} spp. Losses: `losses.json`.", "",
          "| parameter block | error (corrupted) | error (recovered) |", "|---|---|---|"]
    md += [f"| {label} | {before:.4f} | {after:.4f} |" for label, before, after in table]
    md += ["", "| case | loss, step 1 | loss, last step |", "|---|---|---|"]
    md += [f"| {name} | {losses[0]:.6f} | {losses[-1]:.6f} |" for name, losses in curves.items()]
    for name in curves:
        cells = " | ".join(f"![{k}](inverse_{name}_{k}.png)" for k in ("before", "after", "target"))
        md += ["", f"## {name}", "", "| corrupted | recovered | target (true scene) |",
               "|---|---|---|", f"| {cells} |"]
    path = os.path.join(args.out, "INVERSE.md")
    with open(path, "w") as f:
        f.write("\n".join(md) + "\n")
    print(f"[done] wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
