"""The geometry recovery of scripts/inverse_demo.py (its case 2) on the PyTorch port.

Sphere 6 of the Cornell box is displaced by (6, -4, 8) and shrunk 20%; its
position and radius are optimized under NEE at 16 spp a step against a
64-spp target (frame 987654), with learning rates 0.5 and 0.1 decaying to
x0.02 over the run and gradients masked to that sphere: what
``inverse_demo.py`` does through the JAX package, here through
``pathtrace_tpu_torch.inverse.make_inverse_step``. No images are written;
sphere 6's errors are printed every 50 steps and at the end.

The estimator has no silhouette terms, and how far the sphere comes back
along the view axis may depend on the sample lattice. ``--lattices N``
repeats the run N times, run k drawing the frames of steps 10000 k onwards
(the schedule still starts at its first value), and prints the spread of
the final errors.

Usage, from the root of a checkout:

    python scripts/torch_inverse_geometry.py [--backend cuda|torch] [--device cuda:0|cpu]
        [--size 256] [--steps 400] [--lattices 1]

``--backend cuda`` on a CUDA device is the kernel route (two colour passes
of the trace kernel and two NEE replays a step), ``--backend torch`` is
autograd through the wavefront, on either device.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LATTICE_STRIDE = 10000  # steps between two runs' first frames


def recover(args, first_step: int):
    """One run -> (position offset [3], radius error) of sphere 6 at the end."""
    import torch
    from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box, inverse, render_aovs
    from pathtrace_tpu_torch.scene import Scene

    dev = torch.device(args.device)
    scene, cam = cornell_box(), Camera.create()
    pos_true, rad_true = scene.position.numpy(), scene.radius.numpy()
    bad_pos, bad_rad = pos_true.copy(), rad_true.copy()
    bad_pos[6] += np.array([6.0, -4.0, 8.0], np.float32)
    bad_rad[6] *= 0.8
    corrupted = Scene(bad_rad, bad_pos, scene.emission, scene.color)
    pos_mask, rad_mask = torch.zeros(9, 1), torch.zeros(9)
    pos_mask[6] = rad_mask[6] = 1.0

    cfg = RenderConfig(width=args.size, height=args.size, spp=16, nee=True,
                       backend=args.backend)
    target = render_aovs(scene, cam, dataclasses.replace(cfg, spp=64, backend="auto"),
                         frame=987654, device=dev)["color"]

    def decaying(init):
        schedule = inverse.exponential_decay(init, args.steps, 0.02)
        return lambda step: schedule(max(step - first_step, 0))

    state, step_fn, _ = inverse.make_inverse_step(
        corrupted, cam, cfg, target, ("position", "radius"),
        {"position": decaying(0.5), "radius": decaying(0.1)},
        grad_mask={"position": pos_mask, "radius": rad_mask}, device=dev)
    state = state._replace(step=first_step)
    t0 = time.perf_counter()
    for i in range(args.steps):
        state, loss = step_fn(state)
        if i == 0 or (i + 1) % 50 == 0 or i + 1 == args.steps:
            off = state.params["position"].detach().cpu().numpy()[6] - pos_true[6]
            rad_err = abs(float(state.params["radius"].detach()[6]) - rad_true[6])
            print(f"backend={args.backend} {args.size}x{args.size} first frame "
                  f"{2 * first_step} step {i + 1}/{args.steps}: loss {float(loss):.6f}, "
                  f"position error {np.linalg.norm(off):.3f} (offset "
                  f"{np.round(off, 2).tolist()}), radius error {rad_err:.3f}, "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    return off, rad_err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("cuda", "torch"), default="cuda")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--lattices", type=int, default=1)
    args = ap.parse_args()

    ends = [recover(args, LATTICE_STRIDE * k) for k in range(args.lattices)]
    pos = [float(np.linalg.norm(off)) for off, _ in ends]
    along = [float(off[2]) for off, _ in ends]
    rad = [float(r) for _, r in ends]
    print(f"backend={args.backend} {args.size}x{args.size} {args.steps} steps, "
          f"{args.lattices} lattice(s), errors at the end (start: position 10.770, along the "
          f"view axis 8.00, radius 3.300):")
    for name, v in (("position", pos), ("along the view axis", along), ("radius", rad)):
        print(f"  {name}: min {min(v):.3f}, median {statistics.median(v):.3f}, max "
              f"{max(v):.3f}; runs {[round(x, 3) for x in v]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
