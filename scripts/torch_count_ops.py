"""Count the operations a path segment of the all-parameter backward (K4).

    python scripts/torch_count_ops.py [--size 16] [--bounces 5]

The bound of a kernel in PERF.md is traced segments x operations a segment
over the card's f32 peak. For the forward kernels the JAX package counted
the operations by walking a jaxpr (docs/ROOFLINE.md); for the hand-derived
reverse sweep there is no jaxpr, so this script counts the kernel's plain
PyTorch version instead, which runs the kernel's formulas in the kernel's
order: a ``TorchDispatchMode`` tallies every elementwise aten call on a
[size, size] tile, one operation an element a call, as ``count_jaxpr_ops``
does (a multiply and an add are two; selects, compares and the integer
hashes of the random lattice count one each; views and constants none).
Runs on the CPU in seconds: the counts do not depend on the device.

For each configuration (diffuse or glossy, with or without NEE), a sample in
the closed Cornell box (every bounce hits), divided by the bounces:

- ``forward``: one taped forward sample (``PlainLattice.sample``);
- ``sweep_plain``: the reverse sweep as the plain version runs it, where an
  accumulator indexed by the hit sphere is a masked add into each of the N
  spheres' slots;
- ``sweep``: the same with one slot a run-time index, as the kernel does it
  in shared memory: the per-sphere cost is measured by adding a tenth
  sphere that no ray meets and taken out for all spheres but one;
- ``k4``: forward + sweep, the count behind K4's bound.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box  # noqa: E402
from pathtrace_tpu_torch.ops import nee_grad_kernel as nk  # noqa: E402
from pathtrace_tpu_torch.ops import trace_kernel as tk  # noqa: E402

# aten calls that move no data through an arithmetic unit
FREE = ("view", "expand", "alias", "detach", "unbind", "select", "slice", "unsqueeze",
        "squeeze", "permute", "t.", "empty", "zeros", "ones", "full", "arange", "lift_fresh",
        "broadcast", "as_strided", "stack", "cat", "clone", "copy_", "_local_scalar_dense")


class OpCounter(TorchDispatchMode):
    """Counts aten calls whose output has ``numel`` elements."""

    def __init__(self, numel: int):
        super().__init__()
        self.numel = numel
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.__name__
        first = out[0] if isinstance(out, (tuple, list)) and out else out
        if (isinstance(first, torch.Tensor) and first.numel() == self.numel
                and not any(name.startswith(f) for f in FREE)):
            self.count += 1
        return out


def count(fn, numel: int) -> int:
    with OpCounter(numel) as counter:
        fn()
    return counter.count


def counts_for(cfg: RenderConfig, scene_block, cam_block) -> tuple[int, int]:
    """(forward, forward + sweep) operations an element for one sample."""
    size = cfg.height
    lat = tk.PlainLattice(scene_block, cam_block, tk.make_seed_block(cfg, 0), cfg, size)
    ct = [torch.full((size, size), 0.1) for _ in range(10)]
    tape = []
    lat.sample(0, cfg, tape)
    if not all(bool(hit.all()) for hit, *_ in tape):
        raise RuntimeError("a path left the box: the count a segment would be off")
    forward = count(lambda: lat.sample(0, cfg, []), size * size)
    both = count(lambda: nk._sweep_plain(lat, cfg, 1, ct[:3], ct[3:]), size * size)
    return forward, both


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=16)
    ap.add_argument("--bounces", type=int, default=5)
    args = ap.parse_args()
    scene, cam = cornell_box(), Camera.create()
    sb = scene.packed()
    # A tenth sphere behind the camera, too small and too far to meet a ray.
    extra = torch.tensor([[1e-3, 50.0, 40.0, 1.0e4, 0.0, 0.0, 0.0, 0.5, 0.5, 0.5]])
    out = {}
    for brdf in ("diffuse", "glossy"):
        for nee in (False, True):
            cfg = RenderConfig(width=args.size, height=args.size, spp=2, brdf=brdf, nee=nee,
                               max_bounces=args.bounces)
            cb = tk.camera_block(cam, cfg)
            f9, t9 = counts_for(cfg, sb, cb)
            f10, t10 = counts_for(cfg, torch.cat([sb, extra]), cb)
            per_sphere = (t10 - f10) - (t9 - f9)
            n = sb.shape[0]
            sweep_plain = t9 - f9
            sweep = sweep_plain - (n - 1) * per_sphere
            name = ("nee_" if nee else "") + brdf
            out[name] = {k: v / args.bounces for k, v in (
                ("forward", f9), ("sweep_plain", sweep_plain), ("sweep", sweep),
                ("k4", f9 + sweep))}
            out[name]["forward_per_sphere"] = (f10 - f9) / args.bounces
            out[name]["sweep_per_sphere"] = per_sphere / args.bounces
    for name, row in out.items():
        print(f"{name:12s} " + "  ".join(f"{k} {v:.1f}" for k, v in row.items()))
    print(json.dumps({"ops_per_segment": out, "size": args.size, "bounces": args.bounces,
                      "spheres": int(sb.shape[0])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
