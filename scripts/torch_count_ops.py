"""Count the operations a path segment of the gradient kernels (K2-K5).

    python scripts/torch_count_ops.py [--size 16] [--bounces 5]

The bound of a kernel in PERF.md is traced segments x operations a segment
over the card's f32 peak. For the forward kernels the JAX package counted
the operations by walking a jaxpr (docs/ROOFLINE.md); for the hand-derived
sweeps there is no jaxpr, so this script counts the kernels' plain PyTorch
versions instead, which run the kernels' formulas in the kernels' order: a
``TorchDispatchMode`` tallies every elementwise aten call, one operation an
element a call, as ``count_jaxpr_ops`` does (a multiply and an add are two;
selects, compares, conversions and the integer hashes of the random lattice
count one each; views, gathers and constants none). A call on a [size, size]
tile counts one; a call on the sums of the lane groups, which is one lane's
turn, counts its share of the tile's elements. A launch's set-up is taken
out by counting two samples and one and keeping the difference. Runs on
the CPU in seconds: the counts do not depend on the device.

Everything is for a sample in the closed Cornell box (every bounce hits),
divided by the bounces:

- ``forward_untaped``: one forward sample without a tape (a colour pass,
  ``PlainLattice.sample``); ``forward_plain``: the same with the plain
  version's tape, which keeps the winner's index, radius and root by a
  masked select for each of the N spheres;
- ``forward``: the taped forward as the kernels do it, which keep the
  winner's index and read the rest once: the tape's per-sphere cost is
  measured by adding a tenth sphere that no ray meets and taken out for all
  spheres but one. Where the geometry chain is dead (the shading-only
  instances and the product-chain kernel) the tape is the index and the
  throughput alone: the untaped forward plus one select;
- ``sweep_plain``: the rest of a sample of the plain version, where a sum
  indexed by the hit sphere is a masked add into each of the N spheres'
  slots;
- ``sweep``: the same with one slot a run-time index, as the kernels do it
  in shared memory: the per-sphere cost is taken out in the same way;
- ``total``: forward + sweep, the count behind a bound.

``count_all`` gives the entries of ``utils/roofline.py::OPS_PER_SEGMENT``:
the forward kernel's glossy colour pass (``color_glossy``, the untaped
forward), the all-parameter backward (K4) by configuration, against a colour + AOV
cotangent and against a colour cotangent alone (without NEE that is the
shading-only instance; on NEE diffuse it is also K3's replay), and the
product-chain kernel (K2 fused and dump, K5 replay). For K3's fused mode it
counts the kernel's two loops (a colour pass, then the replay:
``nee_grad_two_pass``); the loss and its gradients need one pass over the
samples, so the bound (``nee_grad_fused``) is the smaller of that and the
count of the JAX package's one-pass form.
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
from pathtrace_tpu_torch.ops import grad_kernel as gk  # noqa: E402
from pathtrace_tpu_torch.ops import sweep  # noqa: E402
from pathtrace_tpu_torch.ops import trace_kernel as tk  # noqa: E402
from pathtrace_tpu_torch.utils.roofline import OPS_PER_SEGMENT  # noqa: E402

# aten calls that move no data through an arithmetic unit
FREE = ("view", "expand", "alias", "detach", "unbind", "select", "slice", "unsqueeze",
        "squeeze", "permute", "t.", "empty", "zeros", "ones", "full", "arange", "lift_fresh",
        "broadcast", "as_strided", "stack", "cat", "clone", "copy_", "_local_scalar_dense",
        "index", "new_", "reshape", "_unsafe_view", "_reshape_alias")
# A tenth sphere behind the camera, too small and too far to meet a ray.
EXTRA_SPHERE = [[1e-3, 50.0, 40.0, 1.0e4, 0.0, 0.0, 0.0, 0.5, 0.5, 0.5]]
INDEX_SELECT = 1.0  # keeping the winner's index: one select a sphere test


class OpCounter(TorchDispatchMode):
    """Counts aten calls by their share of a tile of ``numel`` elements: 1
    for a call on the tile, 1 / lanes for a call on the lane groups' sums."""

    def __init__(self, numel: int):
        super().__init__()
        self.numel = numel
        self.count = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.__name__
        first = out[0] if isinstance(out, (tuple, list)) and out else out
        if (isinstance(first, torch.Tensor) and first.numel() in self.sizes()
                and not any(name.startswith(f) for f in FREE)):
            self.count += first.numel() / self.numel
        return out

    def sizes(self):
        return (self.numel, self.numel // sweep.LANES)


def count(fn, numel: int) -> float:
    with OpCounter(numel) as counter:
        fn()
    return counter.count


def per_sample(fn_of_spp, numel: int) -> float:
    """Operations an element of one more sample: two samples less one."""
    return count(lambda: fn_of_spp(2), numel) - count(lambda: fn_of_spp(1), numel)


def closed_lattice(cfg: RenderConfig, scene_block, cam_block):
    lat = tk.PlainLattice(scene_block, cam_block, tk.make_seed_block(cfg, 0), cfg, cfg.height)
    for s in range(2):
        tape = []
        lat.sample(s, cfg, tape)
        if not all(bool(hit.all()) for hit, *_ in tape):
            raise RuntimeError("a path left the box: the count a segment would be off")
    return lat


def without_other_spheres(count_n, count_n1, n: int) -> float:
    """``count_n`` (N spheres) with the per-sphere cost (``count_n1`` has one
    sphere more) taken out for all spheres but one."""
    return count_n - (n - 1) * (count_n1 - count_n)


def kernel_forward(taped, untaped, n: int, geom: bool, bounces: int) -> float:
    """Operations a sample of the taped forward as the kernels do it, from
    (N spheres, N + 1 spheres) counts of the plain version's taped and
    untaped forward. ``geom``: the tape holds the geometry (index, radius
    and root of one sphere, and what is taped once a bounce); else the
    index alone."""
    if not geom:
        return untaped[0] + INDEX_SELECT * bounces
    per_sphere = (taped[1] - taped[0]) - (untaped[1] - untaped[0])
    return taped[0] - (n - 1) * per_sphere


def count_sweep(brdf: str, nee: bool, aov: bool, size: int = 16, bounces: int = 5) -> dict:
    """Operations a segment of the shared reverse sweep's instance."""
    cfg = RenderConfig(width=size, height=size, spp=2, brdf=brdf, nee=nee, max_bounces=bounces)
    sb = cornell_box().packed()
    cb = tk.camera_block(Camera.create(), cfg)
    ct = [torch.full((size, size), 0.1) for _ in range(10)]
    numel = size * size
    rows = []
    for block in (sb, torch.cat([sb, torch.tensor(EXTRA_SPHERE)])):
        lat = closed_lattice(cfg, block, cb)
        forward = count(lambda: lat.sample(0, cfg, []), numel)
        untaped = count(lambda: lat.sample(0, cfg), numel)
        total = per_sample(
            lambda spp: sweep._sweep_plain(lat, cfg, spp, ct[:3], ct[3:] if aov else None), numel)
        rows.append((forward, untaped, total - forward))
    (f9, u9, s9), (f10, u10, s10) = rows
    n = sb.shape[0]
    forward = kernel_forward((f9, f10), (u9, u10), n, nee or aov, bounces)
    swept = without_other_spheres(s9, s10, n)
    out = dict(forward=forward, forward_plain=f9, forward_untaped=u9, sweep_plain=s9,
               sweep=swept, total=forward + swept, sweep_per_sphere=s10 - s9)
    return {k: v / bounces for k, v in out.items()}


def count_chain(replay: bool, size: int = 16, bounces: int = 5) -> dict:
    """Operations a segment of the product-chain kernel: its fused and dump
    modes (cotangent-free accumulators) or its replay."""
    cfg = RenderConfig(width=size, height=size, spp=2, max_bounces=bounces)
    sb = cornell_box().packed()
    cb = tk.camera_block(Camera.create(), cfg)
    ct = [torch.full((size, size), 0.1) for _ in range(3)] if replay else None
    seed = tk.make_seed_block(cfg, 0)
    numel = size * size
    rows = []
    for block in (sb, torch.cat([sb, torch.tensor(EXTRA_SPHERE)])):
        lat = closed_lattice(cfg, block, cb)
        forward = count(lambda: lat.sample(0, cfg, []), numel)
        untaped = count(lambda: lat.sample(0, cfg), numel)
        total = per_sample(
            lambda spp: gk._sweep_plain(block, cb, seed, cfg, size, spp, None, ct), numel)
        rows.append((forward, untaped, total - forward))
    (f9, u9, s9), (f10, u10, s10) = rows
    n = sb.shape[0]
    forward = kernel_forward((f9, f10), (u9, u10), n, False, bounces)
    swept = without_other_spheres(s9, s10, n)
    out = dict(forward=forward, forward_plain=f9, forward_untaped=u9, sweep_plain=s9,
               sweep=swept, total=forward + swept)
    return {k: v / bounces for k, v in out.items()}


def count_all(size: int = 16, bounces: int = 5) -> tuple[dict, dict]:
    """({``OPS_PER_SEGMENT`` key: operations a segment}, the rows behind)."""
    ops, rows = {}, {}
    for brdf in ("diffuse", "glossy"):
        for nee in (False, True):
            name = {("diffuse", False): "diffuse", ("diffuse", True): "nee",
                    ("glossy", False): "glossy", ("glossy", True): "nee_glossy"}[brdf, nee]
            for aov in (True, False):
                key = f"ad_{name}" + ("" if aov else "_color")
                rows[key] = count_sweep(brdf, nee, aov, size, bounces)
                ops[key] = rows[key]["total"]
    # K3 fused as the kernel runs it: a colour pass over the samples, then
    # the replay; what it is held to: no more than one pass needs.
    ops["nee_grad_two_pass"] = rows["ad_nee_color"]["forward_untaped"] + ops["ad_nee_color"]
    ops["nee_grad_fused"] = min(ops["nee_grad_two_pass"],
                                OPS_PER_SEGMENT["nee_grad_one_pass_jaxpr"])
    # The forward kernel's glossy colour pass (K1, 3 channels): the untaped
    # forward, which no jaxpr of the JAX package counts.
    ops["color_glossy"] = rows["ad_glossy_color"]["forward_untaped"]
    for key, replay in (("grad_fused", False), ("grad_replay", True)):
        rows[key] = count_chain(replay, size, bounces)
        ops[key] = rows[key]["total"]
    return ops, rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=16)
    ap.add_argument("--bounces", type=int, default=5)
    args = ap.parse_args()
    ops, rows = count_all(args.size, args.bounces)
    for name, row in rows.items():
        print(f"{name:20s} " + "  ".join(f"{k} {v:.1f}" for k, v in row.items()))
    for name, v in ops.items():
        print(f"OPS_PER_SEGMENT[{name!r}] = {v:.1f}")
    print(json.dumps({"ops_per_segment": ops, "rows": rows, "size": args.size,
                      "bounces": args.bounces, "spheres": 9}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
