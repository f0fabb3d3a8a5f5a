"""Benchmark of the port on one CUDA device: one JSON line a cell group.

The counterpart of the repo's root ``bench.py``, with its cells, its field
names letter for letter and its one-JSON-line contract. The headline is the
forward kernel's throughput on the bench frame (Cornell box, 512x512, 32
spp, 5 bounces) in Mrays/s, rays being W*H*spp*bounces path segments. The
inputs are ``scene.cornell_box()``, ``Camera.create()`` and zero targets.
Each cell calls one of the port's own entry points:

- ``value``, ``pallas_fwd_ms``: ``trace_kernel.render_channels`` (K1, 14
  channels);
- ``sharded_1dev_fwd_mrays``: ``shard.render_channels_sharded`` on
  ``make_mesh(tiles=1, samples=1)`` in a process with no process group
  (every collective is the identity, as in a 1-device ``shard_map``);
- ``pallas_fwd_bwd_mrays``: ``grad_kernel.loss_and_grads``, diffuse (K2
  fused); scalar loss + sum of d emission;
- ``ad_fwd_bwd_mrays`` (``ad_backend`` "hand_nee_sweep"): the same entry
  point with NEE, which launches K3 fused; scalar loss + sum of d emission
  + sum of d camera position;
- ``vjp_fwd_bwd_mrays``: ``ad_grad_kernel.ad_loss_and_grads`` with NEE (K1
  colour sums, then K4);
- ``sharded_1dev_fwd_bwd_mrays``: ``shard.sharded_loss_grads`` on the same
  mesh, diffuse (K2 dump);
- ``counted_flops_per_segment``, ``achieved_tflops``, ``peak_fma_tflops``,
  ``mfu``, ``vpu_issue_util``: the forward kernel's counted operations
  (``FORWARD_OPS_PER_SEGMENT``) over the headline's seconds, against the
  f32 peaks that ``roofline.measure_f32_peak`` (K6) reads on this card;
- ``inverse_step_ms``: ``grad_kernel.cross_grads`` at 256x256x8 (two K2
  dumps and the contraction); scalar loss + sum of g color + sum of g
  emission;
- ``denoised_frame_ms``, ``denoised_frame_fps``: a 4-spp render through K1,
  then what ``models.infer.denoise_channels`` does with a model object
  (``preprocess_channels``, the full-width ``DenoiseCNN`` with weights from
  ``init_model`` seed 0, channels-last, ``eval()``, inference mode, f32 with
  TF32 off);
- ``jnp_fwd_mrays``, ``fwd_bwd_mrays``: the names bench.py gives its jnp
  legs, kept; here they time the plain PyTorch wavefront
  (``render.render_channels`` with ``backend="torch"``, spp chunks of 8
  above 8 spp) and autograd through it (``grad.render_loss_grads``). They
  run under ``--full``, and they are the only legs with ``--device cpu``.

``--quick`` is 128x128 at 4 spp and skips the inverse step and the denoised
frame; ``--no-grad`` skips every loss and gradient cell.

Timing: a sample is ``k`` back-to-back calls with frames f0, f0 + 1, ...,
each call's scalar added into an accumulator on the device (a data
dependency and no host sync), bracketed by two CUDA events on the current
stream; on the CPU by the host clock. ``k`` is 128 for the headline, 32 for
the two NEE cells, 64 elsewhere, at most 8 under ``--quick``. After one
warm-up sample a card cell takes ``CARD_SAMPLES`` samples and a plain leg
``PLAIN_SAMPLES`` (one plain call at the full size takes about a second).
Each field is the median per call; ``samples`` and ``calls`` give each
field's N and k, and ``spread`` its (max - min) / median over the N
samples. bench.py reports the best of its repeats instead; the median and
its spread are chosen on purpose, so that a reader sees how much a number
moves.

The line also carries ``device`` (the card's name and power limit as
``nvidia-smi`` prints them), ``build_s`` (the nvcc build of the five
kernel libraries, timed apart from the cells) and ``kernels_cached`` (every
library existed already). The first line is printed as soon as the headline
is measured, and the line again after each group where bench.py prints it;
the last line is the complete record. ``vs_baseline`` and ``vs_prior``
compare with the best earlier record of the same field among the
``BENCH_r*.json`` files at the repo's root whose backend is ``"cuda"``: a
TPU record is no baseline for the card.

It runs on the current CUDA device, or ``--device N`` / ``--device cpu``.
Without CUDA and without ``--device cpu`` it exits 1 and prints no result.

Usage: python -m pathtrace_tpu_torch.bench [--size 512] [--spp 32]
[--bounces 5] [--quick] [--no-grad] [--full] [--device N|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from pathtrace_tpu_torch.cli import device_arg
from pathtrace_tpu_torch.config import RenderConfig
from pathtrace_tpu_torch.render import resolve_device
from pathtrace_tpu_torch.utils.timing import device_name, mrays_per_sec

REPO_ROOT = Path(__file__).resolve().parents[1]
K_HEADLINE, K_NEE, K_DEFAULT, K_QUICK = 128, 32, 64, 8
CARD_SAMPLES, PLAIN_SAMPLES = 10, 3
INVERSE_SIZE, INVERSE_SPP = 256, 8
DENOISE_SPP = 4
# Counted operations a path segment of the forward kernel (14 channels,
# diffuse, 9 spheres, 5 bounces): the JAX package's jaxpr count
# (``roofline.megakernel_ops``; docs/ROOFLINE.md section 1 rounds them to
# 493.6, 60.2 and 14.2, 568.0 in all, ``roofline.OPS_PER_SEGMENT``).
FORWARD_OPS_PER_SEGMENT = {"flops": 493.6087890625, "int_ops": 60.226953125,
                           "transcendentals": 14.2}

# The groups of cells in bench.py's order, with the fields each sets.
GROUP_FIELDS = {
    "fwd": ("pallas_fwd_ms",),
    "sharded_fwd": ("sharded_1dev_fwd_mrays",),
    "fwd_bwd": ("pallas_fwd_bwd_mrays",),
    "nee": ("ad_fwd_bwd_mrays", "ad_backend"),
    "vjp": ("vjp_fwd_bwd_mrays",),
    "sharded_fwd_bwd": ("sharded_1dev_fwd_bwd_mrays",),
    "mfu": ("counted_flops_per_segment", "achieved_tflops", "peak_fma_tflops", "mfu",
            "vpu_issue_util"),
    "inverse": ("inverse_step_ms",),
    "denoised": ("denoised_frame_ms", "denoised_frame_fps"),
    "plain_fwd": ("jnp_fwd_mrays",),
    "plain_fwd_bwd": ("fwd_bwd_mrays",),
}
# bench.py prints the line after these groups, and once more at the end.
EMIT_AFTER = ("fwd", "fwd_bwd", "nee", "vjp", "sharded_fwd_bwd", "mfu")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m pathtrace_tpu_torch.bench",
                                 description="Benchmark of the port; one JSON line a group")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--bounces", type=int, default=5)
    ap.add_argument("--quick", action="store_true", help="128x128x4spp smoke")
    ap.add_argument("--no-grad", action="store_true", help="skip fwd+bwd timing")
    ap.add_argument("--full", action="store_true",
                    help="also time the plain PyTorch wavefront's forward and fwd+bwd")
    ap.add_argument("--device", type=device_arg, default=None,
                    help="CUDA device index, or 'cpu' (default: the current CUDA device)")
    args = ap.parse_args(argv)
    if args.quick:
        args.size, args.spp = 128, 4
    return args


# -- earlier records ----------------------------------------------------------------

def prior_records(root=REPO_ROOT) -> List[dict]:
    """The card's earlier records: ``BENCH_r*.json`` in ``root`` (a record
    wrapped in ``"parsed"`` unwrapped, as bench.py does) whose backend is
    ``"cuda"``."""
    recs = []
    for path in sorted(glob.glob(os.path.join(str(root), "BENCH_r*.json"))):
        try:
            with open(path) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(rec, dict) and "value" not in rec and isinstance(rec.get("parsed"), dict):
            rec = rec["parsed"]
        if isinstance(rec, dict) and rec.get("backend") == "cuda":
            recs.append(rec)
    return recs


def prior_best(recs: List[dict], field: str) -> Optional[float]:
    """The best earlier value of one field (bench.py's ``_prior_best``)."""
    best = None
    for rec in recs:
        try:
            v = float(rec.get(field, 0.0))
        except (TypeError, ValueError):
            continue
        if v > 0 and (best is None or v > best):
            best = v
    return best


def compare_priors(headline: float, extras: dict, recs: List[dict]):
    """(vs_baseline, vs_prior): the headline over the best earlier headline
    (1.0 where there is none), and the same ratio for each throughput field
    (``_mrays``, ``_fps``) that an earlier record also has."""
    prior = prior_best(recs, "value")
    vs_prior = {}
    for field, cur in extras.items():
        if not field.endswith(("_mrays", "_fps")):
            continue
        pv = prior_best(recs, field)
        if pv:
            vs_prior[field] = round(cur / pv, 3)
    return (round(headline / prior, 3) if prior else 1.0), vs_prior


# -- the roofline fields --------------------------------------------------------------

def mfu_fields(width: int, height: int, spp: int, bounces: int, seconds: float,
               peaks: Dict[str, float]) -> dict:
    """bench.py's five roofline fields for a forward frame of ``seconds``,
    from the counted operations a segment and the card's measured peaks
    (``roofline.measure_f32_peak``: ``peak_fma_flops``, ``peak_mul_flops``).
    ``mfu``: counted f32 FLOP/s over the FMA peak; ``vpu_issue_util``: all
    counted operations a second over the rate of single operations."""
    segments = width * height * spp * bounces
    flops = FORWARD_OPS_PER_SEGMENT["flops"] * segments / seconds
    total = sum(FORWARD_OPS_PER_SEGMENT.values()) * segments / seconds
    return {
        "counted_flops_per_segment": FORWARD_OPS_PER_SEGMENT["flops"],
        "achieved_tflops": flops / 1e12,
        "peak_fma_tflops": peaks["peak_fma_flops"] / 1e12,
        "mfu": flops / peaks["peak_fma_flops"],
        "vpu_issue_util": total / peaks["peak_mul_flops"],
    }


# -- the plan and its cells ---------------------------------------------------------

def plan(args, device) -> List[str]:
    """The groups of cells that run, in bench.py's order, for ``args`` on
    ``device``: the card's cells on a CUDA device (bench.py's TPU branch),
    the plain legs under ``--full`` and on the CPU (its only legs off the
    TPU)."""
    on_card = torch.device(device).type == "cuda"
    grad = not args.no_grad
    groups = []
    if on_card:
        groups += ["fwd", "sharded_fwd"]
        if grad:
            groups += ["fwd_bwd", "nee", "vjp", "sharded_fwd_bwd"]
        groups.append("mfu")
        if grad and not args.quick:
            groups.append("inverse")
        if not args.quick:
            groups.append("denoised")
    if args.full or not on_card:
        groups.append("plain_fwd")
        if grad:
            groups.append("plain_fwd_bwd")
    return groups


@dataclasses.dataclass
class Cell:
    """One timed entry point: ``call(frame)`` returns its outputs and
    ``scalar(outputs)`` the 0-d tensor a sample adds up; ``k`` calls a
    sample; ``plain``: a leg of the plain wavefront."""

    field: str
    k: int
    call: Callable
    scalar: Callable
    plain: bool = False


def _loss_emission(out):
    loss, (d_scene, _) = out
    return loss + torch.sum(d_scene.emission)


def _loss_emission_position(out):
    loss, (d_scene, d_cam) = out
    return loss + torch.sum(d_scene.emission) + torch.sum(d_cam.position)


def _first(out):
    return out[0, 0, 0]


def bench_config(args, **kw) -> RenderConfig:
    """The bench frame of ``args`` on the kernels' backend."""
    cfg = RenderConfig(width=args.size, height=args.size, spp=args.spp,
                       max_bounces=args.bounces, backend="cuda")
    return dataclasses.replace(cfg, **kw)


def build_cells(group: str, args, device, model=None, target=None) -> List[Cell]:
    """The cells of ``group`` on ``device``. On the CPU the kernel wrappers
    run their plain versions. ``model``: the denoiser of the denoised-frame
    cell (default: the full-width ``DenoiseCNN`` from ``init_model``, seed
    0); ``target``: the [H, W, 3] image of the loss cells, at their size
    (default: zeros, as bench.py)."""
    from pathtrace_tpu_torch.camera import Camera
    from pathtrace_tpu_torch.scene import cornell_box

    device = torch.device(device)
    scene, cam = cornell_box(), Camera.create()
    cfg = bench_config(args)
    k = lambda n: min(n, K_QUICK) if args.quick else n  # noqa: E731

    given = target

    def target(size):
        if given is not None:
            return torch.as_tensor(given, dtype=torch.float32, device=device)
        return torch.zeros((size, size, 3), dtype=torch.float32, device=device)

    if group in ("fwd", "sharded_fwd", "sharded_fwd_bwd"):
        from pathtrace_tpu_torch.ops import trace_kernel as tk
        from pathtrace_tpu_torch.parallel import shard
        from pathtrace_tpu_torch.parallel.mesh import make_mesh

        if group == "fwd":
            return [Cell("pallas_fwd_ms", k(K_HEADLINE),
                         lambda f: tk.render_channels(scene, cam, cfg, f, device), _first)]
        mesh = make_mesh(tiles=1, samples=1, device=device)
        if group == "sharded_fwd":
            return [Cell("sharded_1dev_fwd_mrays", k(K_DEFAULT),
                         lambda f: shard.render_channels_sharded(scene, cam, cfg, mesh, f),
                         _first)]
        t0 = target(args.size)
        return [Cell("sharded_1dev_fwd_bwd_mrays", k(K_DEFAULT),
                     lambda f: shard.sharded_loss_grads(scene, cam, cfg, mesh, t0, f),
                     _loss_emission)]
    if group in ("fwd_bwd", "nee", "vjp", "inverse"):
        from pathtrace_tpu_torch.ops import ad_grad_kernel as ak
        from pathtrace_tpu_torch.ops import grad_kernel as gk

        if group == "inverse":
            cfg_inv = RenderConfig(width=INVERSE_SIZE, height=INVERSE_SIZE, spp=INVERSE_SPP,
                                   backend="cuda")
            t_inv = target(INVERSE_SIZE)

            def inv_scalar(out):
                loss, g = out
                return loss + torch.sum(g["color"]) + torch.sum(g["emission"])

            return [Cell("inverse_step_ms", k(K_DEFAULT),
                         lambda f: gk.cross_grads(scene, cam, cfg_inv, f, t_inv, device),
                         inv_scalar)]
        t0 = target(args.size)
        if group == "fwd_bwd":
            return [Cell("pallas_fwd_bwd_mrays", k(K_DEFAULT),
                         lambda f: gk.loss_and_grads(scene, cam, cfg, f, t0, device),
                         _loss_emission)]
        cfg_nee = dataclasses.replace(cfg, nee=True)
        if group == "nee":
            return [Cell("ad_fwd_bwd_mrays", k(K_NEE),
                         lambda f: gk.loss_and_grads(scene, cam, cfg_nee, f, t0, device),
                         _loss_emission_position)]
        return [Cell("vjp_fwd_bwd_mrays", k(K_NEE),
                     lambda f: ak.ad_loss_and_grads(scene, cam, cfg_nee, f, t0, device),
                     _loss_emission_position)]
    if group == "denoised":
        from pathtrace_tpu_torch.models.denoise_cnn import init_model
        from pathtrace_tpu_torch.models.infer import denoise_with
        from pathtrace_tpu_torch.ops import trace_kernel as tk

        if model is None:
            model = init_model(torch.Generator().manual_seed(0))
        model = model.to(device, memory_format=torch.channels_last).eval()
        cfg_int = bench_config(args, spp=DENOISE_SPP)

        def denoised_frame(f):
            return denoise_with(model, tk.render_channels(scene, cam, cfg_int, f, device))

        return [Cell("denoised_frame_ms", k(K_DEFAULT), denoised_frame, _first)]
    if group in ("plain_fwd", "plain_fwd_bwd"):
        from pathtrace_tpu_torch import grad, render

        cfg_plain = bench_config(args, backend="torch", spp_chunk=8 if args.spp > 8 else 0)
        if group == "plain_fwd":
            return [Cell("jnp_fwd_mrays", k(K_DEFAULT),
                         lambda f: render.render_channels(scene, cam, cfg_plain, f, device),
                         _first, plain=True)]

        def loss_color(out):
            loss, (d_scene, _) = out
            return loss + torch.sum(d_scene.color)

        return [Cell("fwd_bwd_mrays", k(K_DEFAULT),
                     lambda f: grad.render_loss_grads(scene, cam, cfg_plain, f, device=device),
                     loss_color, plain=True)]
    raise ValueError(f"no cells in group {group!r}")


# -- timing ---------------------------------------------------------------------------

def time_cell(cell: Cell, samples: int, device) -> List[float]:
    """Seconds a call of each of ``samples`` samples, after one warm-up
    sample. Sample j calls frames j k ... j k + k - 1; CUDA events on the
    current stream time it on a CUDA device, the host clock on the CPU. A
    sample whose sum is not finite raises."""
    device = torch.device(device)
    out = []
    for j in range(samples + 1):
        acc = torch.zeros((), dtype=torch.float32, device=device)
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(device))
        t0 = time.perf_counter()
        for i in range(cell.k):
            acc = acc + cell.scalar(cell.call(j * cell.k + i))
        if device.type == "cuda":
            end.record(torch.cuda.current_stream(device))
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            seconds = time.perf_counter() - t0
        if not torch.isfinite(acc).item():
            raise RuntimeError(f"{cell.field}: the sum of a sample is not finite")
        if j > 0:
            out.append(seconds / cell.k)
    return out


def spread(per_call: List[float]) -> float:
    return (max(per_call) - min(per_call)) / statistics.median(per_call)


# -- the device and the build ---------------------------------------------------------

def kernel_sources():
    from pathtrace_tpu_torch.ops import ad_grad_kernel as ak
    from pathtrace_tpu_torch.ops import grad_kernel as gk
    from pathtrace_tpu_torch.ops import nee_grad_kernel as nk
    from pathtrace_tpu_torch.ops import trace_kernel as tk
    from pathtrace_tpu_torch.utils import roofline as rf

    return (tk.SOURCE, gk.SOURCE, nk.SOURCE, ak.SOURCE, rf.SOURCE)


def build_kernels():
    """(seconds, cached): nvcc builds the five kernel libraries at once
    (``ops.build.build_all``); ``cached`` if every one existed already."""
    from pathtrace_tpu_torch.ops import build

    sources = kernel_sources()
    cached = all(build.library_path(src).exists() for src in sources)
    t0 = time.perf_counter()
    build.build_all(sources)
    return time.perf_counter() - t0, cached


# -- the run ----------------------------------------------------------------------------

def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError:
        print("bench: no CUDA device; --device cpu times the plain legs on the CPU",
              file=sys.stderr)
        return 1
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.set_device(device)
    t_start = time.time()
    info = {"device": device_name(device), "build_s": 0.0, "kernels_cached": None}
    if on_card:
        info["build_s"], info["kernels_cached"] = build_kernels()
    recs = prior_records()
    n_rays = args.size * args.size * args.spp * args.bounces
    extras: dict = {}
    n_samples: Dict[str, int] = {}
    calls: Dict[str, int] = {}
    spreads: Dict[str, float] = {}
    headline = None
    fwd_seconds = None

    def mrays(seconds):
        return mrays_per_sec(args.size, args.size, args.spp, args.bounces, seconds)

    def emit():
        vs_baseline, vs_prior = compare_priors(headline, extras, recs)
        result = {
            "metric": (f"Mrays/s/chip fwd (Cornell {args.size}^2 x {args.spp}spp"
                       f" x {args.bounces} bounces)"),
            "value": headline,
            "unit": "Mrays/s",
            "vs_baseline": vs_baseline,
            "backend": device.type,
            "n_rays_per_frame": n_rays,
            "elapsed_s": round(time.time() - t_start, 1),
            **extras,
            **info,
            "samples": dict(n_samples),
            "calls": dict(calls),
            "spread": dict(spreads),
            "vs_prior": vs_prior,
        }
        print(json.dumps(result), flush=True)

    for group in plan(args, device):
        if group == "mfu":
            from pathtrace_tpu_torch.utils import roofline

            peaks = roofline.measure_f32_peak(device=device)
            extras.update(mfu_fields(args.size, args.size, args.spp, args.bounces,
                                     fwd_seconds, peaks))
        for cell in ([] if group == "mfu" else build_cells(group, args, device)):
            per_call = time_cell(cell, PLAIN_SAMPLES if cell.plain else CARD_SAMPLES, device)
            seconds = statistics.median(per_call)
            n_samples[cell.field], calls[cell.field] = len(per_call), cell.k
            spreads[cell.field] = spread(per_call)
            if cell.field.endswith("_ms"):
                extras[cell.field] = seconds * 1e3
            else:
                extras[cell.field] = mrays(seconds)
            if group == "fwd":
                fwd_seconds, headline = seconds, mrays(seconds)
            elif group == "nee":
                extras["ad_backend"] = "hand_nee_sweep"
            elif group == "denoised":
                extras["denoised_frame_fps"] = 1.0 / seconds
            elif group == "plain_fwd" and headline is None:
                headline = extras["jnp_fwd_mrays"]
        if group in EMIT_AFTER:
            emit()
    emit()
    return 0


if __name__ == "__main__":
    sys.exit(main())
