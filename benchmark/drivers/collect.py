"""Building a denoiser training set: ``data.collect.render_pair`` in a closed loop.

The poses are the traffic's list (box-facing views); the seed sets the
render seed and the pose the loop starts at. Each pair renders the
configuration's noisy and ground-truth spp at full size, and both packed
buffers come back to the host. The window closes at the first completed
pair at or after ``--seconds``, and the rate divides by the time elapsed.

Check: the noisy buffers of a sample of pairs drawn from the seed, with the
last, whole; the ground truth of fewer pairs (the last among them) on a
block of rows drawn from the seed (the lattice keys each draw on its row
and sample, so rows are recomputed apart). Each compared against the
frozen tracer: the largest gap of a channel over max(1, its largest value).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import common
from benchmark.counts import ops
from benchmark.reference import camera as ref_camera
from benchmark.reference import tracer



def _poses(traffic):
    with open(common.BENCH / "traffic" / traffic["poses"]) as f:
        return [tuple(float(x) for x in line.split()) for line in f
                if line.strip() and not line.startswith("#")]


def setup(ctx):
    from pathtrace_tpu_torch.data.collect import render_pair

    o = ctx.overrides
    r, c = ctx.config["render"], ctx.config["collect"]
    width, height = o.get("width", r["width"]), o.get("height", r["height"])
    spp_train, spp_gt = c["spp_train"], o.get("spp_gt", c["spp_gt"])
    sp = common.spheres(ctx.config)
    state = dict(ctx=ctx, render_pair=render_pair, scene=common.port_scene(sp), sp=sp,
                 cfg=common.render_config(ctx.config, ctx.seed, width=width, height=height,
                                          spp=spp_train),
                 poses=_poses(ctx.traffic), sizes=(width, height, spp_train, spp_gt))
    state["start"] = ctx.seed % len(state["poses"])
    # builds and loads the kernel at this frame size: the window's launches
    # differ from it only in their sample counts
    render_pair(state["scene"], state["poses"][state["start"]], state["cfg"], spp_train,
                spp_train, frame=0, device=ctx.device)
    return state


def window(state, seconds):
    width, height, spp_train, spp_gt = state["sizes"]
    pairs = []
    t0 = time.perf_counter()
    while True:
        k = len(pairs)
        pose = state["poses"][(state["start"] + k) % len(state["poses"])]
        pairs.append((pose,) + state["render_pair"](state["scene"], pose, state["cfg"],
                                                   spp_train, spp_gt, frame=k,
                                                   device=state["ctx"].device))
        if time.perf_counter() - t0 >= seconds:
            break
    return {"attempted": len(pairs), "pairs": pairs, "elapsed_s": time.perf_counter() - t0}


def _segments(state, pairs):
    width, height, spp_train, spp_gt = state["sizes"]
    bounces = state["ctx"].config["render"]["max_bounces"]
    return pairs * ops.nominal_segments(width, height, spp_train + spp_gt, bounces)


def end_to_end(state, record):
    return {"mrays_per_s": _segments(state, record["attempted"]) / record["elapsed_s"] / 1e6}


def work(state, record):
    segs = _segments(state, record["attempted"])
    return {"units": record["attempted"], "k1_segments": segs,
            "ops_per_unit": segs / record["attempted"] * ops.OPS_PER_SEGMENT["forward_diffuse"]}


def reference_buffer(state, pose, frame, gt: bool, rows, dtype=torch.float32):
    ctx = state["ctx"]
    width, height, spp_train, spp_gt = state["sizes"]
    r = ctx.config["render"]
    p = ref_camera.Pose(pose[:3], pose[3], pose[4])
    fr = tracer.Frame(state["sp"], p.position, p.corner_rays(width, height), width, height,
                      ctx.seed + 1 if gt else ctx.seed, frame, rows,
                      max_bounces=r["max_bounces"], push=r["push_ray_origin"],
                      device=ctx.device, dtype=dtype)
    return tracer.frame_buffer(fr, spp_gt if gt else spp_train,
                               chunk=ctx.traffic["reference_chunk"])


def check(state, record, variant=None):
    """noisy_gap and gt_gap: the largest channel gap, over the sampled
    pairs, of the noisy buffer and of the ground truth's rows."""
    if variant not in (None, "bf16"):
        raise ValueError(f"collect has no variant {variant!r}")
    ctx = state["ctx"]
    tr, limits = ctx.traffic, ctx.workload["limits"]
    width, height, spp_train, spp_gt = state["sizes"]
    n = record["attempted"]
    rng = np.random.default_rng([int(ctx.seed) & 0xFFFFFFFFFFFF, 3])
    gaps = {"noisy_gap": 0.0, "gt_gap": 0.0}
    gt_pairs = common.sample_indices(ctx.seed, n, tr["checked_gt_pairs"], 13)
    for k in common.sample_indices(ctx.seed, n, tr["checked_pairs"], 11):
        pose, noisy, gt = record["pairs"][k]
        checks = [("noisy_gap", False, range(height), noisy)]
        if k in gt_pairs:
            first = int(rng.integers(0, height - tr["gt_rows"] + 1))
            rows = range(first, first + tr["gt_rows"])
            checks.append(("gt_gap", True, rows, gt[first:first + tr["gt_rows"]]))
        for name, is_gt, rows, got in checks:
            ref = reference_buffer(state, pose, k, is_gt, rows)
            if variant == "bf16":
                got = reference_buffer(state, pose, k, is_gt, rows, torch.bfloat16).cpu()
            gaps[name] = max(gaps[name], common.channel_gap(torch.as_tensor(got), ref.cpu()))
    return [(name, v, limits[name]) for name, v in gaps.items()]
