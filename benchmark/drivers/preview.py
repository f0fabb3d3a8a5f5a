"""A viewer user walking through the scene: ``FrameStepper.step`` in a closed loop.

Each frame starts with a move (one of WASD, dt from the traffic) and a
mouse look, drawn from a seeded walk, then ``FrameStepper(progressive=True,
denoising=True).step()`` renders the frame afresh (the camera moved) at the
configuration's spp, denoises it with the CNN, fades and copies the display
RGB to the host. A frame's latency is the host clock from the call to
``step()`` to its return with the RGB on the host.

Check: a sample of the window's frames, drawn from the seed, with the last,
recomputed by the reference from the walk (the frozen camera, tracer, FPN
and fade) and compared as display bytes: the share of bytes that differ.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import common
from benchmark.counts import ops
from benchmark.reference import camera as ref_camera
from benchmark.reference import fpn, tracer

DIRECTIONS = ("forward", "backward", "left", "right")
FADE_STD, FADE_SPP = 0.05, 16.0  # interactive.FrameStepper's fade


def _sizes(ctx):
    r = ctx.config["render"]
    o = ctx.overrides
    return (o.get("width", r["width"]), o.get("height", r["height"]),
            tuple(o.get("widths", ctx.config["denoiser"]["widths"])))


def walk(seed: int, traffic: dict):
    """The seeded walk: (direction, dx, dy) for each frame, cycled. Legs of
    ``leg_frames`` frames, each leg a direction and a look drawn from the
    seed and the next one retracing it, so the viewer stays in the box."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, 1])
    opposite = {"forward": "backward", "backward": "forward", "left": "right", "right": "left"}
    legs = traffic["walk_length"] // (2 * traffic["leg_frames"])
    out = []
    for _ in range(legs):
        d = DIRECTIONS[int(rng.integers(0, len(DIRECTIONS)))]
        dx, dy = (float(v) for v in rng.uniform(-traffic["look_max"], traffic["look_max"], 2))
        out += [(d, dx, dy)] * traffic["leg_frames"]
        out += [(opposite[d], -dx, -dy)] * traffic["leg_frames"]
    return out


def setup(ctx):
    from pathtrace_tpu_torch.camera import Camera
    from pathtrace_tpu_torch.interactive import FrameStepper

    width, height, widths = _sizes(ctx)
    lateral = ctx.config["denoiser"]["lateral_features"]
    spp = ctx.config["interactive"]["spp"]
    weights = common.fpn_weights(ctx.seed, ctx.device, widths, lateral)
    ckpt = f"{ctx.tmp}/checkpoint"
    common.write_checkpoint(ckpt, weights, widths, lateral)
    del weights
    sp = common.spheres(ctx.config)
    start = ctx.traffic["start_pose"]
    stepper = FrameStepper(common.port_scene(sp), Camera.create(start[:3], start[3], start[4]),
                           common.render_config(ctx.config, ctx.seed, width=width,
                                                height=height, spp=spp),
                           denoising=True, checkpoint=ckpt, progressive=True, device=ctx.device)
    state = dict(ctx=ctx, stepper=stepper, walk=walk(ctx.seed, ctx.traffic),
                 sizes=(width, height, widths, lateral, spp), sp=sp)
    for _ in range(ctx.traffic["warmup_frames"]):
        _frame(state)
    return state


def _frame(state):
    st = state["stepper"]
    d, dx, dy = state["walk"][st.frame % len(state["walk"])]
    st.move(d, state["ctx"].traffic["dt"])
    st.look(dx, dy)
    t = time.perf_counter()
    rgb = st.step()
    return time.perf_counter() - t, rgb


def window(state, seconds):
    lat, frames = [], []
    first = state["stepper"].frame
    t0 = time.perf_counter()
    while True:
        dt, rgb = _frame(state)
        lat.append(dt)
        frames.append(rgb)
        if time.perf_counter() - t0 >= seconds:
            break
    return {"attempted": len(lat), "latency_s": lat, "frames": frames, "first": first,
            "elapsed_s": time.perf_counter() - t0}


def end_to_end(state, record):
    return {"frame_p95_ms": float(np.percentile(np.asarray(record["latency_s"]) * 1e3, 95))}


def work(state, record):
    width, height, widths, lateral, spp = state["sizes"]
    bounces = state["ctx"].config["render"]["max_bounces"]
    segs = ops.nominal_segments(width, height, spp, bounces)
    per = ops.conv_operations(1, height, width, widths, lateral) \
        + segs * ops.OPS_PER_SEGMENT["forward_diffuse"]
    return {"units": record["attempted"], "ops_per_unit": per, "k1_segments": segs}


def reference_frame(state, index: int, tf32: bool = False) -> np.ndarray:
    """The display bytes of global frame ``index`` by the reference."""
    ctx = state["ctx"]
    width, height, widths, lateral, spp = state["sizes"]
    start = ctx.traffic["start_pose"]
    pose = ref_camera.Pose(start[:3], start[3], start[4])
    for k in range(index + 1):
        d, dx, dy = state["walk"][k % len(state["walk"])]
        pose = pose.move(d, ctx.traffic["dt"]).look(dx, dy)
    r = ctx.config["render"]
    fr = tracer.Frame(state["sp"], pose.position, pose.corner_rays(width, height), width, height,
                      ctx.seed, index, range(height), max_bounces=r["max_bounces"],
                      push=r["push_ray_origin"], device=ctx.device)
    aov = tracer.frame_buffer(fr, spp)
    if "ref_weights" not in state:
        state["ref_weights"] = common.fpn_weights(ctx.seed, ctx.device, widths, lateral)
    with torch.no_grad(), fpn.precision(tf32):
        cnn = fpn.forward(state["ref_weights"], fpn.preprocess(aov)[None], widths=widths)[0]
    std = torch.sqrt(torch.clamp(aov[..., 10], min=0.0) / float(spp))
    w = torch.clamp(torch.clamp(std / FADE_STD, min=FADE_SPP / spp), 0.0, 1.0)[..., None]
    color = w * cnn + (1.0 - w) * aov[..., 0:3]
    return (torch.clamp(color, 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()


def check(state, record, variant=None):
    """display_mismatch: the largest share, over the sampled frames, of
    display bytes that differ from the reference's."""
    if variant not in (None, "tf32"):
        raise ValueError(f"preview has no variant {variant!r}")
    limits = state["ctx"].workload["limits"]
    del state["stepper"]
    n = record["attempted"]
    worst = 0.0
    for i in common.sample_indices(state["ctx"].seed, n, state["ctx"].traffic["checked_frames"], 7):
        index = record["first"] + i
        ref = reference_frame(state, index)
        got = record["frames"][i] if variant is None else reference_frame(state, index, tf32=True)
        worst = max(worst, float(np.mean(got != ref)))
    return [("display_mismatch", worst, limits["display_mismatch"])]
