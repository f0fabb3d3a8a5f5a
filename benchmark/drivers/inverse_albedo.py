"""Albedo recovery: ``inverse.make_inverse_step``'s ``step_fn`` on the albedo,
back to back, diffuse without NEE.

The case is the workload's (``case``: the configuration holds none), the
repository's documented albedo case (``scripts/inverse_demo.py:117-123``):
the nine albedos moved by ``default_rng(0).uniform(-0.35, 0.35, (9, 3))``
and clipped to [0.05, 0.95], recovered by Adam at a constant rate on the
cross-estimator against a target the program renders from the true scene.
A step is two dump launches of K2 (``grad_kernel.cross_grads``), the
contraction and Adam. The window is ``drivers/inverse.py``'s, imported (by
``inverse_glossy.window``): it reads the run's length from the
configuration's ``inverse`` group, which set-up gives a copy of the
configuration from the case.

Check: ``inverse_glossy.compare`` against the frozen diffuse tracer
(``reference/tracer.py``, no light) through autograd on the albedo, clipped
to [0, 1] as the program clips it, each sphere's albedo a leaf of its own.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import common
from benchmark.counts import gradients, ops
from benchmark.drivers.inverse import CHECKED_STEPS, WARMUP_STEPS
from benchmark.drivers.inverse_glossy import compare, window  # noqa: F401
from benchmark.reference import camera as ref_camera
from benchmark.reference import inverse as ref_inverse
from benchmark.reference import tracer


def _case(ctx):
    """(true spheres, corrupted spheres) of the case."""
    c = ctx.workload["case"]["corruption"]
    sp = common.spheres(ctx.config)
    moved = sp["alb"].numpy() + np.random.default_rng(c["rng"]).uniform(
        c["low"], c["high"], tuple(sp["alb"].shape))
    bad = dict(sp, alb=torch.from_numpy(np.clip(moved, *c["clip"]).astype(np.float32)))
    return sp, bad


def setup(ctx):
    from pathtrace_tpu_torch import inverse
    from pathtrace_tpu_torch.camera import Camera
    from pathtrace_tpu_torch.render import render_aovs

    o, c = ctx.overrides, ctx.workload["case"]
    width, height = o.get("width", c["width"]), o.get("height", c["height"])
    spp = o.get("spp", c["spp"])
    sp, bad = _case(ctx)
    cfg = dataclasses.replace(
        common.render_config(ctx.config, ctx.seed, width=width, height=height, spp=spp),
        brdf=ctx.config["render"]["brdf"])
    if (cfg.brdf, cfg.nee) != ("diffuse", False):
        raise RuntimeError(f"the program renders {cfg.brdf}, NEE {cfg.nee}: not diffuse without NEE")
    cam = Camera.create(c["camera"][:3], c["camera"][3], c["camera"][4])
    target = render_aovs(common.port_scene(sp), cam, dataclasses.replace(cfg, spp=c["target_spp"]),
                         frame=c["target_frame"], device=ctx.device)["color"]
    corrupted = common.port_scene(bad)

    def start():
        return inverse.make_inverse_step(corrupted, cam, cfg, target, tuple(c["optimize"]),
                                         c["learning_rate"], device=ctx.device)

    # the first Adam step imports torch._dynamo and the kernels load: none of
    # that may fall into the window
    st, step_fn, _ = start()
    for _ in range(WARMUP_STEPS):
        st, _ = step_fn(st)
    del st, step_fn
    run_ctx = SimpleNamespace(**vars(ctx))
    run_ctx.config = dict(ctx.config, inverse=c)
    return dict(ctx=run_ctx, start=start, run=start(), sizes=(width, height, spp),
                case=(sp, bad))


def end_to_end(state, record):
    # its end-to-end metric is the device's, read from the traced window
    return {}


def work(state, record):
    width, height, spp = state["sizes"]
    frame = ops.nominal_segments(width, height, spp, state["ctx"].config["render"]["max_bounces"])
    return {"units": record["attempted"],
            "ops_per_unit": 2 * frame * gradients.OPS_PER_SEGMENT["grad_dump"],
            "k2_segments": 2 * frame * record["attempted"]}  # two dumps a step


def reference_steps(state, dtype=torch.float32, half_batch=False):
    """The first steps by the reference -> ((loss, mean |(A - T)(B - T)|) a
    step, first gradient, change)."""
    ctx = state["ctx"]
    c, r = ctx.workload["case"], ctx.config["render"]
    width, height, spp = state["sizes"]
    sp, bad = state["case"]
    dev = ctx.device
    pose = ref_camera.Pose(c["camera"][:3], c["camera"][3], c["camera"][4])
    corners = pose.corner_rays(width, height)

    def frame(spheres, index, rows):
        return tracer.Frame(spheres, pose.position, corners, width, height, ctx.seed, index,
                            rows, max_bounces=r["max_bounces"], push=r["push_ray_origin"],
                            light=None, device=dev, dtype=dtype)

    rows = range(height // 2) if half_batch else range(height)
    target = torch.cat([tracer.frame_buffer(frame(sp, c["target_frame"], blk),
                                            c["target_spp"])[..., :3]
                        for blk in ref_inverse.row_blocks(rows, width, c["target_spp"])])
    params = {"color": bad["alb"].to(dev, dtype).clone().requires_grad_(True)}

    def scene_of(p):
        spheres = {k: t.to(dev, dtype) for k, t in sp.items()}
        spheres["alb"] = torch.clamp(p["color"], 0.0, 1.0)
        return spheres

    losses, first, after = ref_inverse.cross_steps(
        frame, scene_of, params, target.to(dtype), rows, width, spp, CHECKED_STEPS,
        lambda k, step: c["learning_rate"])
    change = {"color": after["color"].float() - bad["alb"].to(dev)}
    return losses, {k: g.float() for k, g in first.items()}, change


def per_sphere(d: dict) -> dict:
    """{"color": [N, 3]} -> one leaf a sphere."""
    return {f"color.{i}": row for i, row in enumerate(d["color"])}


def check(state, record, variant=None):
    """``inverse_glossy.compare`` against the frozen diffuse tracer."""
    bad, dev = state["case"][1], state["ctx"].device
    return compare(state, record, variant, reference_steps, {"color": bad["alb"].to(dev)},
                   per_sphere)
