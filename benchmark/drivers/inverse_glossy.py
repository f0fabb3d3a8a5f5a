"""Geometry recovery under the glossy BRDF with NEE: ``inverse.make_inverse_step``'s
``step_fn``, back to back, at 512x512x32.

The case is ``drivers/inverse.py``'s (sphere 6 moved and shrunk, its
position and radius recovered by Adam on the cross-estimator against a
64-spp target of the true scene), and so are the window and the warm-up,
imported from there; ``window`` hands that window a run it can take. The configuration states the BRDF, which
``common.render_config`` does not pass on, so set-up sets it and asserts
that the program's configuration reads it. A step is two colour passes of
K1's NEE glossy instance and two K4 replays (``grad_kernel.cross_grads``).

Check: the three numbers of ``drivers/inverse.py``'s (``compare``, which
the albedo cell shares), against the frozen glossy tracer
(``reference/glossy.py``) through autograd, in blocks of rows
(``reference/inverse.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark import common
from benchmark.counts import gradients, ops
from benchmark.drivers import inverse as inverse_driver
from benchmark.drivers.inverse import CHECKED_STEPS, WARMUP_STEPS, _case, _rate
from benchmark.reference import camera as ref_camera
from benchmark.reference import fpn, glossy, tracer
from benchmark.reference import inverse as ref_inverse

FIELD = {"position": "pos", "radius": "rad"}


def setup(ctx):
    from pathtrace_tpu_torch import inverse
    from pathtrace_tpu_torch.camera import Camera
    from pathtrace_tpu_torch.render import render_aovs

    o, c = ctx.overrides, ctx.config["inverse"]
    r = ctx.config["render"]
    width, height = o.get("width", r["width"]), o.get("height", r["height"])
    spp = o.get("spp", c["spp"])
    sp, bad, masks = _case(ctx)
    cfg = dataclasses.replace(
        common.render_config(ctx.config, ctx.seed, width=width, height=height, spp=spp),
        brdf=r["brdf"])
    if (cfg.brdf, cfg.nee) != ("glossy", True):
        raise RuntimeError(f"the program renders {cfg.brdf}, NEE {cfg.nee}: not glossy with NEE")
    cam = Camera.create(c["camera"][:3], c["camera"][3], c["camera"][4])
    target = render_aovs(common.port_scene(sp), cam, dataclasses.replace(cfg, spp=c["target_spp"]),
                         frame=c["target_frame"], device=ctx.device)["color"]
    corrupted = common.port_scene(bad)

    def start():
        rates = {k: inverse.exponential_decay(c["learning_rate"][k], c["transition_steps"],
                                              c["decay_rate"]) for k in c["optimize"]}
        return inverse.make_inverse_step(corrupted, cam, cfg, target, tuple(c["optimize"]),
                                         rates, grad_mask=masks, device=ctx.device)

    # the first Adam step imports torch._dynamo and the kernels load: none of
    # that may fall into the window
    st, step_fn, _ = start()
    for _ in range(WARMUP_STEPS):
        st, _ = step_fn(st)
    del st, step_fn
    return dict(ctx=ctx, start=start, run=start(), sizes=(width, height, spp),
                case=(sp, bad, masks))


def window(state, seconds):
    """``drivers/inverse.py``'s window, handed a run it can take: it keeps a
    run's checked steps only from the run's first step, and raises where the
    run it is handed has taken one or two (with ``--trace 1`` the harness's
    second window, for the host's operations, takes the run the measured
    window left). Such a run is started again."""
    if 0 < state["run"][0].step < CHECKED_STEPS:
        state["run"] = state["start"]()
    return inverse_driver.window(state, seconds)


def end_to_end(state, record):
    # its end-to-end metric is the device's, read from the traced window
    return {}


def work(state, record):
    width, height, spp = state["sizes"]
    frame = ops.nominal_segments(width, height, spp, state["ctx"].config["render"]["max_bounces"])
    per = gradients.OPS_PER_SEGMENT
    segments = 2 * frame * record["attempted"]  # two frames a step, each through K1 and K4
    return {"units": record["attempted"],
            "ops_per_unit": 2 * frame * (per["color_nee_glossy"] + per["ad_nee_glossy_color"]),
            "k1_segments": segments, "k4_segments": segments}


def reference_steps(state, dtype=torch.float32, half_batch=False):
    """The first steps by the reference -> ((loss, mean |(A - T)(B - T)|) a
    step, first gradient, change)."""
    ctx = state["ctx"]
    c, r = ctx.config["inverse"], ctx.config["render"]
    width, height, spp = state["sizes"]
    sp, bad, masks = state["case"]
    dev = ctx.device
    pose = ref_camera.Pose(c["camera"][:3], c["camera"][3], c["camera"][4])
    corners = pose.corner_rays(width, height)

    def frame(spheres, index, rows):
        return glossy.Frame(spheres, pose.position, corners, width, height, ctx.seed, index,
                            rows, max_bounces=r["max_bounces"], push=r["push_ray_origin"],
                            light=r["light_index"], device=dev, dtype=dtype)

    rows = range(height // 2) if half_batch else range(height)
    with fpn.precision(False):
        target = torch.cat([tracer.frame_buffer(frame(sp, c["target_frame"], blk),
                                                c["target_spp"])[..., :3]
                            for blk in ref_inverse.row_blocks(rows, width, c["target_spp"])])
        params = {k: bad[FIELD[k]].to(dev, dtype).clone().requires_grad_(True)
                  for k in c["optimize"]}

        def scene_of(p):
            spheres = {k: t.to(dev, dtype) for k, t in sp.items()}
            spheres["pos"], spheres["rad"] = p["position"], p["radius"]
            return spheres

        losses, first, after = ref_inverse.cross_steps(
            frame, scene_of, params, target.to(dtype), rows, width, spp, CHECKED_STEPS,
            lambda k, step: _rate(c, k, step), {k: masks[k].to(dev, dtype) for k in params})
    change = {k: after[k].float() - bad[FIELD[k]].to(dev) for k in after}
    return losses, {k: g.float() for k, g in first.items()}, change


def compare(state, record, variant, reference_steps, start, leaves=lambda d: d):
    """The three numbers of ``drivers/inverse.py``'s check: loss_gap, the
    largest gap of the three steps' losses, each over the reference's mean
    |(A - T)(B - T)|; grad_gap and change_gap, the worst leaf's gap of norms
    (``common.norm_gap``) of the first gradient and of the change from
    ``start`` ({name: the parameter's first value}), after ``leaves``.
    ``reference_steps(state, dtype, half_batch)`` gives the reference's, and
    in the program's place the control's where ``variant`` names one."""
    if variant not in (None, "bf16", "half_batch"):
        raise ValueError(f"an inverse cell has no variant {variant!r}")
    limits = state["ctx"].workload["limits"]
    kept = record.pop("kept")
    if variant is None:
        got_losses = [(float(x), None) for x in kept["losses"]]
        got_grad = {k: g.float() for k, g in kept["first_grad"].items()}
        got_change = {k: kept["after"][k] - start[k] for k in kept["after"]}
    del kept
    for k in ("run", "start"):
        state.pop(k, None)
    if variant is not None:
        got_losses, got_grad, got_change = reference_steps(
            state, torch.bfloat16 if variant == "bf16" else torch.float32,
            half_batch=variant == "half_batch")
    ref_losses, ref_grad, ref_change = reference_steps(state)
    return [
        ("loss_gap", max(common.relative_gap(g, r, scale)
                         for (g, _), (r, scale) in zip(got_losses, ref_losses)),
         limits["loss_gap"]),
        ("grad_gap", common.norm_gap(leaves(got_grad), leaves(ref_grad)), limits["grad_gap"]),
        ("change_gap", common.norm_gap(leaves(got_change), leaves(ref_change)),
         limits["change_gap"]),
    ]


def check(state, record, variant=None):
    """``compare`` against the frozen glossy tracer."""
    bad, dev = state["case"][1], state["ctx"].device
    return compare(state, record, variant, reference_steps,
                   {k: bad[FIELD[k]].to(dev) for k in FIELD})
