"""Geometry recovery: ``inverse.make_inverse_step``'s ``step_fn``, back to back.

The configuration's case: sphere 6 moved and shrunk, its position and
radius recovered by Adam on the cross-estimator against a target the
program renders from the true scene, the rates on an exponential decay.
Set-up warms the step up on a run of its own, which it then drops, and
builds the run the window opens on. The window steps it and starts the
documented run again from the corrupted scene at every run's last step, so
the schedule is the documented one. Losses stay on the device; the window
ends with the device synchronised.

Check: of the last run that the window took three steps into, the losses
of those steps, the first gradient as Adam got it (its first moment after
one step over 1 - b1) and the parameters after the third step, all kept by
the window. The reference (autograd through the frozen tracer, the
cross-estimator, the masks, Adam and the schedule) follows the same three
steps from the corrupted scene; the change of the parameters is compared
by the worst leaf.
"""

from __future__ import annotations

import time

import torch

from benchmark import common
from benchmark.counts import ops
from benchmark.reference import tracer

CHECKED_STEPS = 3
WARMUP_STEPS = 3
B1, B2, EPS = 0.9, 0.999, 1e-8


def _case(ctx):
    c = ctx.config["inverse"]
    sp = common.spheres(ctx.config)
    bad = {k: v.clone() for k, v in sp.items()}
    bad["pos"][c["sphere"]] += torch.tensor(c["offset"])
    bad["rad"][c["sphere"]] *= c["radius_scale"]
    masks = {"position": torch.zeros(len(sp["rad"]), 1), "radius": torch.zeros(len(sp["rad"]))}
    masks["position"][c["sphere"]] = masks["radius"][c["sphere"]] = 1.0
    return sp, bad, masks


def _rate(c, name, step):
    return c["learning_rate"][name] * c["decay_rate"] ** (step / c["transition_steps"])


def setup(ctx):
    import dataclasses

    from pathtrace_tpu_torch import inverse
    from pathtrace_tpu_torch.camera import Camera
    from pathtrace_tpu_torch.render import render_aovs

    o, c = ctx.overrides, ctx.config["inverse"]
    r = ctx.config["render"]
    width, height = o.get("width", r["width"]), o.get("height", r["height"])
    spp = o.get("spp", c["spp"])
    sp, bad, masks = _case(ctx)
    cfg = common.render_config(ctx.config, ctx.seed, width=width, height=height, spp=spp)
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
    """Steps until ``seconds`` have passed and the window has taken a run
    three steps in; keeps, of the last such run, what the check compares."""
    runs = state["ctx"].config["inverse"]["steps"]
    st, step_fn, opt = state.pop("run")
    losses, kept, taking = [], None, {}
    t0 = time.perf_counter()
    while True:
        if st.step >= runs:
            st, step_fn, opt = state["start"]()
        st, loss = step_fn(st)
        losses.append(loss)
        if st.step <= CHECKED_STEPS:
            if st.step == 1:
                taking = {"losses": [],
                          # an optimizer that took no step from a parameter holds no moment of it
                          "first_grad": {k: opt.state[p].get("exp_avg", torch.zeros_like(p))
                                         .detach() / (1.0 - B1) for k, p in st.params.items()}}
            taking["losses"].append(loss)
            if st.step == CHECKED_STEPS:
                taking["after"] = {k: p.detach().clone() for k, p in st.params.items()}
                kept = taking
        if kept is not None and time.perf_counter() - t0 >= seconds:
            break
    if state["ctx"].device.type == "cuda":
        torch.cuda.synchronize()
    state["run"] = (st, step_fn, opt)
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    return {"attempted": len(losses), "failed": failed, "kept": kept}


def end_to_end(state, record):
    # its end-to-end metric is the device's, read from the traced window
    return {}


def work(state, record):
    width, height, spp = state["sizes"]
    segs = ops.nominal_segments(width, height, spp, state["ctx"].config["render"]["max_bounces"])
    per = 2 * segs * (ops.OPS_PER_SEGMENT["color_nee"] + ops.OPS_PER_SEGMENT["nee_replay"])
    return {"units": record["attempted"], "ops_per_unit": per,
            "k3_segments": 2 * segs * record["attempted"]}


def reference_steps(state, dtype=torch.float32, half_batch=False):
    """The first steps by the reference -> ((loss, mean |(A - T)(B - T)|) a
    step, first gradient, change)."""
    ctx = state["ctx"]
    c, r = ctx.config["inverse"], ctx.config["render"]
    width, height, spp = state["sizes"]
    sp, bad, masks = state["case"]
    dev = ctx.device
    from benchmark.reference import camera as ref_camera

    pose = ref_camera.Pose(c["camera"][:3], c["camera"][3], c["camera"][4])
    corners = pose.corner_rays(width, height)

    def frame(spheres, index, rows=range(height), seed=ctx.seed):
        return tracer.Frame(spheres, pose.position, corners, width, height, seed, index, rows,
                            max_bounces=r["max_bounces"], push=r["push_ray_origin"],
                            light=r["light_index"], device=dev, dtype=dtype)

    target = tracer.frame_buffer(frame(sp, c["target_frame"]), c["target_spp"])[..., :3]
    target = target.to(dtype)
    params = {"position": bad["pos"].to(dev, dtype).clone().requires_grad_(True),
              "radius": bad["rad"].to(dev, dtype).clone().requires_grad_(True)}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    mask = {k: masks[k].to(dev, dtype) for k in params}
    rows = range(height // 2) if half_batch else range(height)
    losses, first = [], {}
    for step in range(CHECKED_STEPS):
        spheres = {k: t.to(dev, dtype) for k, t in sp.items()}
        spheres["pos"], spheres["rad"] = params["position"], params["radius"]
        a = tracer.color_mean(frame(spheres, 2 * step, rows), spp)
        b = tracer.color_mean(frame(spheres, 2 * step + 1, rows), spp)
        t = target[: len(rows)]
        ra, rb = a.detach() - t, b.detach() - t
        n = ra.numel()
        losses.append((float((ra * rb).sum() / n), float((ra * rb).abs().sum() / n)))
        grads = torch.autograd.grad([a, b], [params["position"], params["radius"]],
                                    [rb / n, ra / n])
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                g = g * mask[k]
                if step == 0:
                    first[k] = g.detach().clone()
                m[k] = B1 * m[k] + (1 - B1) * g
                v[k] = B2 * v[k] + (1 - B2) * g * g
                m_hat = m[k] / (1 - B1 ** (step + 1))
                v_hat = v[k] / (1 - B2 ** (step + 1))
                p -= _rate(c, k, step) * m_hat / (torch.sqrt(v_hat) + EPS)
        del a, b, grads
    change = {k: (p.detach().float() - bad[{"position": "pos", "radius": "rad"}[k]].to(dev))
              for k, p in params.items()}
    return losses, {k: g.float() for k, g in first.items()}, change


def check(state, record, variant=None):
    """loss_gap: the largest gap of the three steps' losses, each over the
    reference's mean |(A - T)(B - T)| (the estimator cancels to near 0 as the
    sphere comes back, so a relative gap would measure the cancellation);
    grad_gap and change_gap: the worst leaf's gap of norms (``common.norm_gap``)."""
    if variant not in (None, "bf16", "half_batch"):
        raise ValueError(f"inverse has no variant {variant!r}")
    limits = state["ctx"].workload["limits"]
    sp, bad, masks = state["case"]
    dev = state["ctx"].device
    kept = record.pop("kept")
    if variant is None:
        got_losses = [(float(x), None) for x in kept["losses"]]
        got_grad = {k: g.float() for k, g in kept["first_grad"].items()}
        got_change = {k: kept["after"][k] - bad[{"position": "pos", "radius": "rad"}[k]].to(dev)
                      for k in kept["after"]}
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
        ("grad_gap", common.norm_gap(got_grad, ref_grad), limits["grad_gap"]),
        ("change_gap", common.norm_gap(got_change, ref_change), limits["change_gap"]),
    ]
