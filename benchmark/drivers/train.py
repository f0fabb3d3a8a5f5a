"""Training the denoiser: ``train.loop_epoch``, the CLI's default route.

A host pool of patches, made from the seed within the ranges of the
preprocessed AOVs and targets (the step's work does not depend on their
values), feeds the full-width CNN in batches of the configuration's size in
seeded permutations. Set-up warms the step up on a training state of its
own, which it then drops, and builds the state the window opens on from the
weights the benchmark draws. The window runs epochs of that state and
closes at the first epoch's end at or after ``--seconds``. Its first epoch
goes through ``loop_epoch`` in three calls, of one step, two steps and the
rest, so that the check can read the state after the first step and after
the third.

Check: the reference (the plain FPN in training mode, the L1 loss,
autograd, Nesterov SGD, TF32 off) follows the window's first three steps
from the same weights on the same rows: the loss of the first step and the
mean loss of the second and third (what ``loop_epoch`` returns), the first
gradient as SGD got it (its momentum buffer after one step) and the change
of the parameters after three steps, by the worst leaf.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import common
from benchmark.counts import ops
from benchmark.reference import fpn

CHECKED_STEPS = 3
# ranges of the preprocessed input channels (colour over albedo, normal,
# albedo, depth and variances over their maxima) and of the targets
RANGES = [(0.0, 4.0)] * 3 + [(-1.0, 1.0)] * 3 + [(0.0, 1.0)] * 3 + [(0.0, 1.0)] * 5 \
    + [(0.0, 1.0)] * 3


def _sizes(ctx):
    o, t = ctx.overrides, ctx.config["training"]
    return (o.get("pool", ctx.traffic["pool"]), o.get("patch", t["patch"]), t["batch"],
            tuple(o.get("widths", ctx.config["denoiser"]["widths"])),
            ctx.config["denoiser"]["lateral_features"])


def make_pool(seed, device, pool, patch):
    """(inputs [pool, p, p, 14], targets [pool, p, p, 3]) on the host."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) ^ 0x5EED)
    lo = torch.tensor([r[0] for r in RANGES], device=device)
    hi = torch.tensor([r[1] for r in RANGES], device=device)
    x = torch.rand((pool, patch, patch, len(RANGES)), generator=gen, device=device)
    x = x * (hi - lo) + lo
    return x[..., :14].contiguous().cpu().numpy(), x[..., 14:].contiguous().cpu().numpy()


def _state(ctx, model_class, train):
    pool, patch, batch, widths, lateral = _sizes(ctx)
    model = model_class(widths, lateral)
    model.load_state_dict(common.port_state_dict(
        common.fpn_weights(ctx.seed, ctx.device, widths, lateral)))
    return train.create_state(model, ctx.device)


def setup(ctx):
    from pathtrace_tpu_torch import train
    from pathtrace_tpu_torch.models.denoise_cnn import DenoiseCNN

    pool, patch, batch, widths, lateral = _sizes(ctx)
    inputs, targets = make_pool(ctx.seed, ctx.device, pool, patch)
    # the first SGD step imports torch._dynamo and cuDNN picks its
    # algorithms: none of that may fall into the window
    warm = _state(ctx, DenoiseCNN, train)
    train.loop_epoch(warm, inputs, targets, np.arange(batch), batch)
    train.loop_epoch(warm, inputs, targets, np.arange(batch, 3 * batch), batch)
    del warm
    rng = np.random.default_rng([int(ctx.seed) & 0xFFFFFFFFFFFF, 5])
    return dict(ctx=ctx, train=train, st=_state(ctx, DenoiseCNN, train), inputs=inputs,
                targets=targets, rng=rng, sizes=(pool, patch, batch, widths, lateral))


def window(state, seconds):
    pool, patch, batch, _, _ = state["sizes"]
    loop_epoch, st = state["train"].loop_epoch, state["st"]
    x, y = state["inputs"], state["targets"]
    calls = []  # (steps, mean loss) of each loop_epoch call

    def run(rows):
        calls.append((len(rows) // batch, loop_epoch(st, x, y, rows, batch)))

    t0 = time.perf_counter()
    order = state["rng"].permutation(pool)
    run(order[:batch])
    first_grad = {k: v.detach().clone() for k, v in st.momentum().items()}
    run(order[batch:CHECKED_STEPS * batch])
    after = {k: p.detach().clone() for k, p in st.model.named_parameters()}
    run(order[CHECKED_STEPS * batch:])
    while time.perf_counter() - t0 < seconds:
        run(state["rng"].permutation(pool))
    return {"attempted": sum(n for n, _ in calls),
            "failed": sum(n for n, loss in calls if not np.isfinite(loss)),
            "losses": [loss for _, loss in calls[:2]],
            "rows": order[:CHECKED_STEPS * batch], "first_grad": first_grad, "after": after}


def end_to_end(state, record):
    # its end-to-end metric is the device's, read from the traced window
    return {}


def work(state, record):
    pool, patch, batch, widths, lateral = state["sizes"]
    return {"units": record["attempted"],
            "ops_per_unit": 3 * ops.conv_operations(batch, patch, patch, widths, lateral)}


def reference_steps(state, rows, tf32=False, half_batch=False):
    """The first steps by the reference on ``rows`` -> (the first step's
    loss and the mean of the next two, first gradient, change)."""
    ctx = state["ctx"]
    pool, patch, batch, widths, lateral = state["sizes"]
    t = ctx.config["training"]
    lr, mom = t["learning_rate"], t["momentum"]
    w0 = common.fpn_weights(ctx.seed, ctx.device, widths, lateral)
    names = [k for k in fpn.shapes(widths, lateral) if not k.endswith(("running_mean",
                                                                        "running_var"))]
    p = {k: (w0[k].clone().requires_grad_(True) if k in names else w0[k]) for k in w0}
    buf, losses, first = {}, [], {}
    keep = batch // 2 if half_batch else batch
    for step in range(CHECKED_STEPS):
        idx = rows[step * batch:(step + 1) * batch][:keep]
        x = torch.from_numpy(state["inputs"][idx]).to(ctx.device)
        y = torch.from_numpy(state["targets"][idx]).to(ctx.device)
        with fpn.precision(tf32):
            loss = fpn.l1(fpn.forward(p, x, train=True, widths=widths), y)
            grads = torch.autograd.grad(loss, [p[k] for k in names])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for k, g in zip(names, grads):
                if step == 0:
                    first[k] = g.clone()
                buf[k] = g.clone() if step == 0 else mom * buf[k] + g
                p[k] -= lr * (g + mom * buf[k])
    change = {k: p[k].detach() - w0[k] for k in names}
    return [losses[0], sum(losses[1:]) / (len(losses) - 1)], first, change


def check(state, record, variant=None):
    """loss_gap: the larger relative gap of the first step's loss and of the
    mean loss of the next two; grad_gap and change_gap: the worst leaf's gap
    of norms (``common.norm_gap``)."""
    if variant not in (None, "tf32", "half_batch"):
        raise ValueError(f"train has no variant {variant!r}")
    limits = state["ctx"].workload["limits"]
    rows = record["rows"]
    state.pop("st", None)
    if variant is None:
        pool, patch, batch, widths, lateral = state["sizes"]
        w0 = common.fpn_weights(state["ctx"].seed, state["ctx"].device, widths, lateral)
        got = (record["losses"], record.pop("first_grad"),
               {k: v - w0[k] for k, v in record.pop("after").items()})
        del w0
    else:
        record.pop("first_grad"), record.pop("after")
        got = reference_steps(state, rows, tf32=variant == "tf32",
                              half_batch=variant == "half_batch")
    ref = reference_steps(state, rows)
    return [
        ("loss_gap", max(common.relative_gap(g, r) for g, r in zip(got[0], ref[0])),
         limits["loss_gap"]),
        ("grad_gap", common.norm_gap(got[1], ref[1]), limits["grad_gap"]),
        ("change_gap", common.norm_gap(got[2], ref[2]), limits["change_gap"]),
    ]
