"""Rank-side checks of the grid: what a launched world runs for the tests
and for ``chip_smoke.py``, and returns to the parent, which compares.

``run_cases(cases)`` runs a list of cases on every rank of the world, each
on its own grid of the world's ranks, and returns one result a case; a
case is a dict with ``kind`` and ``grid`` (tiles, samples):

- ``"render"`` (scene, cam, cfg): the frame [H, W, 14] every rank holds;
- ``"grads"`` (scene, cam, cfg, target): loss and the seven gradients;
- ``"grad_slab"`` (the same): this rank's launch of the route's backward
  kernel as ``sharded_loss_grads`` makes it (``shard.kernel_slab_launch``:
  the K2 dump's "color" and "acc" and their "scale", or the K3 or K4
  replay's "block" against the cotangent 2 "diff" / (H W 3) of the mean
  colour), with the launch's "seed" block, "local_h" and "spp";
- ``"simple"`` (model, channels [H, W, 14]): ``denoise_spatially_sharded``
  of the rank's rows, joined [H, W, 3];
- ``"oneshot"`` (the same, and ``halo``): the whole ``SimpleDenoiseCNN``
  applied once to a halo of ``halo`` rows, the exchange that must diverge;
- ``"fpn"`` (model, channels): ``denoise_fpn_sharded``, joined;
- ``"render_denoise"`` (scene, cam, cfg, simple, fpn): a frame rendered
  over the grid, its slabs preprocessed (``preprocess_channels_sharded``)
  and passed to both denoisers without the frame being gathered; ``fpn``
  is a list of models, each of which denoises the same slabs; returns the
  frame, the preprocessed input and the outputs ("fpn" a list), each
  joined;
- ``"mesh"``: the default grid shapes of the world and the error of a
  shape that does not factor it.

A model is a spec of ``build_model``.

``card_world`` is the chip smoke's rank function: the cases with every
launch count of ``utils/timing.py`` set to 0 before and read after, then
each rank's slab launches of the forward and backward kernels beside what
their plain versions need, then the timings.

``dp_world`` is the data-parallel trainer's rank function, for the tests
and the chip smoke alike (``dp_world``'s docstring).
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from pathtrace_tpu_torch.convert import grads_to_numpy
from pathtrace_tpu_torch.parallel import shard
from pathtrace_tpu_torch.parallel.mesh import make_mesh
from pathtrace_tpu_torch.utils import timing


def build_model(spec: dict, device="cpu"):
    """The denoiser a case names, in eval mode on ``device``: ``spec`` holds
    ``"kind"`` ("simple": ``SimpleDenoiseCNN(features, depth)``; "fpn":
    ``DenoiseCNN(widths)``) and either ``"state"`` (a state dict) or
    ``"seed"`` (Flax's initialisation drawn from a generator of that seed,
    then, for "fpn", every BatchNorm's scale, bias, mean and variance drawn
    from it too, so that the sharded BatchNorm has work to do)."""
    from pathtrace_tpu_torch.models.denoise_cnn import BatchNorm, DenoiseCNN, flax_init_
    from pathtrace_tpu_torch.models.simple_cnn import SimpleDenoiseCNN

    if spec["kind"] == "simple":
        model = SimpleDenoiseCNN(spec["features"], spec["depth"])
    else:
        model = DenoiseCNN(spec["widths"])
    if "state" in spec:
        model.load_state_dict(spec["state"])
    else:
        gen = torch.Generator().manual_seed(spec["seed"])
        flax_init_(model, gen)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, BatchNorm):
                    c = m.num_features
                    m.weight.copy_(0.5 + torch.rand(c, generator=gen))
                    m.bias.copy_(0.4 * torch.rand(c, generator=gen) - 0.2)
                    m.running_mean.copy_(torch.rand(c, generator=gen) - 0.5)
                    m.running_var.copy_(0.5 + 1.5 * torch.rand(c, generator=gen))
    return model.to(device).eval()


def _case(case: dict, device):
    from pathtrace_tpu_torch.models.fpn_spatial import denoise_fpn_sharded
    from pathtrace_tpu_torch.models.spatial import (apply_layers_sharded,
                                                    denoise_spatially_sharded,
                                                    preprocess_channels_sharded)

    kind = case["kind"]
    if kind == "mesh":
        shapes = [make_mesh(device=device).shape, make_mesh(samples=2, device=device).shape]
        try:
            make_mesh(tiles=3, device=device)
            error = None
        except ValueError as e:
            error = str(e)
        return {"shapes": shapes, "error": error}
    mesh = make_mesh(*case["grid"], device=device)
    if kind == "render":
        return shard.render_channels_sharded(case["scene"], case["cam"], case["cfg"], mesh)
    if kind == "grads":
        loss, (d_scene, d_cam) = shard.sharded_loss_grads(case["scene"], case["cam"],
                                                          case["cfg"], mesh, case["target"])
        return {"loss": float(loss), "grads": grads_to_numpy(d_scene, d_cam)}
    if kind in ("simple", "oneshot"):
        model = build_model(case["model"], mesh.device)
        local = shard.shard_rows(torch.as_tensor(case["channels"]), mesh).to(mesh.device)
        if kind == "simple":
            out = denoise_spatially_sharded(local, mesh, model)
        else:
            def whole_net(img):
                return model(img[None])[0]

            with torch.no_grad():
                out = apply_layers_sharded([whole_net], local, mesh, halo=case["halo"])
        return shard.gather_rows(out, mesh)
    if kind == "fpn":
        model = build_model(case["model"], mesh.device)
        local = shard.shard_rows(torch.as_tensor(case["channels"]), mesh).to(mesh.device)
        return shard.gather_rows(denoise_fpn_sharded(local, mesh, model), mesh)
    if kind == "render_denoise":
        slab = shard.render_slab_sharded(case["scene"], case["cam"], case["cfg"], mesh)
        x = preprocess_channels_sharded(slab, mesh)
        fpn = [shard.gather_rows(denoise_fpn_sharded(x, mesh, build_model(spec, mesh.device)),
                                 mesh) for spec in case["fpn"]]
        simple = build_model(case["simple"], mesh.device)
        return {"frame": shard.gather_rows(slab, mesh), "input": shard.gather_rows(x, mesh),
                "fpn": fpn,
                "simple": shard.gather_rows(denoise_spatially_sharded(x, mesh, simple), mesh)}
    if kind == "grad_slab":
        from pathtrace_tpu_torch.ops import trace_kernel as tk

        out = shard.kernel_slab_launch(case["scene"], case["cam"], case["cfg"], mesh,
                                       case["target"])
        ext = out.pop("ext")
        out["seed"] = tk.make_seed_block(case["cfg"], 0, ext["sample_offset"],
                                         ext["row_offset"])
        return dict(out, local_h=ext["local_h"], spp=ext["spp"])
    raise ValueError(f"unknown case kind {kind!r}")


def run_cases(cases, device=None) -> list:
    """Every case on this rank, in order -> one result a case."""
    return [_case(case, device) for case in cases]


def _timed_fn(case: dict, device):
    """The call a timing case names, its inputs made beforehand: the sharded
    render of a ``"render"`` case, the single-device ``render.
    render_channels`` of a ``"single"`` case (the same cfg), or
    ``denoise_fpn_sharded`` (its first model) of a ``"render_denoise"``
    case's preprocessed slab, rendered once, untimed. -> (fn, its device)."""
    from pathtrace_tpu_torch.models.fpn_spatial import denoise_fpn_sharded
    from pathtrace_tpu_torch.models.spatial import preprocess_channels_sharded
    from pathtrace_tpu_torch.render import render_channels

    mesh = make_mesh(*case["grid"], device=device)
    args = (case["scene"], case["cam"], case["cfg"])
    if case["kind"] == "render":
        return (lambda: shard.render_channels_sharded(*args, mesh)), mesh.device
    if case["kind"] == "single":
        return (lambda: render_channels(*args, device=mesh.device)), mesh.device
    x = preprocess_channels_sharded(shard.render_slab_sharded(*args, mesh), mesh)
    model = build_model(case["fpn"][0], mesh.device)
    return (lambda: denoise_fpn_sharded(x, mesh, model)), mesh.device


def _ms(fn, device) -> float:
    """Milliseconds of one call: CUDA events on a card, the host's clock on
    the CPU."""
    if device.type == "cuda":
        from pathtrace_tpu_torch.utils.timing import time_fn

        return time_fn(fn, warmup=0, iters=1, device=device)[0][0]
    t0 = time.perf_counter()
    fn()
    return 1e3 * (time.perf_counter() - t0)


def card_world(cases, slab_checks=(), grad_checks=(), timings=(), scaling=None,
               iters: int = 10, device=None) -> dict:
    """The chip smoke's rank function.

    1. ``cases`` (``run_cases``) with the launch counts set to 0 just before
       and read just after (``launches``).
    2. For each (scene, cam, cfg, grid) of ``slab_checks``: this rank's slab
       partials [H/t, W, 22] (one more launch, to be held against the plain
       version by the parent), the seed block and sizes of the launch, and
       the sample lanes the kernel gave it (None on the CPU).
    3. ``grad_checks``, ``"grad_slab"`` cases (``run_cases``): this rank's
       launch of each route's backward kernel with what it was given, for
       the parent to hold against the plain version on the same inputs.
    4. For each (label, cases) of ``timings``: the ms of each case's call
       (``_timed_fn``), after one warm-up of each, in ``iters`` turns that
       call the cases one after the other, so that a drift of the card or
       the host falls on all of them alike -> ``times[label]`` [case][turn].
    5. ``scaling`` (scene, cam, cfg, rank counts): ``scaling.measure_scaling``
       over the first n ranks of the world.
    """
    from pathtrace_tpu_torch.ops import trace_kernel as tk
    from pathtrace_tpu_torch.parallel.scaling import measure_scaling

    timing.reset_launch_counts()
    results = run_cases(cases, device)
    launches = timing.launch_counts()
    slabs = []
    for scene, cam, cfg, grid in slab_checks:
        mesh = make_mesh(*grid, device=device)
        ext = shard.slab_extent(cfg, mesh)
        out = shard.slab_partials(scene, cam, cfg, mesh)
        seed = tk.make_seed_block(cfg, 0, ext["sample_offset"], ext["row_offset"])
        lanes = (tk.sample_lanes(ext["spp"], cfg.block, ext["local_h"] * cfg.width,
                                 tk.device_sm_count(mesh.device))
                 if mesh.device.type == "cuda" else None)  # the plain version has none
        slabs.append({"partials": out, "seed": seed, "local_h": ext["local_h"],
                      "spp": ext["spp"], "lanes": lanes})
    grad_slabs = run_cases(grad_checks, device)
    times = {}
    for label, group in timings:
        fns = [_timed_fn(case, device) for case in group]
        for fn, dev in fns:
            fn()
        turns = [[_ms(fn, dev) for fn, dev in fns] for _ in range(max(iters, 1))]
        times[label] = [list(col) for col in zip(*turns)]
    rows = None
    if scaling is not None:
        scene, cam, cfg, counts = scaling
        rows = measure_scaling(scene, cam, cfg, counts, iters=iters, device=device)
    return {"rank": dist.get_rank(), "backend": dist.get_backend(), "results": results,
            "launches": launches, "slabs": slabs, "grad_slabs": grad_slabs, "times": times,
            "scaling": rows}


def _dp_case(case: dict, device) -> object:
    from pathtrace_tpu_torch import train
    from pathtrace_tpu_torch.utils.metrics import JsonlLogger

    kind = case["kind"]
    if kind == "sharding":
        splits = [train.dp_sharding(b, devices) for b, devices in case["splits"]]
        return [None if dp is None else (dp.index, dp.size) for dp in splits]
    if kind == "fit" and case.get("resume"):
        state = train.load_train_state(case["kwargs"]["ckpt_dir"], device=device)
    else:
        state = train.state_from_payload(case["model"], device)
    if kind == "steps":
        losses, grads = [], None
        for x, y in case["batches"]:
            dp = (train.DataParallel(dist.group.WORLD, dist.get_rank(), dist.get_world_size())
                  if case.get("whole_world") else train.dp_sharding(x.shape[0]))
            loss = train.train_step(state, x, y, dp)
            losses.append(float(loss))
            if grads is None:  # the first step's gradients, summed over the ranks
                grads = {n: p.grad.detach().cpu().clone()
                         for n, p in state.model.named_parameters()}
        return {"losses": losses, "grads": grads, "state": state.state_dict()}
    if kind == "epoch":
        loss = train.train_epoch(state, case["inputs"].to(device), case["targets"].to(device),
                                 case["perm"], case["batch_size"],
                                 train.dp_sharding(case["batch_size"]))
        return {"loss": float(loss), "state": state.state_dict()}
    if kind == "fit":
        with JsonlLogger(case["metrics"]) as metrics:
            state, history = train.fit(state, case["inputs"], case["targets"], metrics=metrics,
                                       logger=lambda *a: None, **case["kwargs"])
        return {"history": history, "state": None if state is None else state.state_dict()}
    raise ValueError(f"unknown case kind {kind!r}")


def dp_world(cases, timing=None, device=None) -> dict:
    """The data-parallel trainer's rank function: every case in order on this
    rank's device, each step split by ``train.dp_sharding`` over the world's
    ranks. A case is a dict with ``kind``:

    - ``"sharding"`` (``splits``: [(batch_size, devices)]): what
      ``dp_sharding`` gives this rank for each, (index, size) or None;
    - ``"steps"`` (``model``: ``train.state_payload``; ``batches``: [(x, y)]
      CPU tensors, each a whole minibatch; ``whole_world``: split over every
      rank of the world, a world of one too): ``train_step`` on each ->
      the losses, the first step's gradients (after the all-reduce) and the
      final ``TrainState.state_dict``;
    - ``"epoch"`` (``model``, ``inputs``, ``targets``, ``perm``,
      ``batch_size``): ``train_epoch`` on the dataset moved to the device ->
      the mean loss and the state;
    - ``"fit"`` (``model``, or ``resume`` from ``kwargs["ckpt_dir"]``;
      ``inputs``, ``targets`` numpy; ``metrics`` a JSONL path every rank
      opens; ``kwargs`` of ``fit``) -> the history and the state.

    ``timing`` (model, x, y, iters): the split step on every rank and, on
    rank 0, a single-device step of the whole batch from the same weights,
    called in turns after one warm-up of each -> ``times`` {"dp", "single"}
    in ms (CUDA events on a card) on rank 0.
    -> {"rank", "backend", "results", "times", "entered": the wall clock
    when this function was entered, "seconds": each case's}."""
    from pathtrace_tpu_torch import train
    from pathtrace_tpu_torch.parallel.mesh import rank_device

    entered = time.time()
    dev = rank_device(device)
    results, seconds = [], []
    for case in cases:
        t0 = time.perf_counter()
        results.append(_dp_case(case, dev))
        seconds.append(time.perf_counter() - t0)
    times = {}
    if timing is not None:
        model, x, y, iters = timing
        dp = train.dp_sharding(x.shape[0])
        split = train.state_from_payload(model, dev)
        single = train.state_from_payload(model, dev) if dist.get_rank() == 0 else None
        x, y = x.to(dev), y.to(dev)
        fns = [("dp", lambda: train.train_step(split, x, y, dp))]
        if single is not None:
            fns.append(("single", lambda: train.train_step(single, x, y)))
        for _, fn in fns:
            fn()
        for _ in range(iters):
            for label, fn in fns:
                times.setdefault(label, []).append(_ms(fn, dev))
    return {"rank": dist.get_rank(), "backend": dist.get_backend(), "results": results,
            "times": times, "entered": entered, "seconds": seconds}
