"""What the trainer's exact BatchNorm statistics and its determinism cost on the card.

The port's training step (``train.train_step``) normalises with Flax's
batch statistics (``models.denoise_cnn.batch_stats``: E[x^2] - E[x]^2, the
formula that also serves a data-parallel group) through ``_TrainBatchNorm``,
runs cuDNN's deterministic algorithms and takes the bilinear resize's
backward as a product with its interpolation matrices, so that a step gives
the same bits from run to run. This script measures, on one CUDA device:

1. determinism: from one state, two ``loop_epoch``s and one ``train_epoch``
   over the same order (105 steps each at batch 5) must give the same bits;
2. cost: the step at batch 5 of 64x64 patches, the full-width CNN, f32,
   CUDA events in turns (port, reference, reference, port; median of
   ``--iters`` a turn) against a reference step made of torch's own fused
   pieces: ``F.batch_norm``'s training mode (cuDNN; two-pass statistics, one
   device only, not Flax's formula), ``F.interpolate``'s backward (atomic
   adds) and cuDNN's default algorithms, which is the step the port ran
   before its statistics served a group; and the kernels a step of each by
   ``torch.profiler``.

The reference is assembled here only, by replacing the port's BatchNorm and
resize in this process; the port never runs it. The data are uniform
patches from a seed (the step's cost does not depend on them).

Usage, from the root of a checkout, on a machine with a CUDA device:

    python scripts/torch_train_step_cost.py [--iters 10] [--turns 4]
"""

from __future__ import annotations

import argparse
import contextlib
import os
import statistics
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PATCHES, PATCH, BATCH = 525, 64, 5


def reference_step(dc, train):
    """Context: the port's BatchNorm, resize and determinism replaced by
    torch's fused pieces for the block."""
    import torch
    import torch.nn.functional as F

    def fused_batch_norm(self, x, group=None):
        if not self.training:
            return torch.nn.BatchNorm2d.forward(self, x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def interpolate_add(x, y):
        return F.interpolate(x, size=tuple(y.shape[-2:]), mode="bilinear",
                             align_corners=False) + y

    @contextlib.contextmanager
    def swapped():
        saved = dc.BatchNorm.forward, dc._upsample_add, train.cudnn_deterministic
        dc.BatchNorm.forward, dc._upsample_add = fused_batch_norm, interpolate_add
        train.cudnn_deterministic = contextlib.nullcontext
        try:
            yield
        finally:
            dc.BatchNorm.forward, dc._upsample_add, train.cudnn_deterministic = saved

    return swapped


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--turns", type=int, default=4)
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pathtrace_tpu_torch import train
    from pathtrace_tpu_torch.models import denoise_cnn as dc
    from pathtrace_tpu_torch.models import init_model
    from pathtrace_tpu_torch.utils.timing import device_name, time_fn

    if not torch.cuda.is_available():
        print("torch_train_step_cost: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = device_name(dev)
    print(f"card: {smi}; torch {torch.__version__}")
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(PATCHES, PATCH, PATCH, 14)).astype(np.float32)
    y = np.clip(x[..., 0:3] * (0.00316 + x[..., 6:9]), 0, 1).astype(np.float32)
    start = train.state_payload(train.create_state(init_model(torch.Generator().manual_seed(0)),
                                                   "cpu"))

    # 1. Determinism: the same epoch three times from one state.
    order = rng.permutation(PATCHES)
    xd, yd = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    epochs = {}
    for label in ("loop", "loop again", "scan"):
        state = train.state_from_payload(start, dev)
        if label == "scan":
            train.train_epoch(state, xd, yd, order, BATCH)
        else:
            train.loop_epoch(state, x, y, order, BATCH)
        epochs[label] = state.state_dict()
    same = {label: all(torch.equal(epochs[label][part][k], v) for part in ("model", "momentum")
                       for k, v in epochs["loop"][part].items())
            for label in ("loop again", "scan")}
    print(f"1. an epoch of {PATCHES // BATCH} steps from one state: the loop again gives the "
          f"loop's bits {same['loop again']}, train_epoch {same['scan']}")

    # 2. The step's cost against the reference, in turns.
    state = train.state_from_payload(start, dev)
    b, t = xd[:BATCH], yd[:BATCH]
    swapped = reference_step(dc, train)
    times = {"port": [], "reference": []}
    for _ in range(args.turns):
        for label in ("port", "reference", "reference", "port"):
            with swapped() if label == "reference" else contextlib.nullcontext():
                ms, _ = time_fn(lambda: train.train_step(state, b, t), warmup=3,
                                iters=args.iters, device=dev)
            times[label] += ms
    print(f"2. train_step, batch {BATCH} of {PATCH}x{PATCH}, full width, f32; CUDA events, "
          f"{args.turns} x 2 turns of {args.iters} (median, min..max):")
    for label, ms in times.items():
        with swapped() if label == "reference" else contextlib.nullcontext():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(args.iters):
                    train.train_step(state, b, t)
                torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and "#" not in e.key]
        device_ms = sum(e.self_device_time_total for e in events) / 1e3 / args.iters
        kernels = sum(e.count for e in events) / args.iters
        print(f"  {label:9s} {statistics.median(ms):.4f} ms ({min(ms):.4f}..{max(ms):.4f}); "
              f"device {device_ms:.4f} ms, {kernels:.0f} kernels a step (profiler)")
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
