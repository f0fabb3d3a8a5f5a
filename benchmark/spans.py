"""The program's own spans and launch counters over a cell's measured window.

    python3 -m benchmark.spans --workload <cell> --seed <n> --seconds <s> [--profile 0|1]

``pathtrace_tpu_torch.utils.timing`` records, between ``start_recording``
and ``stop_recording``, the spans its entry points mark (a frame's render,
denoise and display; an inverse step's gradients and Adam; a training
step's upload, forward, backward, SGD and loss read) and the host time of
each kernel wrapper's launches, on ``time.time_ns()``, the clock
``torch.profiler`` puts its events on. This module holds what reads them:

- ``span_ms``, ``idle_ms``, ``launch_us``: the arithmetic of the readers
  ``metrics/host_ms.*``, ``metrics/idle_ms.*`` and ``metrics/launch_us.*``,
  on a ``tracing.Trace`` that also carries ``spans``, ``launches``,
  ``launch_ns`` and ``idle`` (the device's idle intervals in the recorded
  window, ``idle_intervals``); on a trace without them each returns None.
- ``record_cell``, the command: one run of a cell as ``harness.run_cell``
  runs it with ``--trace 1`` (set-up, the window profiled for the device's
  activity, the check), with the recording around the window, and one JSON
  line: the readers' values, each span's host ms a unit, the share of each
  root span its children cover, and the device's idle time by span. With
  ``--profile 0`` the window is not profiled: the spans and the launches'
  host time, which the program stamps itself, without CUPTI's cost a
  launch, and no device idle time.

``harness.run_cell`` does not record, so ``BENCHMARK.json`` names none of
these metrics; ``CELL_METRICS`` says which cell each belongs to. Once it
records, ``record_cell``, ``idle_intervals`` and the command go, and
``tracing.summarize`` keeps the idle intervals it computes.
"""

from __future__ import annotations

import argparse
import bisect
import json
import math
import statistics
import sys
import tempfile
import time
from collections import defaultdict
from types import SimpleNamespace

from benchmark import common, harness, tracing

CELL_METRICS = {
    "cornell-diffuse.preview": ("host_ms.frame.render", "host_ms.frame.denoise",
                                "host_ms.frame.display", "idle_ms.frame.denoise"),
    "cornell-nee.inverse_geometry": ("host_ms.inverse.grads", "host_ms.inverse.adam",
                                     "idle_ms.inverse.grads", "launch_us.inverse"),
    "cornell-diffuse.train": ("host_ms.train.upload", "host_ms.train.forward",
                              "host_ms.train.backward", "host_ms.train.sgd",
                              "host_ms.train.loss_read", "idle_ms.train.backward"),
}


# -- the readers' arithmetic ------------------------------------------------------

def _named(trace, name):
    return [(s, e) for n, s, e, _, _ in trace.spans if n == name]


def overlaps_ns(intervals, spans) -> list:
    """The time each of ``spans`` ((start, end)) shares with the sorted,
    disjoint ``intervals``."""
    starts = [s for s, _ in intervals]
    out = []
    for s, e in spans:
        i, total = max(bisect.bisect_right(starts, s) - 1, 0), 0
        while i < len(intervals) and intervals[i][0] < e:
            total += max(0, min(intervals[i][1], e) - max(intervals[i][0], s))
            i += 1
        out.append(total)
    return out


def span_ms(trace, work, name):
    """The host's ms a unit of work in the spans ``name`` (every span lies in
    the recorded window: it opened and closed while recording)."""
    spans = getattr(trace, "spans", None)
    if not spans or not work.get("units"):
        return None
    named = _named(trace, name)
    return 1e-6 * sum(e - s for s, e in named) / work["units"] if named else None


def idle_ms(trace, work, name):
    """The device's idle ms a unit of work inside the spans ``name``."""
    if not getattr(trace, "spans", None) or getattr(trace, "idle", None) is None \
            or not work.get("units"):
        return None
    named = _named(trace, name)
    return 1e-6 * sum(overlaps_ns(trace.idle, named)) / work["units"] if named else None


def launch_us(trace, keys):
    """The host's us a launch inside the kernel wrappers ``keys``."""
    launches, ns = getattr(trace, "launches", None), getattr(trace, "launch_ns", None)
    if launches is None or ns is None:
        return None
    n = sum(launches.get(k, 0) for k in keys)
    return 1e-3 * sum(ns.get(k, 0) for k in keys) / n if n else None


# -- the recorded window ----------------------------------------------------------

def idle_intervals(prof, w0: int, w1: int) -> list:
    """The device's idle intervals in [w0, w1] (ns, the profiler's clock):
    the complement of the union of its activity, kernels, copies and fills."""
    busy = []
    for e in prof.profiler.kineto_results.events():
        if "CUDA" not in str(e.device_type()).upper() or e.is_user_annotation() \
                or e.name() == tracing.WINDOW_SPAN:
            continue
        s, t = max(tracing._ns(e, "start"), w0), min(tracing._ns(e, "end"), w1)
        if t > s:
            busy.append((s, t))
    gaps, last = [], w0
    for s, t in sorted(busy):
        if s > last:
            gaps.append((last, s))
        last = max(last, t)
    if w1 > last:
        gaps.append((last, w1))
    return gaps


def attach(trace, recording, idle=None):
    """``trace`` with the recording's spans and launches, and ``idle``."""
    trace.spans, trace.launches = recording.spans, recording.launches
    trace.launch_ns, trace.idle = recording.launch_ns, idle
    return trace


def span_report(trace, work) -> dict:
    """Each span's host ms a unit; for each root span, the share of its time
    its children cover; with ``idle``, the device's idle ms a unit in each
    span outside its children (its own), by name, and outside every span."""
    units, spans = work["units"], trace.spans
    host = {n: span_ms(trace, work, n) for n in sorted({n for n, *_ in spans})}
    covered, total = defaultdict(int), defaultdict(int)
    for n, s, e, parent, _ in spans:
        if parent is None:
            total[n] += e - s
        else:
            covered[spans[parent][0]] += e - s
    report = {"host_ms": host,
              "leaf_share": {n: covered[n] / total[n] for n in total if covered[n]}}
    if trace.idle is not None:
        inside = overlaps_ns(trace.idle, [(s, e) for _, s, e, _, _ in spans])
        own = defaultdict(int)
        for i, (n, _, _, parent, _) in enumerate(spans):
            own[n] += inside[i]
            if parent is not None:
                own[spans[parent][0]] -= inside[i]
        whole = sum(e - s for s, e in trace.idle)
        outside = whole - sum(inside[i] for i, sp in enumerate(spans) if sp[3] is None)
        report["idle_ms"] = {**{n: 1e-6 * v / units for n, v in sorted(own.items())},
                             "outside every span": 1e-6 * outside / units}
        report["idle_ms_total"] = 1e-6 * whole / units
    return report


def record_cell(cell: str, seed: int, seconds: float, device, profile: bool = True,
                overrides=None) -> dict:
    """One run of ``cell`` with the program's recorder around its window,
    profiled for the device's activity where ``profile`` -> the result."""
    import torch

    from pathtrace_tpu_torch.utils import timing

    workload = common.load_json("workloads", cell)
    driver = harness.load_driver(workload["driver"])
    on_card = device.type == "cuda"
    profiled = on_card and profile
    with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
        ctx = SimpleNamespace(workload=workload,
                              config=common.load_json("configs", workload["config"]),
                              traffic=workload["traffic"], seed=int(seed), device=device,
                              tmp=tmp, overrides=dict(overrides or {}))
        if on_card:
            torch.cuda.set_device(device)
        state = driver.setup(ctx)
        if on_card:
            torch.cuda.synchronize(device)
        with tracing.traced(profiled) as prof:
            timing.start_recording()
            w0 = time.perf_counter()
            rec = driver.window(state, seconds)
            if on_card:
                torch.cuda.synchronize(device)
            window_s = time.perf_counter() - w0
            recording = timing.stop_recording()
        work = driver.work(state, rec)
        units = work["units"]
        result = {"workload": cell, "seed": int(seed), "profiled": profiled, "units": units,
                  "window_s": window_s, "host_ms": 1e3 * window_s / units}
        if "latency_s" in rec:
            result["frame_p50_ms"] = 1e3 * statistics.median(rec["latency_s"])
        if profiled:
            trace = tracing.summarize(prof, window_s)
            result["idle_share"] = 100.0 * (1.0 - trace.busy_s / window_s)
        else:
            trace = tracing.Trace(window_s=window_s, busy_s=0.0)
        attach(trace, recording,
               idle_intervals(prof, recording.start_ns, recording.stop_ns) if profiled else None)
        result["metrics"] = {m: harness.load_reader(m)(trace, work)
                             for m in CELL_METRICS.get(cell, ())}
        result["spans"] = span_report(trace, work)
        result["launches"] = {k: [n, recording.launch_ns[k]]
                              for k, n in recording.launches.items() if n}
        checks = driver.check(state, rec, None)
    result["correct"] = all(lim is not None and math.isfinite(v) and v <= lim
                            for _, v, lim in checks)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="A cell's window with the program's spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()

    import torch

    if not torch.cuda.is_available():
        print("ERROR: no CUDA device", file=sys.stderr)
        return 2
    result = record_cell(args.workload, args.seed, args.seconds, torch.device("cuda", 0),
                         bool(args.profile))
    result["device"] = f"{torch.cuda.get_device_name(0)}, {harness.power_limit()}"
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
