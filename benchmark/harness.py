"""The benchmark of ``pathtrace_tpu_torch`` on one CUDA card: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is ``benchmark/workloads/<cell>.json``: its configuration
(``benchmark/configs/<name>.json``), its driver (``benchmark/drivers/
<driver>.py``) and its traffic. Set-up (``driver.setup``) builds the
program's state from the seed and warms up the cell's shapes; the window
(``driver.window``) drives the program's entry point for ``--seconds``;
after it ``driver.check`` holds what the window produced against the plain
reference (``benchmark/reference/``). With ``--trace 0`` the result line
holds the cell's end-to-end metrics: those of the host's clock from
``driver.end_to_end``, those of the device's trace each read by
``benchmark/metrics/<name>.py`` from the window traced for its device
activity alone (``benchmark/tracing.py``). With ``--trace 1`` the window is
traced so in every cell and the line holds the cell's per-layer metrics,
each read by ``benchmark/metrics/<name>.py``.
Which metrics a cell reports is ``BENCHMARK.json``'s to say.

The last line on standard output is one JSON object; the last lines on
standard error are the numbers compared, each beside its limit.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

from benchmark import common

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "pathtrace_tpu")
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCHINDUCTOR_CACHE_DIR": "inductor"}


def set_cache_dirs() -> None:
    """Compiler caches at fixed places inside the checkout."""
    base = common.ROOT / ".bench_cache"
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(base / sub)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def benchmark_spec() -> dict:
    with open(common.ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(spec: dict, cell: str) -> tuple:
    """(end-to-end, per-layer) metric entries of ``cell``: an end-to-end
    metric with no ``workloads`` (``setup_s``) is every cell's; a per-layer
    metric lists its cells."""
    e2e = [m for m in spec["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    return e2e, [m for m in spec["per_layer"] if cell in m["workloads"]]


def load_driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def load_reader(metric: str):
    path = common.BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def power_limit() -> str:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "unknown"
    try:
        out = subprocess.run([smi, "-i", "0", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.stdout.strip() or "unknown"


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device, t0=None,
             overrides=None, variant=None, spec=None) -> dict:
    """One run of ``cell`` on ``device`` -> the result object. The command
    gives neither ``overrides`` (smaller sizes, for the CPU tests) nor
    ``variant`` (the control or a fault in the program's place, for
    ``calibrate.py``; only the check reads it)."""
    import torch

    from benchmark import tracing

    t0 = time.perf_counter() if t0 is None else t0
    spec = benchmark_spec() if spec is None else spec
    workload = common.load_json("workloads", cell)
    config = common.load_json("configs", workload["config"])
    driver = load_driver(workload["driver"])
    on_card = device.type == "cuda"
    with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
        ctx = SimpleNamespace(workload=workload, config=config,
                              traffic=workload["traffic"], seed=int(seed), device=device,
                              tmp=tmp, overrides=dict(overrides or {}))
        if on_card:
            torch.cuda.set_device(device)  # initialises CUDA, which the memory counters need
            torch.cuda.reset_peak_memory_stats(device)
        state = driver.setup(ctx)
        if on_card:
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t0
        e2e, layer = cell_metrics(spec, cell)
        # the card's trace, which the CPU (in the tests) has none of
        from_trace = [m for m in e2e if m["source"] == "device_trace"] if on_card else []
        with tracing.traced(trace or bool(from_trace)) as prof:
            w0 = time.perf_counter()
            record = driver.window(state, seconds)
            if on_card:
                torch.cuda.synchronize(device)
            window_s = time.perf_counter() - w0
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        metrics = {}
        device_info = {"platform": "gpu" if on_card else "cpu",
                       "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                       "count": 1, "memory_peak_bytes": int(peak)}
        breakdown = None
        if trace:
            summary = tracing.summarize(prof, window_s)
            work = driver.work(state, record)
            # what the host does in the device's idle gaps, from a short window
            # of its own after the measured one, profiled with the host's operations
            with tracing.traced(True, host=True) as host_prof:
                with torch.profiler.record_function(tracing.WINDOW_SPAN):
                    driver.window(state, tracing.HOST_SECONDS)
                    if on_card:
                        torch.cuda.synchronize(device)
            summary.idle_by_host = tracing.summarize(host_prof).idle_by_host
            for m in layer:
                value = load_reader(m["name"])(summary, work)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            device_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
            breakdown = summary.breakdown()
        else:
            values = driver.end_to_end(state, record)
            values["setup_s"] = setup_s
            if from_trace:
                summary, work = tracing.summarize(prof, window_s), driver.work(state, record)
                for m in from_trace:
                    values[m["name"]] = load_reader(m["name"])(summary, work)
            for m in e2e:
                metrics[m["name"]] = {"value": values.get(m["name"]), "unit": m["unit"]}
        checks = driver.check(state, record, variant)
    correct = all(lim is not None and math.isfinite(v) and v <= lim
                  for _, v, lim in checks)
    result = {"correct": bool(correct), "attempted": int(record["attempted"]),
              "failed": int(record.get("failed", 0)), "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["window_s"] = window_s
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return result


def main(argv=None, t0=None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description="One run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    os.environ.setdefault("USE_FLAX", "0")

    import torch

    spec = benchmark_spec()
    chips = {w["name"]: w["chips"] for w in spec["workloads"]}[args.workload]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"ERROR: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device, t0,
                      spec=spec)
    found = forbidden_modules()
    if found:
        print(f"ERROR: modules of JAX or of the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    result["device"]["power_limit"] = power_limit()
    print(f"device: {result['device']['kind']}, power limit {result['device']['power_limit']}",
          file=sys.stderr)
    print(f"window: {result['attempted']} units in {result['window_s']!r} s", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
