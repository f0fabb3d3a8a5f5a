"""Timing + throughput on a CUDA device.

The reference brackets each kernel with cudaEvents and prints ms/fps
(``include/Renderer.h:63-75``); ``time_fn`` does the same with
``torch.cuda.Event`` pairs (``best_seconds``: the least of a few calls,
by the host clock where a caller asked for the CPU); ``device_name`` is
the card's name and power limit, which go beside every time kept. The
throughput metric of the repo is

    Mrays/s = W * H * spp * max_bounces / time

(path segments per second). ``trace`` records a ``torch.profiler`` trace
of a block; ``MetricsLogger`` prints per-frame or per-step fields and
appends them to a JSONL file.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import subprocess
import time
from typing import Callable, List, Tuple

import torch


def device_name(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them; without nvidia-smi the
    name torch gives and "power limit unknown"; "cpu" on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    smi = shutil.which("nvidia-smi")
    if smi is not None:
        try:
            proc = subprocess.run([smi, "-i", str(index), "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"],
                                  capture_output=True, text=True, timeout=30)
            if proc.returncode == 0 and proc.stdout.strip():
                return proc.stdout.strip().splitlines()[0]
        except (OSError, subprocess.SubprocessError):
            pass
    return f"{torch.cuda.get_device_name(index)}, power limit unknown"


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 10,
            device=None, **kwargs) -> Tuple[List[float], object]:
    """Run ``fn(*args, **kwargs)`` ``warmup`` times, then time ``iters``
    runs one by one with CUDA events on the current stream of ``device``.
    Returns (per-run milliseconds, last result). Needs a CUDA device: the
    events time the card, not the host."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_fn needs a CUDA device")
    device = torch.device("cuda", torch.cuda.current_device()) if device is None else device
    result = None
    for _ in range(warmup):
        result = fn(*args, **kwargs)
    torch.cuda.synchronize(device)
    times = []
    for _ in range(max(iters, 1)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(device))
        result = fn(*args, **kwargs)
        end.record(torch.cuda.current_stream(device))
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times, result


def best_seconds(fn: Callable, reps: int = 3, device=None) -> float:
    """The least seconds of one call of ``fn()`` in ``reps`` calls after one
    warm-up: CUDA events (``time_fn``) on a CUDA device, the host clock on
    the CPU, which only a caller's own ``device="cpu"`` selects."""
    device = torch.device("cuda", torch.cuda.current_device()) if device is None else device
    if torch.device(device).type != "cpu":
        ms, _ = time_fn(fn, warmup=1, iters=max(reps, 1), device=device)
        return min(ms) / 1e3
    fn()
    seconds = []
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        fn()
        seconds.append(time.perf_counter() - t0)
    return min(seconds)


def mrays_per_sec(width: int, height: int, spp: int, max_bounces: int, seconds: float) -> float:
    return width * height * spp * max_bounces / seconds / 1e6


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of the block, written to ``log_dir`` as a
    Chrome trace (``*.pt.trace.json``); the card's kernels are recorded where
    there is a CUDA device. Yields the profiler, whose ``key_averages()``
    sums the time by operation."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


class MetricsLogger:
    """Structured per-frame/per-step metrics to stdout and an optional JSONL
    file (``pathtrace_tpu.utils.timing.MetricsLogger``)."""

    def __init__(self, jsonl_path=None, quiet=False):
        self.path = jsonl_path
        self.quiet = quiet
        self._fh = open(jsonl_path, "a") if jsonl_path else None

    def log(self, **fields):
        fields.setdefault("ts", time.time())
        if not self.quiet:
            printable = {k: v for k, v in fields.items() if k != "ts"}
            print(" ".join(f"{k}={v}" for k, v in printable.items()))
        if self._fh:
            self._fh.write(json.dumps(fields) + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
