"""Timing + throughput on a CUDA device.

The reference brackets each kernel with cudaEvents and prints ms/fps
(``include/Renderer.h:63-75``); ``time_fn`` does the same with
``torch.cuda.Event`` pairs (``best_seconds``: the least of a few calls,
by the host clock where a caller asked for the CPU); ``device_name`` is
the card's name and power limit, which go beside every time kept. The
throughput metric of the repo is

    Mrays/s = W * H * spp * max_bounces / time

(path segments per second).

Spans and launch counts: the entry points mark their phases with
``span(name)`` (a frame's render, denoise and display; an inverse step's
gradients and Adam; a training step's upload, forward, backward and SGD),
and each kernel wrapper's ``launch`` counts itself into the one table of
launch counts with ``count_launch``, which also adds the launch's host
time since ``launch_clock`` while recording. ``reset_launch_counts`` sets
every count to 0 and ``launch_counts`` reads them all. Nothing of spans or
host time is recorded unless a caller brackets a block
with ``start_recording()`` and ``stop_recording()``, which returns the
spans closed in between and the launches made, in memory. Spans are stamped
with ``time.time_ns()``, the clock ``torch.profiler`` stamps its host events
with, so they lie on the same time line as a profiler's trace of the block.
The recording is the process's, for one thread.
"""

from __future__ import annotations

import shutil
import subprocess
import time
from dataclasses import dataclass, field
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


# -- spans and launch counts --------------------------------------------------

# The kernel wrappers' launches, by "<kernel>.<mode>": K1 (trace_kernel), K2
# in its fused, dump and replay modes (grad_kernel), K3 fused and replay
# (nee_grad_kernel) and K4's replay (ad_grad_kernel); "k3.replay_taped" and
# "k4.replay_taped" count the replays among K3's and K4's that read a path
# tape (their host time goes to "k3.replay" and "k4.replay").
_LAUNCHES = dict.fromkeys(("k1", "k2.fused", "k2.dump", "k2.replay", "k3.fused", "k3.replay",
                           "k3.replay_taped", "k4.replay", "k4.replay_taped"), 0)
# the counts and host ns a recording reports: the launches of an inverse step
LAUNCH_KEYS = ("k1", "k3.replay", "k3.replay_taped", "k4.replay", "k4.replay_taped", "k2.dump")


@dataclass
class Recording:
    """What ``stop_recording`` returns. ``spans``: (name, start_ns, end_ns,
    parent, unit) in the order they started; ``parent`` is the index of the
    enclosing span (None at the root), ``unit`` the index of the root span
    whose frame or step the span belongs to. ``launches`` and ``launch_ns``:
    the kernel wrappers' launches and the host ns spent in their ``launch``,
    by ``LAUNCH_KEYS``. ``start_ns``, ``stop_ns``: the recording's bounds."""

    spans: list = field(default_factory=list)
    launches: dict = field(default_factory=dict)
    launch_ns: dict = field(default_factory=dict)
    start_ns: int = 0
    stop_ns: int = 0


class _Recorder:
    def __init__(self):
        self.on = False
        self.spans = []
        self.open = []  # (index, unit) of the spans entered and not yet left
        self.last_root = None
        self.launch_ns = {}
        self.counts = {}
        self.start_ns = 0


_REC = _Recorder()


class _Off:
    """The span of a process that is not recording: reads no clock."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "tail", "index", "parent", "unit", "start")

    def __init__(self, name: str, tail: bool):
        self.name, self.tail = name, tail

    def __enter__(self):
        rec = _REC
        self.index = len(rec.spans)
        rec.spans.append(None)  # its place, in the order spans start
        if rec.open:
            self.parent, self.unit = rec.open[-1]
        else:
            self.parent = None
            self.unit = rec.last_root if self.tail else self.index
        rec.open.append((self.index, self.unit))
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        rec = _REC
        rec.open.pop()
        rec.spans[self.index] = (self.name, self.start, end, self.parent, self.unit)
        if self.parent is None and not self.tail:
            rec.last_root = self.index
        return False


def span(name: str, tail: bool = False):
    """A context manager that records the block as the span ``name`` while
    recording, and does nothing otherwise. ``tail``: a span at the root that
    belongs to the unit of the root span closed last (a step's loss, read
    after the step returned)."""
    return _Span(name, tail) if _REC.on else _OFF


def launch_clock() -> int:
    """The clock at the start of a kernel wrapper's ``launch``; 0 when not
    recording."""
    return time.time_ns() if _REC.on else 0


def count_launch(key: str, start_ns: int = 0, taped: bool = False) -> None:
    """Count one launch of ``key`` (a key of the table: any other raises
    KeyError) and, with ``taped``, one of ``key + "_taped"``; add the host ns
    since ``start_ns`` (``launch_clock``; 0 adds none) to ``key``."""
    if taped:
        _LAUNCHES[key + "_taped"] += 1
    _LAUNCHES[key] += 1
    if start_ns:
        _REC.launch_ns[key] = _REC.launch_ns.get(key, 0) + time.time_ns() - start_ns


def reset_launch_counts() -> None:
    """Set every launch count of the table to 0."""
    for key in _LAUNCHES:
        _LAUNCHES[key] = 0


def launch_counts() -> dict:
    """Every launch count of the table, by key (a copy)."""
    return dict(_LAUNCHES)


def start_recording() -> None:
    """Record spans and launches from here (a recording in progress is
    dropped)."""
    rec = _REC
    if rec.open:
        raise RuntimeError("start_recording inside a span")
    rec.spans, rec.last_root, rec.launch_ns = [], None, {}
    rec.counts = launch_counts()
    rec.on = True
    rec.start_ns = time.time_ns()


def stop_recording() -> Recording:
    """Stop recording -> the spans closed and the launches made since
    ``start_recording``; an empty ``Recording`` where none was started.
    Raises inside a span, whose end would be lost."""
    rec = _REC
    if not rec.on:
        return Recording()
    if rec.open:
        raise RuntimeError("stop_recording inside a span")
    stop = time.time_ns()
    rec.on = False
    counts = launch_counts()
    out = Recording(spans=rec.spans, launches={k: counts[k] - rec.counts[k] for k in LAUNCH_KEYS},
                    launch_ns={k: rec.launch_ns.get(k, 0) for k in LAUNCH_KEYS},
                    start_ns=rec.start_ns, stop_ns=stop)
    rec.spans, rec.launch_ns = [], {}
    return out
