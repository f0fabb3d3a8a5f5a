"""The traced window: ``torch.profiler`` over it, reduced to what the
per-layer readers and the result line take.

The measured window is profiled for the device's activity alone, which
costs the host little; recording every host operation as well would slow a
host-bound step down by half or more, and the readings would describe the
profiled program. The host's operations are profiled in a short window of
their own after it (``HOST_SECONDS``), for ``idle_gaps`` alone.

- ``busy_s``: the union of the device's activity (kernels, copies, fills)
  in the window; ``window_s``: the window's length on the host's clock.
- ``device_ops``: device time by name; ``kernels``: the count of kernel
  launches (copies and fills left out).
- ``idle_gaps``: the device's idle time in the short window (the span
  ``benchmark.window``), by what the host was doing at the middle of each
  gap (the outermost host operation there).
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW_SPAN = "benchmark.window"
HOST_SECONDS = 2.0
NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device_time: dict = field(default_factory=dict)  # name -> seconds
    device_count: dict = field(default_factory=dict)  # name -> launches
    idle_by_host: dict = field(default_factory=dict)  # host op -> idle seconds

    def kernel_launches(self) -> int:
        return sum(n for k, n in self.device_count.items() if not k.startswith(NOT_KERNELS))

    def time_of(self, predicate) -> float:
        return sum(t for k, t in self.device_time.items() if predicate(k))

    def breakdown(self) -> dict:
        def top(d):
            return [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

        return {"device_ops": top(self.device_time), "idle_gaps": top(self.idle_by_host)}


@contextlib.contextmanager
def traced(enabled: bool, host: bool = False):
    """Profile the block where ``enabled``: the device's activity, and with
    ``host`` the host's operations too; yields the profiler or None."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=activities) as prof:
        yield prof


def _ns(e, which):
    if hasattr(e, f"{which}_ns"):
        return getattr(e, f"{which}_ns")()
    return getattr(e, f"{which}_us")() * 1000


def summarize(prof, window_s: float | None = None) -> Trace:
    """The profiled block reduced; with ``window_s`` the block is the window
    (of that length on the host's clock) and all its device activity counts,
    without it the window is the span ``WINDOW_SPAN``."""
    events = prof.profiler.kineto_results.events()
    win = None
    device, host = [], []
    for e in events:
        name = e.name()
        start, end = _ns(e, "start"), _ns(e, "end")
        on_device = "CUDA" in str(e.device_type()).upper()
        if on_device:
            if e.is_user_annotation() or name == WINDOW_SPAN:
                continue
            device.append((name, start, end))
        elif name == WINDOW_SPAN:
            win = (start, end)
        else:
            host.append((name, start, end))
    if window_s is not None:
        win = (min((s for _, s, _ in device), default=0), max((e for _, _, e in device), default=0))
    if win is None:
        raise RuntimeError(f"the profiler recorded no {WINDOW_SPAN} span")
    w0, w1 = win
    time_by, count_by = defaultdict(float), defaultdict(int)
    spans = []
    for name, s, e in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        time_by[name] += (e - s) * 1e-9
        count_by[name] += 1
        spans.append((s, e))
    spans.sort()
    busy, gaps, cur_s, cur_e = 0, [], None, None
    last = w0
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            if s > last:
                gaps.append((last, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        last = max(last, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if w1 > last:
        gaps.append((last, w1))

    # the outermost host operations, as disjoint intervals
    host.sort(key=lambda t: (t[1], -t[2]))
    outer, reach = [], None
    for name, s, e in host:
        if reach is None or s >= reach:
            outer.append((s, e, name))
            reach = e
    starts = [o[0] for o in outer]
    idle = defaultdict(float)
    for s, e in gaps:
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid) - 1
        label = outer[i][2] if i >= 0 and outer[i][1] > mid else "host, between operations"
        idle[label] += (e - s) * 1e-9
    return Trace(window_s=(w1 - w0) * 1e-9 if window_s is None else window_s,
                 busy_s=busy * 1e-9, device_time=dict(time_by),
                 device_count=dict(count_by), idle_by_host=dict(idle))
