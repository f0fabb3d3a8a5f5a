"""Timing + throughput on a CUDA device.

The reference brackets each kernel with cudaEvents and prints ms/fps
(``include/Renderer.h:63-75``); ``time_fn`` does the same with
``torch.cuda.Event`` pairs. The throughput metric of the repo is

    Mrays/s = W * H * spp * max_bounces / time

(path segments per second).
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch


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


def mrays_per_sec(width: int, height: int, spp: int, max_bounces: int, seconds: float) -> float:
    return width * height * spp * max_bounces / seconds / 1e6
