"""What the per-layer readers share (``benchmark/metrics/<name>.py``).

Each reader is ``read(trace, work) -> value or None``: ``trace`` is the
traced window (``tracing.Trace``), ``work`` what the cell's driver counted
in it (``units`` done, ``ops_per_unit``, segments of a kernel). A reader
that finds nothing to read returns None, and the harness leaves the metric
out of the line. Shares are in percent.
"""

from __future__ import annotations

from benchmark.counts import ops

# the port's hand-written kernels (pathtrace_tpu_torch/csrc/*.cu), by the
# name of their __global__ function
PORT_KERNELS = {"k1": "pathtrace_kernel", "k2": "grad_kernel", "k3": "nee_grad_kernel",
                "k4": "ad_grad_kernel", "k6": "chain_kernel"}
NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")


def is_port_kernel(name: str) -> bool:
    return any(k in name for k in PORT_KERNELS.values())


def kernel_seconds(trace, kernel: str) -> float:
    # "grad_kernel" is inside "nee_grad_kernel" and "ad_grad_kernel": match
    # the function's name where it starts
    name = PORT_KERNELS[kernel]
    return trace.time_of(lambda k: k.startswith(name) or f" {name}" in k or f"::{name}" in k)


def idle_share(trace, work):
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def device_ms(trace, work):
    """The device's busy time (the union of kernels and copies) over the
    window, in ms a unit of work."""
    if not work.get("units") or trace.busy_s <= 0:
        return None
    return 1e3 * trace.busy_s / work["units"]


def host_ms(trace, work):
    """The window's length on the host's clock, in ms a unit of work."""
    if not work.get("units") or trace.window_s <= 0:
        return None
    return 1e3 * trace.window_s / work["units"]


def mfu(trace, work):
    if not work.get("units") or trace.window_s <= 0:
        return None
    return 100.0 * work["units"] * work["ops_per_unit"] / (trace.window_s * ops.PEAK_F32)


def roofline(trace, kernel: str, segments: float, ops_per_segment: float):
    seconds = kernel_seconds(trace, kernel)
    if seconds <= 0 or not segments:
        return None
    return 100.0 * ops.bound_ms(segments, ops_per_segment) / (seconds * 1e3)
