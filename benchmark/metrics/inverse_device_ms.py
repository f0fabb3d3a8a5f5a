"""End to end: the device's busy time a geometry step, the union of its
kernels and copies over the window, divided by every step of the window."""

from benchmark.layers import device_ms as read  # noqa: F401
