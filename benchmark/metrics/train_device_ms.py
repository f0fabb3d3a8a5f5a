"""End to end: the device's busy time a training step (the batch's upload
included), the union of its kernels and copies over the window, divided by
every step of the window."""

from benchmark.layers import device_ms as read  # noqa: F401
