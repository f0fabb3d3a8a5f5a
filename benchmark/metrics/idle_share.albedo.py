"""The device's idle share of the traced window: 100 x (1 - the union of
its activity, kernels and copies, over the window's length)."""

from benchmark.layers import idle_share as read  # noqa: F401
