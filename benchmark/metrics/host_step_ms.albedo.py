"""The host's clock an albedo step: the traced window's length over its
steps, the device synchronised at its end."""

from benchmark.layers import host_ms as read  # noqa: F401
