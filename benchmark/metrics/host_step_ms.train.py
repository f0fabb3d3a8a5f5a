"""The host's clock a training step: the traced window's length over its
steps (whole epochs; each step reads its loss back)."""

from benchmark.layers import host_ms as read  # noqa: F401
