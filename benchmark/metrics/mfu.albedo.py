"""The whole step's share of the f32 peak: the counted operations of the
window's steps (two frames through K1 and K4, or two K2 dumps, at their
operations a segment) over the window's time x 67 TFLOP/s."""

from benchmark.layers import mfu as read  # noqa: F401
