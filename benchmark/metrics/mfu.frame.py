"""The whole step's share of the f32 peak: the counted operations of the
window's steps (the kernels' operations a segment times segments, the
denoiser's convolutions) over the window's time x 67 TFLOP/s."""

from benchmark.layers import mfu as read  # noqa: F401
