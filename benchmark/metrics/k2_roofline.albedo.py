"""K2's share of its roofline in the albedo step (csrc/grad_kernel.cu, dump
mode): the least time of its segments at 605.6 operations a segment and 67
TFLOP/s, over K2's device time in the window."""

from benchmark.counts import gradients
from benchmark.layers import roofline


def read(trace, work):
    return roofline(trace, "k2", work.get("k2_segments"), gradients.OPS_PER_SEGMENT["grad_dump"])
