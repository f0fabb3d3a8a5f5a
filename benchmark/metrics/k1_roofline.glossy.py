"""K1's share of its roofline in the glossy inverse step (csrc/trace_kernel.cu,
the NEE glossy colour instance): the least time of its segments at 962.0
operations a segment and 67 TFLOP/s, over K1's device time in the window."""

from benchmark.counts import gradients
from benchmark.layers import roofline


def read(trace, work):
    return roofline(trace, "k1", work.get("k1_segments"),
                    gradients.OPS_PER_SEGMENT["color_nee_glossy"])
