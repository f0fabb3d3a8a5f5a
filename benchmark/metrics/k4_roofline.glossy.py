"""K4's share of its roofline in the glossy inverse step (csrc/ad_grad_kernel.cu,
the NEE glossy colour-only replay): the least time of its segments at 1,329.2
operations a segment and 67 TFLOP/s, over K4's device time in the window."""

from benchmark.counts import gradients
from benchmark.layers import roofline


def read(trace, work):
    return roofline(trace, "k4", work.get("k4_segments"),
                    gradients.OPS_PER_SEGMENT["ad_nee_glossy_color"])
