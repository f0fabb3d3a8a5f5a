"""K1's share of its roofline (csrc/trace_kernel.cu): the least time of the
window's segments at 568 operations a segment and 67 TFLOP/s, over K1's
device time in the window."""

from benchmark.counts import ops
from benchmark.layers import roofline


def read(trace, work):
    return roofline(trace, "k1", work.get("k1_segments"), ops.OPS_PER_SEGMENT["forward_diffuse"])
